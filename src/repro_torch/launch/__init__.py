# Entry-point drivers of the port (port of ``repro.launch``): ``serve``
# replays a mixed constrained workload through the serving runtime;
# ``train`` is the fault-tolerant training driver.
