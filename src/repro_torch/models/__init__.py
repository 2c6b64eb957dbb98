"""Model families of the port (port of ``repro.models``): the two-tower
recsys model's serving path so far."""
