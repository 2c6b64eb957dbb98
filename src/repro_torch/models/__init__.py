"""Model families of the port (port of ``repro.models``): the shared
modules and flash attention (``common``), the recsys models (``recsys``)
and the dense GQA transformer (``transformer``)."""
