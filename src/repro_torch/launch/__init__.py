"""Launch entry points (port of ``repro.launch``): meshes over the port's
members (``mesh``), the training CLI (``train``) and the serving CLI
(``serve``).  Each runs on ``parallel.sharding.devices()``: the visible
CUDA cards, or the members a caller set with ``virtual_devices``."""
