"""PyTorch/CUDA port of the ``repro`` GROUP BY engine.

The package mirrors ``src/repro/`` module for module (``core/``,
``engine/``, ``kernels/``, ``obs/``, ``data/``) and imports neither JAX nor
anything of ``repro``.  It runs ``GroupByPlan(strategy="concurrent")``
with hash ticketing and an explicit ``max_groups`` on three routes: the
fused kernel (``kernel="fused"``, ``csrc/fused_groupby.cu``), the split
ticket + segment kernels (``kernel="split"``), and the scan route
(``kernel`` None / "off" / "scan_body": ``scan_ticket_kernel`` of the
same source, then the update strategies or the segment kernel per plane).

Conventions that differ from the JAX package:

* Key columns inside the port are int32 bit patterns of the uint32 key
  space, with ``EMPTY_I32 = -1`` as the reserved sentinel.  The public
  ``"key"`` result column is int64 and holds the unsigned value.
* Entry points run on ``ExecutionPolicy.device`` (``None`` means
  ``"cuda"``); only an explicit ``device="cpu"`` runs on the CPU, where
  every kernel wrapper takes its plain PyTorch version.
"""
