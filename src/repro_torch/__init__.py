"""PyTorch/CUDA port of the ``repro`` GROUP BY engine.

The package mirrors ``src/repro/`` module for module (``core/``,
``engine/``, ``kernels/``, ``obs/``, ``data/``, ``serve/``, ``train/``,
``parallel/``, ``models/``, ``configs/``), exports the same names from
each package, and imports
neither JAX nor anything of ``repro``.  ``from repro_torch.engine import
GroupByPlan, AggSpec, Table`` is the front door.  Every plan of the
reference runs: the default plan (``strategy="auto"``), the concurrent
hash pipeline on its three kernel routes (the scan route, ``kernel``
None / "off" / "scan_body"; ``"split"``; ``"fused"``), sort and direct
ticketing, ``strategy="hybrid"``, ``strategy="partitioned"``,
``saturation="spill"`` and ``strategy="sharded"`` over a
single-controller mesh (``parallel.sharding``).  ``serve.AggregationServer`` multiplexes many
streaming queries over one scheduler and co-dispatches same-shape scan
queries through one multi-table ticket launch.  ``serve.engine.ServeLoop``
serves the LM stack (``models/``, ``configs/``): the MoE layers route
through the segment kernel and run their experts through the grouped
matmul kernel.  The hand-written Hopper kernels live in ``csrc/`` (see
``kernels/``).

Conventions that differ from the JAX package:

* Key columns inside the port are int32 bit patterns of the uint32 key
  space, with ``EMPTY_I32 = -1`` as the reserved sentinel.  The public
  ``"key"`` result column is int64 and holds the unsigned value.
* Entry points run on ``ExecutionPolicy.device`` (``None`` means
  ``"cuda"``); only an explicit ``device="cpu"`` runs on the CPU, where
  every kernel wrapper takes its plain PyTorch version.
"""
__version__ = "1.0.0"
