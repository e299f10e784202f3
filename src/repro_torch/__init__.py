"""PyTorch/CUDA port of the ``repro`` GROUP BY engine.

The package mirrors ``src/repro/`` module for module (``core/``,
``engine/``, ``kernels/``, ``obs/``, ``data/``) and imports neither JAX nor
anything of ``repro``.  Its first slice is the production route
``GroupByPlan(strategy="concurrent", execution=ExecutionPolicy(
kernel="fused"))``: a stream of chunks through one carried hash table and
its accumulators, ticketed and aggregated by a hand-written Hopper kernel
(``csrc/fused_groupby.cu``).

Conventions that differ from the JAX package:

* Key columns inside the port are int32 bit patterns of the uint32 key
  space, with ``EMPTY_I32 = -1`` as the reserved sentinel.  The public
  ``"key"`` result column is int64 and holds the unsigned value.
* Entry points run on ``ExecutionPolicy.device`` (``None`` means
  ``"cuda"``); only an explicit ``device="cpu"`` runs on the CPU, where
  every kernel wrapper takes its plain PyTorch version.
"""
