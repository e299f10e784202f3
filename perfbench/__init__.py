"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, metric or cell lives in a file
of its own, found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``columns/<kind>.py``, ``metrics/<metric>.py`` and
``limits/<cell>.json``.  Nothing here imports JAX or the JAX package.
"""
