"""repro_torch stands alone: importing every module of the port (the
serving, training, checkpoint and LM packages included), and chip_smoke.py, loads neither
JAX nor anything of the JAX package, and builds or loads no kernel."""
import os
import subprocess
import sys
import textwrap

import torch

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    importlib.util.module_from_spec(spec)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "repro" or m.startswith("repro."))
    from repro_torch.kernels import build
    built = sorted(build.BUILD_INFO) + sorted(build._LIBS)
    print(len(names), "modules;", "leaked:", bad, "built:", built)
    print("walked:", " ".join(names))
    sys.exit(1 if bad or built or len(names) < 15 else 0)
""")


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: [] built: []" in proc.stdout
    walked = proc.stdout.split("walked:")[1].split()
    for module in ("repro_torch.serve.query_server", "repro_torch.serve.scheduler",
                   "repro_torch.train.elastic", "repro_torch.checkpoint.manager",
                   "repro_torch.engine.elastic", "repro_torch.parallel.sharding",
                   "repro_torch.core.distributed", "repro_torch.serve.engine",
                   "repro_torch.kernels.grouped_matmul", "repro_torch.configs",
                   "repro_torch.configs.granite_moe_1b_a400m", "repro_torch.models.config",
                   "repro_torch.models.layers", "repro_torch.models.attention",
                   "repro_torch.models.moe", "repro_torch.models.rwkv",
                   "repro_torch.models.ssm", "repro_torch.models.transformer",
                   "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.clip",
                   "repro_torch.optim.compression", "repro_torch.optim.schedules",
                   "repro_torch.train.loop", "repro_torch.train.fault_tolerance",
                   "repro_torch.kernels.segment_rows", "repro_torch.data.pipeline",
                   "repro_torch.launch", "repro_torch.launch.mesh", "repro_torch.launch.train",
                   "repro_torch.launch.serve", "repro_torch.launch.specs",
                   "repro_torch.launch.roofline", "repro_torch.launch.dryrun"):
        assert module in walked, module
