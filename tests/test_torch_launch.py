"""The launch entry points of repro_torch (``launch/mesh.py``,
``launch/train.py``, ``launch/serve.py``) against the JAX package's, on
the CPU.

The CLIs run on ``parallel.sharding.devices()``: here the virtual CPU
members a test sets with ``virtual_devices(n, "cpu")``; with neither a card
nor members they raise ``RuntimeError``.  Flags are the reference's, flag
for flag; a training commit of the port restores in the reference's
``CheckpointManager``."""
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.parallel import sharding

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

TRAIN_ARGS = ["--arch", "qwen3_0_6b", "--reduced", "--batch", "4", "--seq", "16"]


@pytest.fixture(autouse=True)
def _clean_mesh_state():
    yield
    sharding.reset_virtual_devices()


def flags_of(main, argv_prefix, monkeypatch, capsys):
    """The long options a CLI's ``--help`` lists."""
    monkeypatch.setattr(sys, "argv", [argv_prefix, "--help"])
    with pytest.raises(SystemExit):
        main() if argv_prefix == "ref" else main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


@pytest.mark.parametrize("name", ["train", "serve"])
def test_cli_flags_are_the_references(name, monkeypatch, capsys):
    ref, port = (jtrain, ttrain) if name == "train" else (jserve, tserve)
    want = flags_of(ref.main, "ref", monkeypatch, capsys)
    assert flags_of(port.main, "port", monkeypatch, capsys) == want
    assert "--arch" in want


def test_meshes_over_the_members():
    with sharding.virtual_devices(4, "cpu"):
        m = lmesh.make_host_mesh(2, 2)
        assert m.axis_names == ("data", "model") and m.shape == {"data": 2, "model": 2}
        assert [d.id for d in m.devices.reshape(-1)] == [0, 1, 2, 3]
        assert lmesh.make_host_mesh().shape == {"data": 1, "model": 1}
        with pytest.raises(ValueError, match="needs 256 devices, 4 given"):
            lmesh.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 devices"):
            lmesh.make_production_mesh(multi_pod=True)
    with sharding.virtual_devices(512, "cpu"):
        m = lmesh.make_production_mesh()
        assert m.axis_names == ("data", "model") and m.shape == {"data": 16, "model": 16}
        m = lmesh.make_production_mesh(multi_pod=True)
        assert m.axis_names == ("pod", "data", "model")
        assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512


def test_without_a_card_or_members_the_launchers_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sharding.reset_virtual_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "qwen3_0_6b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        lmesh.make_host_mesh()
    assert not list(tmp_path.iterdir())


def test_train_cli_on_two_members_commits_what_the_reference_restores(tmp_path, capsys):
    """10 steps on a (data 2, model 1) mesh of CPU members, a commit every
    5: the logged loss is finite, the reference's manager restores the
    last commit into its own tree and it equals the port's parameters; a
    second ``--elastic`` run resumes from it and trains on to 12."""
    d = str(tmp_path / "ckpt")
    with sharding.virtual_devices(2, "cpu"):
        params, _, hist = ttrain.main(TRAIN_ARGS + ["--steps", "10", "--ckpt-dir", d,
                                                    "--ckpt-every", "5"])
    assert [h["step"] for h in hist] == [10] and np.isfinite(hist[0]["loss"])
    assert "step     10 loss=" in capsys.readouterr().out
    jcfg = jconfigs.get_config("qwen3_0_6b", reduced=True)
    template = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    restored, step = JCheckpointManager(d, async_save=False).restore_latest(template)
    assert step == 10
    got = ttf.params_to_numpy(sharding.unplace(params, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, restored), got)

    with sharding.virtual_devices(2, "cpu"):
        _, opt, hist = ttrain.main(TRAIN_ARGS + ["--steps", "12", "--ckpt-dir", d,
                                                 "--ckpt-every", "6", "--elastic"])
    assert hist == [] and int(opt.step.full("cpu")) == 12
    assert JCheckpointManager(d, async_save=False).latest_step() == 12


def test_serve_cli_serves_every_request_and_prints_the_references_line(capsys):
    with sharding.virtual_devices(2, "cpu"):
        served = tserve.main(["--arch", "qwen3_0_6b", "--reduced", "--slots", "2",
                              "--requests", "5", "--max-new", "4"])
    assert [r.uid for r in served] == list(range(5))
    assert all(r.done and len(r.generated) == 4 for r in served)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"served 5 requests, 20 tokens in \d+\.\ds \(\d+\.\d tok/s\)", out), out
