"""The port's dry run (``launch/specs.py``, ``launch/roofline.py``,
``launch/dryrun.py``) against the JAX package's, on the CPU.

The reference is held on ``jax.sharding.AbstractMesh`` production meshes
in this process: its ``batch_sds``, ``cache_sds`` and ``_ep_info`` read
only axis names and sizes.  Importing ``repro.launch.dryrun`` prepends
``--xla_force_host_platform_device_count=512`` to ``XLA_FLAGS``, so the
JAX backend is started first (``jax.devices()``: one device, as the suite
needs) and ``XLA_FLAGS`` restored at once, so no later subprocess inherits
it.  The port's cells run on meta members of its own production meshes.

Exact: ``count_active_params``, ``model_flops_estimate``, ``_ep_info``,
the specs' trees, shapes, dtypes and specs, ``derive_terms`` (with the
reference's constants put in the port's module for that test only).  A
meta trace and the same step on CPU tensors count the same FLOPs, bytes
and peak.  Against XLA's ``cost_analysis`` on a reduced cell the port's
FLOPs lie within ``XLA_FLOPS_RTOL``: eager ops, unfused, against the
compiled program (measured on this reduced cell: see the test)."""
import dataclasses
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

jax.devices()  # the backend starts with one device, before the import below
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402  (sets XLA_FLAGS to 512 devices)

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.config import ShapeCell as JShapeCell  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import grouped_matmul as gm  # noqa: E402
from repro_torch.kernels import segment_agg as sa  # noqa: E402
from repro_torch.kernels import segment_rows as sr  # noqa: E402
from repro_torch.kernels import ticket_hash as th  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import SHAPES as TSHAPES  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.config import ShapeCell as TShapeCell  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

META = torch.device("meta")
VARIANTS = (None, "moe_ts", "moe_ts2", "moe_ts3")
MOE_ARCHS = [a for a in jconfigs.ARCH_IDS if jconfigs.get_config(a).moe_num_experts]
# |the port's FLOPs over XLA's - 1| on the reduced cells of test_flops_near_xla;
# measured 0.816 (train), 0.987 (prefill), 1.083 (decode): XLA's cost analysis
# and an op-by-op count part over gathers, scatters and the backward's sums
XLA_FLOPS_RTOL = 0.25


def jax_mesh(multi_pod: bool):
    if multi_pod:
        return jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return jax.sharding.AbstractMesh((16, 16), ("data", "model"))


def port_mesh(multi_pod: bool):
    with sharding.virtual_devices(512 if multi_pod else 256, "meta"):
        return make_production_mesh(multi_pod=multi_pod)


def norm_spec(spec):
    """A spec as a tuple of entries, a one-axis tuple entry unwrapped (the
    two forms name the same split)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tuple(spec))


def jflat(tree, specs=None) -> dict:
    """path → (shape, dtype name[, spec]) of a JAX tree of shape structs."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = (jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        if specs is not None else [None] * len(leaves))
    for (path, leaf), spec in zip(leaves, spec_leaves):
        name = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                        for k in path)
        out[name] = (tuple(leaf.shape), str(np.dtype(leaf.dtype)),
                     None if spec is None else norm_spec(spec))
    return out


def tflat(tree, specs=None) -> dict:
    out = {}
    if specs is None:
        sharding._map_with_path(lambda p, t: out.__setitem__(
            p, (tuple(t.shape), str(t.dtype).replace("torch.", ""), None)), tree)
    else:
        sharding._map_with_path(lambda p, t, s: out.__setitem__(
            p, (tuple(t.shape), str(t.dtype).replace("torch.", ""), norm_spec(s))), tree, specs)
    return out


# -- roofline ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_active_params_and_model_flops_equal_the_references(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert troof.count_active_params(tcfg) == jroof.count_active_params(jcfg)
    shapes = [c.name for c in jconfigs.applicable_shapes(jcfg)]
    assert shapes == [c.name for c in tconfigs.applicable_shapes(tcfg)]
    for name in shapes:
        assert (troof.model_flops_estimate(tcfg, TSHAPES[name])
                == jroof.model_flops_estimate(jcfg, JSHAPES[name]))


def test_derive_terms_is_the_references_formula(monkeypatch):
    from repro.launch import mesh as jmesh

    monkeypatch.setattr(troof, "H100_PEAK_FLOPS_BF16", jmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(troof, "H100_HBM_BW", jmesh.HBM_BW)
    monkeypatch.setattr(troof, "H100_NVLINK_BW", jmesh.ICI_BW_PER_LINK)
    coll = {"all-gather": 3e9, "all-reduce": 1e9, "all-to-all": 5e8,
            "counts": {"all-gather": 2, "all-reduce": 1, "all-to-all": 1}}
    for flops, byts in ((4.2e14, 1.3e13), (1e9, 5e12), (1e6, 1e6)):
        kw = dict(arch="a", shape="s", mesh_name="16x16", chips=256,
                  cost={"flops": flops, "bytes accessed": byts}, coll=coll, model_flops=3e15)
        assert troof.derive_terms(**kw).to_dict() == jroof.derive_terms(**kw).to_dict()


def test_h100_constants_are_the_datasheets():
    assert troof.H100_PEAK_FLOPS_BF16 == 989.4e12 and troof.H100_HBM_BW == 3.35e12
    assert troof.H100_NVLINK_BW == 450e9 and troof.H100_HBM_BYTES == 80e9


def test_collective_bytes_of_a_hand_built_record():
    rec = [("all-gather", 100), ("all-reduce", 40), ("all-gather", 8), ("all-to-all", 16)]
    got = troof.collective_bytes(rec)
    assert got == {"all-gather": 108, "all-reduce": 40, "reduce-scatter": 0, "all-to-all": 16,
                   "collective-permute": 0,
                   "counts": {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 0,
                              "all-to-all": 1, "collective-permute": 0}}
    assert set(got) - {"counts"} == set(jroof._COLLECTIVES)
    with pytest.raises(ValueError, match="unknown collective"):
        troof.collective_bytes([("broadcast", 4)])


def test_collectives_record_nothing_without_a_dry_run():
    assert troof.ACTIVE == []
    members = [sharding.MeshDevice(i, torch.device("cpu")) for i in range(2)]
    xs = [torch.ones(3), torch.ones(3)]
    sharding.psum(xs, members[0])
    sharding.all_gather(xs, members)
    assert troof.ACTIVE == []


def test_collective_record_of_a_placed_cpu_step():
    """jit_train_step on (data 2, model 2) CPU members: each data member's
    gather of a split parameter is one all-gather of its whole bytes; the
    replicated leaves gather nothing."""
    cfg = TModelConfig(**dataclasses.asdict(jconfigs.get_config("qwen3_0_6b", reduced=True)))
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with sharding.virtual_devices(4, "cpu") as members:
        mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=members)
    hp = tloop.TrainHParams(ticketed_embedding=False)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 9)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    placed = sharding.place(params, sharding.param_shardings(mesh, params))
    opt = tloop._placed_adamw_init(placed, mesh)
    step = tloop.jit_train_step(mesh, cfg, hp, placed, opt)(batch)
    with tdry.CostMode() as mode:
        step(placed, opt, batch)
    split = [p for p in ttf._leaves(placed) if any(p.sharding.parts(i) > 1 for i in range(p.ndim))]
    # members on one device share one gathered tree (jit_train_step's _trees_on)
    got = troof.collective_bytes(mode.record)
    assert got["counts"]["all-gather"] == len(split)
    assert got["all-gather"] == sum(p.shape.numel() * 4 for p in split)
    assert got["all-reduce"] == got["all-to-all"] == 0


# -- dryrun: _ep_info and the specs --------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_ep_info_equals_the_references(multi_pod):
    jm, tm = jax_mesh(multi_pod), port_mesh(multi_pod)
    for arch in jconfigs.ARCH_IDS:
        jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for cell in jconfigs.applicable_shapes(jcfg):
            for variant in VARIANTS:
                want, wimpl = jdry._ep_info(jm, jcfg, cell, variant)
                got, gimpl = tdry._ep_info(tm, tcfg, TSHAPES[cell.name], variant)
                assert gimpl == wimpl
                if want is None:
                    assert got is None
                    continue
                assert got["mesh"] is tm
                assert {k: v for k, v in got.items() if k != "mesh"} == \
                    {k: v for k, v in want.items() if k != "mesh"}
    assert MOE_ARCHS  # the loop above met expert-parallel cells


SPEC_ARCHS = ["qwen3_0_6b", "granite_moe_1b_a400m", "seamless_m4t_large_v2",
              "zamba2_1_2b", "rwkv6_1_6b", "internvl2_2b"]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_abstract_params_and_opt_equal_the_references(arch):
    """Full width: the trees, shapes and dtypes, and the parameter specs."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    from repro.parallel.sharding import param_specs as jparam_specs

    jp = jspecs.abstract_params(jcfg)
    tp = tspecs.abstract_params(tcfg)
    assert all(t.device.type == "meta" for t in ttf._leaves(tp))
    assert tflat(tp, sharding.param_specs(tp)) == jflat(jp, jparam_specs(jp))
    assert tflat(tspecs.abstract_opt(tp)) == jflat(jspecs.abstract_opt(jp))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_batch_cache_and_token_specs_equal_the_references(arch, multi_pod):
    """Every applicable shape at full width, ``long_500k``'s seq-shard
    branch included (zamba2, rwkv6)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm, tm = jax_mesh(multi_pod), port_mesh(multi_pod)
    for cell in jconfigs.applicable_shapes(jcfg):
        tcell = TSHAPES[cell.name]
        if cell.mode != "decode":
            ja, js = jspecs.batch_sds(jcfg, cell, jm)
            ta, ts = tspecs.batch_sds(tcfg, tcell, tm)
            assert tflat(ta, ts) == jflat(ja, js)
            continue
        jc, jcs, jseq = jspecs.cache_sds(jcfg, cell, jm)
        tc, tcs, tseq = tspecs.cache_sds(tcfg, tcell, tm)
        assert tseq == jseq
        assert tflat(tc, tcs) == jflat(jc, jcs)
        jt, jts = jspecs.decode_tokens_sds(cell, jm, jseq)
        tt, tts = tspecs.decode_tokens_sds(tcell, tm, tseq)
        assert (tuple(tt.shape), tt.dtype, norm_spec(tts)) == \
            (tuple(jt.shape), torch.int32, norm_spec(jts))
        assert str(jt.dtype) == "int32"
        if cell.name == "long_500k":
            assert tseq  # the batch of 1 does not split over 16 data members


# -- dryrun: the count ---------------------------------------------------------------


def reduced(arch, **kw):
    return TModelConfig(**{**dataclasses.asdict(jconfigs.get_config(arch, reduced=True)),
                           "dtype": "float32", **kw})


def one_member_step(cfg, device, rows=2, seq=16, ticketed=True):
    """make_train_step's arguments on ``device`` (zeros on the CPU: the
    count reads shapes, not values)."""
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg, device=device)
    opt = tadamw.init(params)
    batch = {"tokens": torch.zeros((rows, seq), dtype=torch.int32, device=device),
             "targets": torch.zeros((rows, seq), dtype=torch.int32, device=device)}
    step = tloop.make_train_step(cfg, tloop.TrainHParams(ticketed_embedding=ticketed))
    return step, (params, opt, batch)


def count(step, args):
    cell = tdry.CellStep(step, args, tdry._tensors(args), [], 1, 0, 0)
    return tdry.trace(cell)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "granite_moe_1b_a400m"])
def test_meta_trace_counts_what_the_cpu_step_counts(arch):
    """The same one-member step on meta and on CPU tensors: equal FLOPs,
    bytes accessed, transcendentals and peak (granite: B3, B6 and the
    segment kernel's counts; the ticketed embedding: the ticket kernel's
    and B5's)."""
    cfg = reduced(arch)
    meta = count(*one_member_step(cfg, META))
    cpu = count(*one_member_step(cfg, torch.device("cpu")))
    assert meta["cost"] == cpu["cost"]
    assert meta["memory"] == cpu["memory"]
    assert meta["cost"]["flops"] > 0 and meta["memory"]["peak_bytes"] > 0


def test_kernels_are_counted_by_their_bound_formulas():
    lhs, rhs = torch.empty((40, 8), device=META), torch.empty((4, 8, 6), device=META)
    sizes = torch.empty((4,), dtype=torch.int32, device=META)
    with tdry.CostMode() as mode:
        out = gm.grouped_matmul(lhs, rhs, sizes)
    assert mode.flops == 2 * 40 * 8 * 6
    assert mode.bytes == 4 * (40 * 8 + 4 * 8 * 6 + 4 + 40 * 6)
    assert mode.live == 40 * 6 * 4 and out.shape == (40, 6)


def test_meta_branches_give_the_plain_versions_shapes_and_dtypes():
    rng = np.random.default_rng(0)
    cpu = {
        "lhs": torch.from_numpy(rng.standard_normal((24, 8)).astype(np.float32)),
        "rhs": torch.from_numpy(rng.standard_normal((4, 8, 6)).astype(np.float32)),
        "sizes": torch.tensor([5, 0, 11, 8], dtype=torch.int32),
        "g": torch.from_numpy(rng.standard_normal((24, 6)).astype(np.float32)),
        "keys": torch.from_numpy(rng.integers(0, 50, 2048).astype(np.int32)),
        "tickets": torch.from_numpy(rng.integers(-1, 30, 256).astype(np.int32)),
        "vals": torch.from_numpy(rng.standard_normal(256).astype(np.float32)),
        "rows": torch.from_numpy(rng.standard_normal((256, 5)).astype(np.float32)),
    }
    meta = {k: v.to(META) for k, v in cpu.items()}

    def calls(x):
        return [
            gm.grouped_matmul(x["lhs"], x["rhs"], x["sizes"]),
            gm.grouped_matmul_backward(x["lhs"], x["rhs"], x["sizes"], x["g"]),
            gm.grouped_matmul_backward(x["lhs"], x["rhs"], x["sizes"], x["g"],
                                       need=(False, True)),
            sa.segment_agg(x["tickets"], x["vals"], num_groups=32, kind="count",
                           strategy="onehot", morsel_size=1),
            th.ticket_hash(x["keys"], capacity=128, max_groups=64),
            sr.segment_rows(x["rows"], x["tickets"], 30),
        ]

    def shapes(outs):
        return [tuple(None if t is None else (tuple(t.shape), t.dtype)
                      for t in (o if isinstance(o, tuple) else (o,))) for o in outs]

    got = calls(meta)
    assert shapes(got) == shapes(calls(cpu))
    assert all(t.device.type == "meta" for o in got for t in (o if isinstance(o, tuple) else (o,))
               if t is not None)
    for mod, fn in ((gm, "grouped_matmul"), (gm, "grouped_matmul_backward"),
                    (sa, "segment_agg"), (th, "ticket_hash"), (sr, "segment_rows")):
        assert getattr(mod, fn).launches == 0  # nothing launched for meta or CPU tensors


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_flops_near_xla(mode):
    """Reduced qwen3-0.6b (float32), 2 rows × 32 tokens, on one member:
    the port's counted FLOPs over XLA's ``cost_analysis`` flops of the
    reference's lowered cell on a one-device mesh, its layers unrolled
    (``_unrolled_sibling``: XLA counts a scanned body once)."""
    jcfg = dataclasses.replace(jconfigs.get_config("qwen3_0_6b", reduced=True), dtype="float32")
    jcfg = jdry._unrolled_sibling(jcfg, jcfg.n_layers)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    jcell = JShapeCell(f"r_{mode}", 32, 2, mode)
    tcell = TShapeCell(f"r_{mode}", 32, 2, mode)
    jm = jax.make_mesh((1, 1), ("data", "model"))
    want = float(jdry._measure(jm, jcfg, jcell)[1]["flops"])
    tm = sharding.make_mesh((1, 1), ("data", "model"), devices=[sharding.MeshDevice(0, META)])
    got = tdry.trace(tdry.lower_cell(tm, tcfg, tcell))["cost"]["flops"]
    assert abs(got / want - 1) <= XLA_FLOPS_RTOL, (got, want, got / want)


def test_run_cell_qwen3_train_4k_on_the_production_mesh():
    r = tdry.run_cell("qwen3_0_6b", "train_4k", with_cost=False, verbose=False)
    rf = r["roofline"]
    assert rf["hlo_flops"] > 1e11 and rf["coll_bytes"] > 1e8
    assert r["memory"]["peak_bytes"] > 0 and r["memory"]["peak_exact"] is True
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rf["chips"] == 256 and r["mesh"] == "16x16"
    assert r["collectives"]["counts"]["all-gather"] > 0


REFERENCE_KEYS = {"arch", "shape", "mesh", "mode", "variant", "lower_s", "compile_s", "memory",
                  "cost", "cost_raw_scanned", "collectives", "collectives_raw_scanned",
                  "roofline"}


def test_cli_writes_the_cells_json_and_skips_it_cached(tmp_path, capsys):
    argv = ["--arch", "qwen3_0_6b", "--shape", "decode_32k", "--out", str(tmp_path)]
    tdry.main(argv)
    path = tmp_path / "qwen3_0_6b_decode_32k_16x16.json"
    res = json.loads(path.read_text())
    assert set(res) == REFERENCE_KEYS
    assert set(res["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
                                  "peak_exact"}
    assert set(res["cost"]) == {"flops", "bytes accessed", "transcendentals"}
    assert set(res["roofline"]) == set(jroof.RooflineTerms.__dataclass_fields__)
    tdry.main(argv)
    assert "cached, skipping" in capsys.readouterr().out


def test_cli_flags_are_the_references(monkeypatch, capsys):
    def flags(main, argv):
        monkeypatch.setattr(sys, "argv", ["dryrun", "--help"])
        with pytest.raises(SystemExit):
            main(*argv)
        return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))

    want = flags(jdry.main, ())
    assert flags(tdry.main, (["--help"],)) == want and "--both-meshes" in want
