"""Roofline terms of a dry-run cell on an H100 (port of
``repro.launch.roofline``).

Three terms per (arch × shape × mesh), all in seconds, for ONE member of
the mesh (``launch/dryrun.py`` says what a member's figures hold):

  compute    = FLOPs / peak bf16 FLOP/s
  memory     = bytes accessed / HBM bytes/s
  collective = Σ collective result bytes / NVLink bytes/s

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collective bytes out of the optimized HLO.  The port has no HLO:
the dry run counts FLOPs and bytes op by op (``dryrun.CostMode``), and
:func:`collective_bytes` sums a record of the port's own collectives
(``parallel/sharding.py`` ``all_gather``, ``gather``, ``psum``, ``pmin``,
``pmax``, ``all_to_all`` and ``PlacedTensor.gathered``), which those
functions append to through :func:`record_collective` while a dry run is
active.  With none active a record call is one test of an empty list.

Kernels written by hand (``kernels/*.py``) are invisible to an op-by-op
count: their wrappers are wrapped by :func:`counted`, which, while a dry
run is active, runs the wrapper with the count paused and adds the
kernel's FLOPs and bytes by the formula of its bound (PERF.md §6).

The constants are an H100 SXM 80 GB's, from NVIDIA's H100 Tensor Core GPU
datasheet (dense rates, no sparsity, at its 700 W limit): 989.4 TFLOP/s
bf16, 3.35 TB/s HBM3, 450 GB/s a direction per GPU over NVLink 4 through
NVSwitch, 80 GB of HBM.  A card set below 700 W runs slower than these.
"""
from __future__ import annotations

import functools
from dataclasses import asdict, dataclass

# H100 SXM 80 GB, NVIDIA's datasheet (per card)
H100_PEAK_FLOPS_BF16 = 989.4e12   # FLOP/s, dense
H100_HBM_BW = 3.35e12             # B/s, HBM3
H100_NVLINK_BW = 450e9            # B/s a direction, NVLink 4 via NVSwitch
H100_HBM_BYTES = 80e9             # B

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# The dry run's counter while it traces (innermost last), else empty.  A
# counter has .collective(kind, nbytes) and .kernel(fn, work, args, kwargs).
ACTIVE: list = []


def record_collective(kind: str, results) -> None:
    """Note one collective of ``kind`` whose results (a tensor or a list
    of tensors, one a member) the caller computed: their bytes, as the
    reference takes a collective's result shape."""
    if not ACTIVE:
        return
    ts = results if isinstance(results, (list, tuple)) else (results,)
    ACTIVE[-1].collective(kind, sum(t.numel() * t.element_size() for t in ts))


def counted(work):
    """Decorate a kernel's wrapper: while a dry run is active, the wrapper
    runs with the op count paused and ``work(*args, **kwargs)`` → ``(flops,
    bytes)`` is counted instead, on every device alike (a meta tensor
    takes the wrapper's meta branch, a CPU tensor the plain version, a
    CUDA tensor the kernel).  With none active the wrapper runs as is."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            return ACTIVE[-1].kernel(fn, work, args, kwargs)
        return wrapper
    return wrap


def collective_bytes(record) -> dict:
    """Result bytes of a record's collectives by kind (the reference's
    five), plus ``counts``: how many of each.  ``record`` is a sequence of
    ``(kind, bytes)``."""
    out: dict = {k: 0 for k in _COLLECTIVES}
    counts: dict = {k: 0 for k in _COLLECTIVES}
    for kind, nbytes in record:
        if kind not in out:
            raise ValueError(f"unknown collective {kind!r}; one of {_COLLECTIVES}")
        out[kind] += int(nbytes)
        counts[kind] += 1
    out["counts"] = counts
    return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_frac: float

    def to_dict(self):
        return asdict(self)


def derive_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: dict,
    coll: dict,
    model_flops: float,
) -> RooflineTerms:
    """The three terms of one member's ``cost`` (``flops``, ``bytes
    accessed``) and collectives, term for term the reference's (the field
    names keep its ``hlo_`` prefix)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(sum(v for k, v in coll.items() if k in _COLLECTIVES))
    compute_s = flops / H100_PEAK_FLOPS_BF16
    memory_s = byts / H100_HBM_BW
    collective_s = cbytes / H100_NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / chips / flops if flops else 0.0
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=byts,
        coll_bytes=cbytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_frac=useful,
    )


def model_flops_estimate(cfg, cell) -> float:
    """MODEL_FLOPS = 6·N·D (dense train) / 2·N·D (inference), N = active
    params, D = tokens processed."""
    n_active = count_active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.mode != "decode" else 1)
    mult = 6.0 if cell.mode == "train" else 2.0
    return mult * n_active * tokens


def count_active_params(cfg) -> float:
    """Active-parameter count from the config (MoE counts top_k of E)."""
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        ad, kvd = cfg.attn_dim, cfg.kv_dim
        attn = d * ad * 2 + d * kvd * 2
        if cfg.moe_num_experts:
            frac = cfg.moe_top_k / cfg.moe_num_experts
            moe = 3 * d * cfg.moe_d_ff * cfg.moe_num_experts * frac
            moe += 3 * d * cfg.moe_shared_d_ff + d * cfg.moe_num_experts
            per_layer = attn + moe
        else:
            nmat = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
            per_layer = attn + nmat * d * cfg.d_ff
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        n = cfg.ssm_state
        h = d_inner // cfg.ssm_head_dim
        mamba = d * (2 * d_inner + 2 * n + h) + d_inner * d
        per_layer = mamba  # attn blocks handled below
    elif cfg.family == "ssm":
        per_layer = 4 * d * d + d * d + 2 * d * cfg.d_ff + d * d
    total = emb + per_layer * L
    if cfg.family == "hybrid" and cfg.attn_every:
        ad, kvd = cfg.attn_dim, cfg.kv_dim
        attn = d * ad * 2 + d * kvd * 2 + 3 * d * cfg.d_ff
        total += attn  # shared weights count once
    if cfg.encoder_layers:
        total += per_layer * cfg.encoder_layers
    return float(total)


__all__ = [
    "ACTIVE",
    "H100_HBM_BW",
    "H100_HBM_BYTES",
    "H100_NVLINK_BW",
    "H100_PEAK_FLOPS_BF16",
    "RooflineTerms",
    "collective_bytes",
    "count_active_params",
    "counted",
    "derive_terms",
    "model_flops_estimate",
    "record_collective",
]
