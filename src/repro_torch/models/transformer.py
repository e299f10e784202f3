"""Model assembly: decoder-only LMs, MoE LMs, enc-dec, hybrid SSM, RWKV.

Port of ``repro.models.transformer``.  Layer parameters stay stacked on a
leading L axis, as in the reference; its ``jax.lax.scan`` over the stack
is a Python loop here over views of the stack (``_unstack``).  Each block
of every stack is rematerialised as the reference's ``jax.checkpoint`` on
the block body (:func:`_remat`): under autograd a block keeps only its
inputs (``cfg.remat_policy="dots"``: also its 2-D products) and runs again
in the backward, the standard remat-per-layer memory profile; without a
gradient a block is a plain call.  The embedding, the vision projection,
the final norm and the logits stay outside, as in the reference.

Heterogeneous stacks (zamba2) run *super-blocks* of (attn_every−1 Mamba2
layers + one shared-weight attention block); the shared attention
parameters live outside the stacked tree, as in the reference.

Caches: attention caches are ``KVCache``\\ s of stacked buffers (L, B,
S_max, KVH, hd) with an (L,) int32 length on the device; a cached step
writes the new K/V into the stacked buffers IN PLACE (see
``attention.append_kv``) and returns caches over the same buffers with the
new lengths.  RWKV and Mamba2 states are small and are returned as new
stacked tensors.

``params_from_numpy`` / ``params_to_numpy`` carry the reference's
parameter tree (JAX arrays → numpy) into the port's nested dict of tensors
and back, key for key and shape for shape.

All forward paths return ``(logits, aux)`` where aux carries MoE aux losses
(``ForwardOut``); cached steps return ``(logits, new_caches)``.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache, attn_init, make_cache, multihead_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    Params,
    apply_norm,
    dense,
    dense_init,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    norm_init,
    softcap,
    ticketed_embed,
)
from repro_torch.parallel import sharding


def torch_dtype(name) -> torch.dtype:
    """``cfg.dtype`` ("bfloat16", "float32", …) or a torch dtype as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# trees of tensors (nested dicts, NamedTuples)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def _at(tree, i):
    return tree_map(lambda a: a[i], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _lead(tree, *lead):
    """A copy of ``tree`` with leading dims ``lead`` (the reference's
    ``broadcast_to``; real copies here, since caches are written in place)."""
    return tree_map(lambda a: a.expand(*lead, *a.shape).clone(), tree)


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _attn_block_init(gen, cfg: ModelConfig, cross: bool = False, device=None) -> Params:
    p = {
        "ln_attn": norm_init(cfg.norm_kind, cfg.d_model, device),
        "attn": attn_init(gen, cfg, device=device),
        "ln_mlp": norm_init(cfg.norm_kind, cfg.d_model, device),
    }
    if cfg.post_block_norm:
        p["ln_attn_post"] = norm_init(cfg.norm_kind, cfg.d_model, device)
        p["ln_mlp_post"] = norm_init(cfg.norm_kind, cfg.d_model, device)
    if cross:
        p["ln_cross"] = norm_init(cfg.norm_kind, cfg.d_model, device)
        p["cross"] = attn_init(gen, cfg, cross=True, device=device)
    if cfg.moe_num_experts:
        p["moe"] = moe_lib.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, device=device)
    return p


def _attn_block(
    p: Params,
    cfg: ModelConfig,
    x,
    *,
    window=None,
    cache: KVCache | None = None,
    memory=None,
    positions=None,
    moe_impl: str = "dense",
    ep_info: dict | None = None,
):
    if moe_impl not in ("dense", "ep"):
        raise ValueError(f"moe_impl={moe_impl!r}; available: 'dense', 'ep'")
    h = apply_norm(cfg.norm_kind, p["ln_attn"], x)
    a, new_cache = multihead_attention(
        p["attn"], cfg, h, window=window, cache=cache, positions=positions
    )
    if cfg.post_block_norm:
        a = apply_norm(cfg.norm_kind, p["ln_attn_post"], a)
    x = x + a * cfg.residual_multiplier

    if memory is not None:
        hc = apply_norm(cfg.norm_kind, p["ln_cross"], x)
        cattn, _ = multihead_attention(p["cross"], cfg, hc, memory=memory, causal=False)
        x = x + cattn * cfg.residual_multiplier

    h = apply_norm(cfg.norm_kind, p["ln_mlp"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "moe" in p:
        if moe_impl == "ep":
            m, aux = _moe_ep_shardmapped(p["moe"], cfg, h, ep_info)
        else:
            m, aux = moe_lib.moe_mlp_dense(p["moe"], cfg, h)
    else:
        m = mlp(p["mlp"], h, cfg.mlp_kind)
    if cfg.post_block_norm:
        m = apply_norm(cfg.norm_kind, p["ln_mlp_post"], m)
    x = x + m * cfg.residual_multiplier
    return x, new_cache, aux


def _local_moe(p_moe: Params, r: int, e_local: int, device) -> Params:
    """Member r's MoE parameters on ``device``: the expert stacks' rows
    ``[r·E_local, (r+1)·E_local)`` (a view where the stack is on ``device``),
    the router and shared expert whole."""
    rows = slice(r * e_local, (r + 1) * e_local)
    return {k: (v[rows].to(device) if k in ("w_gate", "w_up", "w_down")
                else tree_map(lambda t: t.to(device), v)) for k, v in p_moe.items()}


def _moe_ep_shardmapped(p_moe: Params, cfg: ModelConfig, h, ep_info: dict):
    """Expert parallelism over ``ep_info["mesh"]`` (the reference's
    ``shard_map`` of ``moe_mlp_ep``, ``transformer.py:110-179``): experts
    split over ``model``, tokens over the data axes ``ep_info["dp"]``,
    dispatch and return by ``all_to_all`` (``moe.moe_mlp_ep``).  ``ep_info``
    = {mesh, dp (axis tuple), capacity_per_expert, token_slice,
    quantize_dispatch}, as the reference's.

    ``h`` (B, S, D) is split along B over the data-parallel coordinates in
    member order; each coordinate's rows go to every member of its
    ``model`` group.  Member r of a group computes with the expert stacks'
    rows ``[r·E_local, (r+1)·E_local)``: a view of the stack where the
    member shares its device, no copy.  ``E_pad % model`` ≠ 0 raises
    ``ValueError``, as does a B that does not split over the data members.

    Without ``token_slice`` every member of a group dispatches all of its
    coordinate's tokens (the reference's replicated dispatch) and the
    group's output is its first member's.  With it, member r dispatches
    rows ``[r·ts, (r+1)·ts)`` of the flattened tokens (ts = ceil(T / n),
    zero rows padding the last slice; they are routed and count in the aux
    loss, as in the reference) and the slices are gathered back and cut to
    T.

    The aux loss is the reference's: without ``token_slice`` the mean over
    the data-parallel coordinates of each one's loss (``pmean(aux, dp)``),
    with it the mean over every member (``pmean(aux, dp + ("model",))``).
    That is a mean of means, not the whole batch's load-balance loss that
    ``jit_train_step`` forms with ``moe.split_aux``: this path keeps the
    reference's rule.  Returns ``(out on h's device, aux)``."""
    mesh = ep_info["mesh"]
    dp = tuple(ep_info["dp"])
    cap = ep_info["capacity_per_expert"]
    token_slice = ep_info.get("token_slice", False)
    quantize = ep_info.get("quantize_dispatch", False)
    n = mesh.shape["model"]
    if cfg.moe_experts_padded % n:
        raise ValueError(f"{cfg.moe_experts_padded} (padded) experts do not split over a "
                         f"model axis of {n}")
    groups = [list(g) for g in
              sharding.member_grid(mesh, dp + ("model",)).reshape(-1, n)]
    b, s, d = h.shape
    if b % len(groups):
        raise ValueError(f"{b} rows do not split over {len(groups)} data-parallel members")
    e_local = cfg.moe_experts_padded // n
    outs, auxes = [], []
    for group, hl in zip(groups, h.tensor_split(len(groups))):
        p_locals = [_local_moe(p_moe, r, e_local, m.device) for r, m in enumerate(group)]
        kw = dict(members=group, capacity_per_expert=cap, quantize_dispatch=quantize)
        if not token_slice:
            res = moe_lib.moe_mlp_ep(p_locals, cfg, [hl.to(m.device) for m in group], **kw)
            outs.append(res[0][0].to(h.device))
            auxes.append(res[0][1].to(h.device))
            continue
        t = hl.shape[0] * s
        ts = -(-t // n)  # ceil for tiny decode batches
        x2 = hl.reshape(t, d)
        if ts * n != t:
            x2 = torch.cat([x2, torch.zeros((ts * n - t, d), dtype=x2.dtype, device=x2.device)])
        res = moe_lib.moe_mlp_ep(
            p_locals, cfg, [x2[r * ts:(r + 1) * ts].to(m.device)[None] for r, m in enumerate(group)],
            **kw)
        outs.append(torch.cat([o[0].to(h.device) for o, _ in res])[:t].reshape(-1, s, d))
        auxes += [a.to(h.device) for _, a in res]
    return torch.cat(outs), torch.stack(auxes).mean()


def _mamba_block_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {
        "ln": norm_init(cfg.norm_kind, cfg.d_model, device),
        "mamba": ssm_lib.mamba2_init(gen, cfg, device),
    }


def _mamba_block(p, cfg, x, cache=None):
    h = apply_norm(cfg.norm_kind, p["ln"], x)
    y, new_cache = ssm_lib.mamba2_block(p["mamba"], cfg, h, cache)
    return x + y * cfg.residual_multiplier, new_cache


def _rwkv_block_init(gen, cfg: ModelConfig, device=None) -> Params:
    return {
        "ln1": norm_init(cfg.norm_kind, cfg.d_model, device),
        "ln2": norm_init(cfg.norm_kind, cfg.d_model, device),
        "time": rwkv_lib.rwkv6_init(gen, cfg, device),
    }


def _rwkv_block(p, cfg, x, cache=None):
    h = apply_norm(cfg.norm_kind, p["ln1"], x)
    y, cache = rwkv_lib.rwkv6_time_mix(p["time"], cfg, h, cache)
    x = x + y
    h = apply_norm(cfg.norm_kind, p["ln2"], x)
    y, cache = rwkv_lib.rwkv6_channel_mix(p["time"], h, cache)
    return x + y, cache


# ---------------------------------------------------------------------------
# init and parameters across packages
# ---------------------------------------------------------------------------

def padded_vocab(v: int) -> int:
    """Embedding tables are padded to a multiple of 256 (the reference's
    sharding pad); logits are sliced back to the true vocab in _lm_logits."""
    return (v + 255) // 256 * 256


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random parameters of ``cfg`` drawn from ``generator``, on ``device``
    (``None``: the card; raises where there is none).  The tree is the
    reference's, key for key and shape for shape; the draws are not JAX's
    (tests carry the reference's parameters across with
    :func:`params_from_numpy`)."""
    from repro_torch.engine.groupby import resolve_device

    dev = resolve_device(None if device is None else str(device))
    gen = generator
    vpad = padded_vocab(cfg.vocab_size)
    p: Params = {"embed": embedding_init(gen, vpad, cfg.d_model, dev)}
    p["final_norm"] = norm_init(cfg.norm_kind, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, vpad, device=dev)

    if cfg.family == "ssm":
        p["layers"] = _stack([_rwkv_block_init(gen, cfg, dev) for _ in range(cfg.n_layers)])
    elif cfg.family == "hybrid":
        per = cfg.attn_every - 1
        n_super = cfg.n_layers // cfg.attn_every
        rem = cfg.n_layers - n_super * cfg.attn_every
        p["super"] = _stack([
            _stack([_mamba_block_init(gen, cfg, dev) for _ in range(per)])
            for _ in range(n_super)
        ])  # (n_super, per, ...)
        p["shared_attn"] = _attn_block_init(gen, cfg, device=dev)
        if rem:
            p["tail"] = _stack([_mamba_block_init(gen, cfg, dev) for _ in range(rem)])
    else:
        cross = cfg.encoder_layers > 0
        p["layers"] = _stack(
            [_attn_block_init(gen, cfg, cross=cross, device=dev) for _ in range(cfg.n_layers)]
        )
        if cfg.encoder_layers:
            p["encoder"] = {
                "layers": _stack([_attn_block_init(gen, cfg, device=dev)
                                  for _ in range(cfg.encoder_layers)]),
                "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dev),
            }
    if cfg.frontend != "none":
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, device=dev)
    return p


def _to_tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree, device=None) -> Params:
    """The reference's parameter tree (nested dicts of arrays: JAX arrays
    or their numpy copies, ``quantize_dense_params`` trees included) as the
    port's nested dict of tensors on ``device`` (``None``: the card), key
    for key, shape and dtype for dtype."""
    from repro_torch.engine.groupby import resolve_device

    dev = resolve_device(None if device is None else str(device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)


def params_to_numpy(params: Params) -> dict:
    """The port's parameters as the reference's tree of numpy arrays, key
    for key and shape for shape (float32 and int8 as they are; a bfloat16
    tensor comes back as float32, which holds it exactly)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def layer_windows(cfg: ModelConfig) -> list | None:
    """Per-layer sliding windows: gemma2 alternates local/global (-1 is
    global).  A host list, not a device array: the mask reads it per layer
    without a device read."""
    if cfg.local_global_pattern and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else -1 for i in range(cfg.n_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.n_layers
    return None


# ---------------------------------------------------------------------------
# forward (train / prefill): no caches
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


def _embed_tokens(p, cfg: ModelConfig, tokens, *, ticketed: bool, max_unique: int,
                  onehot: bool = False):
    dtype = torch_dtype(cfg.dtype)
    if onehot:
        # the reference's one-hot matmul lookup (kept for the two-buffer path)
        table = p["embed"]["table"].to(dtype)
        oh = torch.nn.functional.one_hot(tokens.reshape(-1).long(), table.shape[0]).to(dtype)
        x = (oh @ table).reshape(*tokens.shape, -1)
    elif ticketed:
        from repro_torch.core.hashing import table_capacity

        cap = table_capacity(max_unique)
        x = ticketed_embed(p["embed"]["table"], tokens, max_unique, cap).to(dtype)
    else:
        x = embed(p["embed"], tokens, dtype)
    if cfg.emb_multiplier != 1.0:  # gemma2 √d scaling / granite multiplier
        x = x * torch.tensor(cfg.emb_multiplier, dtype=dtype, device=x.device)
    return x


def _lm_logits(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        logits = x @ p["embed"]["table"].to(x.dtype).T
    else:
        logits = dense(p["lm_head"], x)
    logits = logits[..., : cfg.vocab_size]  # drop the pad rows
    logits = logits * cfg.logits_multiplier
    return softcap(logits.to(torch_dtype(cfg.logits_dtype)), cfg.final_logit_softcap)


def _unstack(tree) -> list:
    """The layer slices of a stacked tree, each leaf split by one
    ``unbind(0)``.  Under autograd that is one node a leaf whose backward
    stacks the layers' gradients once, where ``tree[i]`` for every layer
    would add a full-size zero gradient of the stack per layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# rematerialisation: the reference's jax.checkpoint on each block
# ---------------------------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_with_no_batch_dims_saveable(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the 2-D
    products (``layers.dense`` lowers to ``mm`` / ``addmm``; in JAX they are
    ``dot_general`` ops with no batch dims) and recompute everything else,
    attention's batched ``bmm`` ops included.  A hand-written kernel is a
    ctypes launch that no dispatch mode sees (B3 in ``grouped_matmul``,
    ``route``'s histogram), so it is always recomputed; keying on the
    product ops alone never keeps a buffer that a kernel fills after it
    was allocated."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(cfg):
    if cfg.remat_policy == "dots":
        return _dots_with_no_batch_dims_saveable
    return None  # full remat (save nothing)


def _remat(block, policy=None):
    """``block`` as ``jax.checkpoint(block, policy=policy)``: under autograd
    (gradients enabled and some tensor argument, parameters included,
    requiring grad) a non-reentrant ``torch.utils.checkpoint`` that keeps
    the block's inputs and, with a ``policy``, what it saves
    (``create_selective_checkpoint_contexts``), and runs the block again in
    the backward; otherwise a plain call, as ``jax.checkpoint`` does
    nothing without a gradient.  The recompute must see what the forward
    saw (MoE routing sorts stably, B3 adds no float atomics), and
    checkpoint's default ``determinism_check`` holds the recomputed saved
    tensors' shapes to the first.  The blocks draw no random numbers, so
    no RNG state is stashed."""
    def run(*args, **kwargs):
        tensors = [t for t in _leaves((args, tuple(kwargs.values())))
                   if isinstance(t, torch.Tensor)]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
            return block(*args, **kwargs)
        ctx = ({} if policy is None else
               {"context_fn": functools.partial(create_selective_checkpoint_contexts, policy)})
        return checkpoint(functools.partial(block, **kwargs), *args, use_reentrant=False,
                          preserve_rng_state=False, **ctx)
    return run


def _run_attn_stack(p_layers, cfg, x, windows, memory=None, moe_impl="dense", ep_info=None):
    block = _remat(_attn_block, _remat_policy(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, pl in enumerate(_unstack(p_layers)):
        w = windows[i] if windows is not None else None
        x, _, a = block(pl, cfg, x, window=w, memory=memory, moe_impl=moe_impl, ep_info=ep_info)
        aux = aux + a
    return x, aux


def _run_hybrid_stack(p, cfg, x):
    mamba, attn = _remat(_mamba_block), _remat(_attn_block)  # full remat, as the reference
    per = cfg.attn_every - 1
    n_super = cfg.n_layers // cfg.attn_every
    for i in range(n_super):
        p_super = _at(p["super"], i)
        for j in range(per):
            x, _ = mamba(_at(p_super, j), cfg, x)
        x, _, _ = attn(p["shared_attn"], cfg, x, window=cfg.sliding_window)
    if "tail" in p:
        for j in range(next(iter(_leaves(p["tail"]))).shape[0]):
            x, _ = mamba(_at(p["tail"], j), cfg, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _run_rwkv_stack(p_layers, cfg, x):
    block = _remat(_rwkv_block)  # full remat, as the reference
    for pl in _unstack(p_layers):
        x, _ = block(pl, cfg, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def encoder_memory(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """An enc-dec config's cross-attention memory (B, Se, D) over
    ``encoder_frames`` (B, Se, D), as ``forward`` computes it (the
    reference's ``transformer.py:408-412``): the frontend projection, the
    encoder stack, its final norm.  A cached decode step takes it as
    ``memory``."""
    enc_in = dense(params["frontend_proj"], frames.to(torch_dtype(cfg.dtype)))
    mem, _ = _run_attn_stack(params["encoder"]["layers"], cfg, enc_in, None)
    return apply_norm(cfg.norm_kind, params["encoder"]["final_norm"], mem)


def forward(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    *,
    ticketed_embedding: bool = True,
    moe_impl: str = "dense",
    ep_info: dict | None = None,
) -> ForwardOut:
    """Full-sequence forward.

    batch: tokens (B,S) [+ frontend_embeds (B,F,D)] [+ encoder_frames
    (B,Se,D) for enc-dec].
    """
    tokens = batch["tokens"]
    max_unique = min(cfg.vocab_size, tokens.shape[0] * tokens.shape[1])
    x = _embed_tokens(params, cfg, tokens, ticketed=ticketed_embedding, max_unique=max_unique)

    if cfg.frontend == "vision":
        # frontend STUB: precomputed patch embeddings replace the first F
        # token positions
        vis = dense(params["frontend_proj"], batch["frontend_embeds"].to(x.dtype))
        f = vis.shape[1]
        x = torch.cat([vis, x[:, f:, :]], dim=1)

    memory = encoder_memory(params, cfg, batch["encoder_frames"]) if cfg.encoder_layers else None

    windows = layer_windows(cfg)
    if cfg.family == "ssm":
        x, aux = _run_rwkv_stack(params["layers"], cfg, x)
    elif cfg.family == "hybrid":
        x, aux = _run_hybrid_stack(params, cfg, x)
    else:
        x, aux = _run_attn_stack(
            params["layers"], cfg, x, windows, memory=memory,
            moe_impl=moe_impl, ep_info=ep_info,
        )

    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return ForwardOut(_lm_logits(params, cfg, x), aux)


# ---------------------------------------------------------------------------
# decode (cached)
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype, device=None) -> Any:
    """Zeroed caches for every layer, stacked on the leading layer axis;
    ``device`` None is the card."""
    from repro_torch.engine.groupby import resolve_device

    dev = resolve_device(None if device is None else str(device))
    dtype = torch_dtype(dtype)
    if cfg.family == "ssm":
        return _lead(rwkv_lib.make_rwkv_cache(cfg, batch, dtype, dev), cfg.n_layers)
    if cfg.family == "hybrid":
        per = cfg.attn_every - 1
        n_super = cfg.n_layers // cfg.attn_every
        rem = cfg.n_layers - n_super * cfg.attn_every
        ssm_one = ssm_lib.make_ssm_cache(cfg, batch, dtype, dev)
        caches = {
            "super_ssm": _lead(ssm_one, n_super, per),
            "attn": _lead(make_cache(cfg, batch, max_len, dtype, dev), n_super),
        }
        if rem:
            caches["tail_ssm"] = _lead(ssm_one, rem)
        return caches
    return _lead(make_cache(cfg, batch, max_len, dtype, dev), cfg.n_layers)


def _kv_at(c: KVCache, i) -> KVCache:
    return KVCache(c.k[i], c.v[i], c.length[i])


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) — S=1 for decode, S>1 for cached prefill
    caches,
    *,
    memory=None,
    moe_impl: str = "dense",
    ep_info: dict | None = None,
    last_only: bool = False,
    frontend_embeds=None,
):
    """Cached step. S=1 → one-token decode; S>1 → prefill THROUGH the cache
    (attention appends K/V in place; SSM/RWKV run the chunked path seeded
    from the cached state).  ``last_only`` computes logits for the final
    position only.  ``memory`` feeds enc-dec cross-attention;
    ``frontend_embeds`` (VLM prefill) replaces the first F positions.
    Returns (logits, new_caches); attention caches share the buffers of
    ``caches``, which the step has written."""
    x = _embed_tokens(params, cfg, tokens, ticketed=False, max_unique=1)
    if frontend_embeds is not None:
        vis = dense(params["frontend_proj"], frontend_embeds.to(x.dtype))
        x = torch.cat([vis, x[:, vis.shape[1]:, :]], dim=1)
    windows = layer_windows(cfg)

    if cfg.family == "ssm":
        new = []
        for i in range(cfg.n_layers):
            x, c = _rwkv_block(_at(params["layers"], i), cfg, x, _at(caches, i))
            new.append(c)
        new_caches = _stack(new)
    elif cfg.family == "hybrid":
        per = cfg.attn_every - 1
        n_super = cfg.n_layers // cfg.attn_every
        ssm_new, lengths = [], []
        for i in range(n_super):
            p_super = _at(params["super"], i)
            row = []
            for j in range(per):
                x, cj = _mamba_block(_at(p_super, j), cfg, x, _at(caches["super_ssm"], (i, j)))
                row.append(cj)
            ssm_new.append(_stack(row))
            x, ac, _ = _attn_block(params["shared_attn"], cfg, x, window=cfg.sliding_window,
                                   cache=_kv_at(caches["attn"], i))
            lengths.append(ac.length)
        a = caches["attn"]
        new_caches = {"super_ssm": _stack(ssm_new),
                      "attn": KVCache(a.k, a.v, torch.stack(lengths))}
        if "tail" in params:
            tail_new = []
            for j in range(caches["tail_ssm"].state.shape[0]):
                x, cj = _mamba_block(_at(params["tail"], j), cfg, x, _at(caches["tail_ssm"], j))
                tail_new.append(cj)
            new_caches["tail_ssm"] = _stack(tail_new)
    else:
        lengths = []
        for i in range(cfg.n_layers):
            w = windows[i] if windows is not None else None
            x, c, _ = _attn_block(
                _at(params["layers"], i), cfg, x, window=w, cache=_kv_at(caches, i),
                memory=memory, moe_impl=moe_impl, ep_info=ep_info,
            )
            lengths.append(c.length)
        new_caches = KVCache(caches.k, caches.v, torch.stack(lengths))

    if last_only:
        x = x[:, -1:, :]
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    return _lm_logits(params, cfg, x), new_caches


# ---------------------------------------------------------------------------
# two-buffer decode: frozen prefix + small tail
# ---------------------------------------------------------------------------

def init_twobuf_caches(cfg: ModelConfig, batch: int, prefix_len: int, tail_len: int, dtype,
                       device=None):
    from repro_torch.engine.groupby import resolve_device

    dev = resolve_device(None if device is None else str(device))
    dtype = torch_dtype(dtype)
    prefix = make_cache(cfg, batch, prefix_len, dtype, dev)._replace(
        length=torch.full((), prefix_len, dtype=torch.int32, device=dev)
    )
    tail = make_cache(cfg, batch, tail_len, dtype, dev)
    return _lead(prefix, cfg.n_layers), _lead(tail, cfg.n_layers)


def decode_step_twobuf(params: Params, cfg: ModelConfig, tokens, prefix_caches, tail_caches):
    """One-token decode against (prefix, tail) caches. Attention-family
    archs only.  The tails are written in place."""
    from repro_torch.models.attention import twobuf_attention

    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"the two-buffer path takes attention families, not {cfg.family!r}")
    x = _embed_tokens(params, cfg, tokens, ticketed=False, max_unique=1, onehot=True)
    windows = layer_windows(cfg)
    lengths = []
    for i in range(cfg.n_layers):
        pl = _at(params["layers"], i)
        w = windows[i] if windows is not None else None
        h = apply_norm(cfg.norm_kind, pl["ln_attn"], x)
        a, new_tail = twobuf_attention(pl["attn"], cfg, h, _kv_at(prefix_caches, i),
                                       _kv_at(tail_caches, i), window=w)
        lengths.append(new_tail.length)
        if cfg.post_block_norm:
            a = apply_norm(cfg.norm_kind, pl["ln_attn_post"], a)
        x = x + a * cfg.residual_multiplier
        h = apply_norm(cfg.norm_kind, pl["ln_mlp"], x)
        if "moe" in pl:
            m, _ = moe_lib.moe_mlp_dense(pl["moe"], cfg, h)
        else:
            m = mlp(pl["mlp"], h, cfg.mlp_kind)
        if cfg.post_block_norm:
            m = apply_norm(cfg.norm_kind, pl["ln_mlp_post"], m)
        x = x + m * cfg.residual_multiplier
    x = apply_norm(cfg.norm_kind, params["final_norm"], x)
    t = tail_caches
    return _lm_logits(params, cfg, x), KVCache(t.k, t.v, torch.stack(lengths))


# ---------------------------------------------------------------------------
# loss (differentiable: train/loop.py takes its gradients)
# ---------------------------------------------------------------------------

def lm_loss(params, cfg: ModelConfig, batch, **fw_kwargs):
    out = forward(params, cfg, batch, **fw_kwargs)
    logits = out.logits  # fp32 (B,S,V)
    targets = batch["targets"]
    mask = (targets >= 0).float()
    tgt = torch.clamp(targets, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + out.aux_loss, {"nll": loss, "aux": out.aux_loss}
