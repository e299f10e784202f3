"""Fold a chunk's heavy-hitter rows into dense registers and strip them
from the tail: the hybrid strategy's register path.

Card counterpart of the reference's jnp loop ``_hybrid_registers``
(``repro.engine.executors``, a ``lax.scan`` over morsels of an (R ×
morsel) compare; it has no Pallas kernel).  One call takes a chunk's flat
key column (int32 bit patterns), R heavy keys (``EMPTY_I32``-padded), S
accumulator planes (a kind each, and a float32 value column unless the
kind is ``count``) and the carried ``(S, R)`` float32 registers, and

  * folds every row whose key is a live heavy key into that key's register
    of every plane, IN PLACE (sum / count add, count 1.0 a row; min / max);
  * returns the tail key column: ``EMPTY_I32`` where a row hit a register,
    its key elsewhere (the reference's heavy mask applied to the keys).

The live heavy keys are expected distinct; with a repeated one, a row
folds into the first register that holds its key (the reference's compare
would fold it into each).  R is at most :data:`MAX_REGISTERS` and S at
most :data:`MAX_PLANES`; past either, ``ValueError`` on every device.

:func:`hybrid_registers` is the wrapper: CUDA tensors launch the
hand-written Hopper kernel ``csrc/hybrid_registers.cu`` (built at first
use; counted in ``hybrid_registers.launches``) and raise if they cannot;
CPU tensors run :func:`hybrid_registers_plain`.  Inputs that already fit
the kernel launch it with no conversion (the kind and pointer arrays are
built once per kind tuple); others go through the checks and conversions
of the plain path first.  The kernel adds in
another order than the plain version, so SUM agrees to float tolerance
and COUNT / MIN / MAX and the tail keys exactly.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch

from repro_torch.core.hashing import EMPTY_I32
from repro_torch.kernels import build

KINDS = ("sum", "count", "min", "max")
_KIND_CODE = {k: i for i, k in enumerate(KINDS)}
_COUNT = _KIND_CODE["count"]
MAX_REGISTERS = 256   # csrc kMaxRegisters
MAX_PLANES = 16       # csrc kMaxPlanes
# rows per block of the plain version's (R × rows) compare
_PLAIN_BLOCK_ROWS = 1 << 16


def _prepare(keys, heavy, values, regs, kinds):
    """Checks shared by both paths; returns (keys, heavy, planes) with keys
    and heavy as contiguous int32 and the value planes (None for count) as
    contiguous float32, all on the registers' device."""
    kinds = tuple(kinds)
    for k in kinds:
        if k not in _KIND_CODE:
            raise ValueError(f"unknown kind {k!r}; available: {KINDS}")
    keys = torch.as_tensor(keys)
    heavy = torch.as_tensor(heavy)
    if keys.dtype != torch.int32 or heavy.dtype != torch.int32:
        raise ValueError(f"keys and heavy must be int32 bit patterns, got {keys.dtype} "
                         f"and {heavy.dtype}")
    if keys.dim() != 1 or heavy.dim() != 1:
        raise ValueError(f"keys {tuple(keys.shape)} and heavy {tuple(heavy.shape)} must be 1-D")
    s, r = len(kinds), heavy.shape[0]
    if not 1 <= r <= MAX_REGISTERS:
        raise ValueError(f"{r} heavy keys: the register fold takes 1 to "
                         f"MAX_REGISTERS={MAX_REGISTERS}")
    if not 1 <= s <= MAX_PLANES:
        raise ValueError(f"{s} accumulator planes: the register fold takes 1 to "
                         f"MAX_PLANES={MAX_PLANES}")
    if len(values) != s:
        raise ValueError(f"{len(values)} value planes for {s} kinds")
    if (regs.dtype != torch.float32 or tuple(regs.shape) != (s, r)
            or not regs.is_contiguous()):
        raise ValueError(f"regs must be a contiguous ({s}, {r}) float32 tensor, got "
                         f"{tuple(regs.shape)} {regs.dtype}")
    dev = regs.device
    if keys.device != dev or heavy.device != dev:
        raise ValueError(f"keys on {keys.device}, heavy on {heavy.device}, regs on {dev}")
    planes = []
    for kind, v in zip(kinds, values):
        if kind == "count":
            planes.append(None)
            continue
        if v is None:
            raise ValueError(f"a {kind!r} plane needs a value column")
        v = torch.as_tensor(v)
        if v.shape != keys.shape or v.device != dev:
            raise ValueError(f"value column {tuple(v.shape)} on {v.device} does not match "
                             f"keys {tuple(keys.shape)} on {dev}")
        planes.append(v.to(torch.float32).contiguous())
    return keys.contiguous(), heavy.contiguous(), planes, kinds


def hybrid_registers(keys: torch.Tensor, heavy: torch.Tensor,
                     values: Sequence[torch.Tensor | None], regs: torch.Tensor, *,
                     kinds: Sequence[str]) -> torch.Tensor:
    """Fold the heavy rows of ``keys`` into ``regs`` in place and return
    the tail key column (see the module docstring).  ``values[s]`` is the
    value column of plane ``s`` (ignored, and may be None, for a count
    plane).  CUDA tensors launch the Hopper kernel; CPU tensors run
    :func:`hybrid_registers_plain`; any other device raises."""
    if regs.is_cuda:
        call = _lean_call(keys, heavy, values, regs, kinds)
        if call is None:  # an input to convert, or one to refuse
            keys, heavy, planes, kinds = _prepare(keys, heavy, values, regs, kinds)
            call = _lean_call(keys, heavy, planes, regs, kinds)
        return _launch(*call)
    keys, heavy, planes, kinds = _prepare(keys, heavy, values, regs, kinds)
    if regs.device.type == "cpu":
        return _plain(keys, heavy, planes, regs, kinds)
    raise ValueError(f"hybrid_registers runs on cuda or cpu tensors, not {regs.device}")


hybrid_registers.launches = 0  # kernel launches (CUDA tensors only)

# per thread, kinds tuple → (S, the kind codes, a pointer array filled per
# call): built once
_CALLS = threading.local()


def _call_of(kinds):
    """The kind tuple's (S, kind codes, pointer array), or None for an
    unknown kind or an S past the kernel's."""
    calls = _CALLS.__dict__.setdefault("by_kinds", {})
    c = calls.get(kinds)
    if c is None:
        if not (1 <= len(kinds) <= MAX_PLANES and all(k in _KIND_CODE for k in kinds)):
            return None
        codes = (ctypes.c_int * len(kinds))(*(_KIND_CODE[k] for k in kinds))
        c = calls[kinds] = (len(kinds), codes, (ctypes.c_void_p * len(kinds))())
    return c


def _lean_call(keys, heavy, values, regs, kinds):
    """The launch's arguments when every input already fits the kernel
    (int32 contiguous 1-D keys and heavy keys, contiguous float32 value
    columns of the keys' length, the registers' shape, the registers'
    device), with no conversion and no copy; None when one does not."""
    c = _call_of(kinds if type(kinds) is tuple else tuple(kinds))
    if (c is None or len(values) != c[0] or not isinstance(keys, torch.Tensor)
            or not isinstance(heavy, torch.Tensor)):
        return None
    s, codes, ptrs = c
    idx = regs.get_device()
    r = heavy.shape[0] if heavy.dim() == 1 else 0
    if (keys.dtype != torch.int32 or heavy.dtype != torch.int32 or keys.dim() != 1
            or not 1 <= r <= MAX_REGISTERS or not keys.is_contiguous()
            or not heavy.is_contiguous() or keys.get_device() != idx
            or heavy.get_device() != idx or regs.dtype != torch.float32
            or regs.shape != (s, r) or not regs.is_contiguous()):
        return None
    n = keys.shape[0]
    seen = seen_ptr = None  # a column that several planes share is checked once
    for i, v in enumerate(values):
        if codes[i] == _COUNT:
            ptrs[i] = None
            continue
        if v is not seen:
            if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.dim() == 1
                    and v.shape[0] == n and v.is_contiguous() and v.get_device() == idx):
                return None
            seen, seen_ptr = v, v.data_ptr()
        ptrs[i] = seen_ptr
    return keys, heavy, regs, s, codes, ptrs, idx


def _launch(keys, heavy, regs, s, codes, ptrs, idx):
    n = keys.shape[0]
    tail = torch.empty(n, dtype=torch.int32, device=regs.device)
    if n == 0:
        return tail
    lib = _kernel_library()
    err = lib.hybrid_registers_launch(
        keys.data_ptr(), heavy.data_ptr(), heavy.shape[0], ptrs, codes, s,
        regs.data_ptr(), tail.data_ptr(), n, torch._C._cuda_getCurrentRawStream(idx),
    )
    if err != 0:
        raise RuntimeError("hybrid_registers kernel launch failed: "
                           + lib.hybrid_registers_error_string(err).decode())
    hybrid_registers.launches += 1
    return tail


def _kernel_library() -> ctypes.CDLL:
    lib = build.load_library("hybrid_registers")
    fn = lib.hybrid_registers_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, ctypes.c_longlong, ptr]
        fn.restype = ctypes.c_int
        lib.hybrid_registers_error_string.argtypes = [ctypes.c_int]
        lib.hybrid_registers_error_string.restype = ctypes.c_char_p
    return lib


def hybrid_registers_plain(keys: torch.Tensor, heavy: torch.Tensor,
                           values: Sequence[torch.Tensor | None], regs: torch.Tensor, *,
                           kinds: Sequence[str]) -> torch.Tensor:
    """The plain PyTorch version, on any device: the reference's compare
    of every row against every heavy key, in blocks of rows, with masked
    count / sum / min / max reductions folded into ``regs`` in place.
    Returns the tail key column."""
    keys, heavy, planes, kinds = _prepare(keys, heavy, values, regs, kinds)
    return _plain(keys, heavy, planes, regs, kinds)


def _plain(keys, heavy, planes, regs, kinds):
    tail = keys.clone()
    for lo in range(0, keys.shape[0], _PLAIN_BLOCK_ROWS):
        k = keys[lo:lo + _PLAIN_BLOCK_ROWS]
        hit = (k[None, :] == heavy[:, None]) & (k != EMPTY_I32)[None, :]  # (R, rows)
        hit = hit & (hit.cumsum(0) == 1)  # a row takes its first register only
        for s, (kind, v) in enumerate(zip(kinds, planes)):
            if kind == "count":
                regs[s] += hit.sum(dim=1).to(torch.float32)
                continue
            vb = v[lo:lo + _PLAIN_BLOCK_ROWS][None, :]
            if kind == "sum":
                regs[s] += torch.where(hit, vb, 0.0).sum(dim=1)
            elif kind == "min":
                regs[s] = torch.minimum(
                    regs[s], torch.where(hit, vb, float("inf")).amin(dim=1))
            else:
                regs[s] = torch.maximum(
                    regs[s], torch.where(hit, vb, float("-inf")).amax(dim=1))
        tail[lo:lo + _PLAIN_BLOCK_ROWS] = torch.where(
            hit.any(dim=0), torch.full_like(k, EMPTY_I32), k)
    return tail
