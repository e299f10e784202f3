"""Grouped matmul over contiguous row groups: kernel B3, the MoE layer's
expert FFNs.

Replaces ``jax.lax.ragged_dot`` in ``repro.models.moe.moe_mlp_dense``
(``src/repro/models/moe.py:109-112``; no Pallas kernel there).  One call
computes ``out[r] = lhs[r] @ rhs[g(r)]``, where the rows of ``lhs`` fall
into ``len(group_sizes)`` contiguous groups in group order, and writes the
rows past ``sum(group_sizes)`` as zeros.  Float32 in and out, as the
reference casts both sides to float32 before ``ragged_dot``.

:func:`grouped_matmul` is the wrapper: CUDA tensors launch the hand-written
Hopper kernel ``csrc/grouped_matmul.cu`` (built at first use; counted in
``grouped_matmul.launches``; any alignment and strides of contiguous
tensors) and raise if they cannot; CPU tensors run
:func:`grouped_matmul_plain`.  The group sizes stay on the device: the
kernel takes each group's first row as a prefix sum of the sizes itself,
so the wrapper reads no size on the host (a decode step of
granite-moe-1b-a400m makes 72 calls).  The call is an autograd node: on CPU
tensors its backward differentiates the plain version; on CUDA tensors an
input that requires grad (with grad enabled) raises ``NotImplementedError``,
since B3 has no backward kernel yet (ROADMAP §2 B6).

Bound on the card: bytes at decode (64 rows over 32 experts: a call reads
every touched expert's K × N weights, ≈ 0.017 ms at 3.35 TB/s), bytes or
tensor operations at the 4096-row prefill shape (≈ 0.028 ms).  The kernel
runs on the tensor cores in error-compensated TF32 ("3xTF32"): each
operand is split into a TF32 part and a TF32 remainder, and the three
products big·big + big·small + small·big are summed per 32-deep K stage in
float32 and added up in float32 registers.  That keeps the float32
function the reference computes (one TF32 product alone is off by 3e-4 of
max|out|; 3xTF32 with exact sums by 8e-8, ``tests/test_torch_models.py``).
Both operands are staged K-major in shared memory for ``wgmma`` (TF32
takes no other layout), fed through rings by TMA boxes, two CTAs an SM
(see the source for the design and what was measured against it).  The
plain version is full float32 (``torch.backends.cuda.matmul.allow_tf32``
stays False), and the two sum in another order, so they agree to
float32 rounding (4-7e-7 of max|out| on the card), not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch


def _check(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor):
    if lhs.dim() != 2 or rhs.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(
            f"grouped_matmul takes lhs (M, K), rhs (G, K, N) and group_sizes (G,); got "
            f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, {tuple(group_sizes.shape)}"
        )
    if lhs.shape[1] != rhs.shape[1] or group_sizes.shape[0] != rhs.shape[0]:
        raise ValueError(
            f"shapes do not agree: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
            f"group_sizes {tuple(group_sizes.shape)}"
        )
    if lhs.dtype != torch.float32 or rhs.dtype != torch.float32:
        raise ValueError(f"lhs and rhs must be float32, got {lhs.dtype} and {rhs.dtype}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if not lhs.device == rhs.device == group_sizes.device:
        raise ValueError(
            f"lhs, rhs and group_sizes lie on {lhs.device}, {rhs.device}, {group_sizes.device}"
        )
    return lhs.contiguous(), rhs.contiguous(), group_sizes.contiguous()


B3_BACKWARD = ("grouped_matmul has no backward on the card yet: B3's backward (d lhs, d rhs of "
               "the grouped matmul), for MoE training, is ROADMAP §2 item B6")


class _GroupedMatmul(torch.autograd.Function):
    """B3 as an autograd node.  CPU tensors run the plain version forward
    and differentiate it backward; CUDA tensors launch the kernel, and
    :func:`grouped_matmul` refuses them where an input requires grad, since
    the kernel has no backward yet (without that check a CUDA result would
    carry no ``grad_fn`` and the expert weights would get no gradient,
    silently)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        if lhs.device.type == "cpu":
            ctx.save_for_backward(lhs, rhs, group_sizes)
            return grouped_matmul_plain(lhs, rhs, group_sizes)
        return _launch(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((lhs, rhs), need)]
            out = grouped_matmul_plain(ins[0], ins[1], group_sizes)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(ins, need) if n], g))
        return tuple(next(grads) if n else None for n in need) + (None,)


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``ragged_dot(lhs, rhs, group_sizes)`` in float32 (see the module
    docstring).  CUDA tensors launch the Hopper kernel (and raise
    ``NotImplementedError`` where ``lhs`` or ``rhs`` requires grad); CPU
    tensors run :func:`grouped_matmul_plain`, differentiably; any other
    device raises."""
    lhs, rhs, group_sizes = _check(lhs, rhs, group_sizes)
    dev = lhs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul runs on cuda or cpu tensors, not {dev}")
    if dev.type == "cuda" and torch.is_grad_enabled() and (lhs.requires_grad
                                                           or rhs.requires_grad):
        raise NotImplementedError(B3_BACKWARD)
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors checked by :func:`_check`."""
    dev = lhs.device
    m, k = lhs.shape
    g, _, n = rhs.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _kernel_library()
    err = lib.grouped_matmul_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        m, k, n, g, torch._C._cuda_getCurrentRawStream(dev.index if dev.index is not None
                                                       else torch.cuda.current_device()),
    )
    if err != 0:
        raise RuntimeError(
            "grouped_matmul kernel launch failed: " + lib.grouped_matmul_error_string(err).decode()
        )
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0  # kernel launches (CUDA tensors only)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("grouped_matmul")
    fn = lib.grouped_matmul_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
        lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    return lib


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: a loop over groups of
    ``torch.matmul`` in float32 (it reads the sizes on the host), rows past
    the last group zero.  Negative sizes count as 0 and rows are clamped to
    M, as in the kernel."""
    lhs, rhs, group_sizes = _check(lhs, rhs, group_sizes)
    m = lhs.shape[0]
    out = torch.zeros((m, rhs.shape[2]), dtype=torch.float32, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), m)
        if end > start:
            out[start:end] = lhs[start:end] @ rhs[g]
        start = end
    return out
