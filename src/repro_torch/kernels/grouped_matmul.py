"""Grouped matmul over contiguous row groups: kernel B3, the MoE layer's
expert FFNs, and its backward, kernel B6.

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
tensors its backward runs B6's plain version; on CUDA tensors it
launches kernel B6 (:func:`grouped_matmul_backward`, ragged_dot's VJP: one
launch for ``d_lhs[r] = g[r] @ rhs[e(r)]ᵀ`` and one for ``d_rhs[e] =
lhs[rows_e]ᵀ @ g[rows_e]``, both on ``wgmma`` in 3xTF32; ``d_lhs`` rows past
the groups and ``d_rhs`` of an empty group are zeros; counted in
``grouped_matmul_backward.launches``).  No path
falls back to a plain version when a build or launch fails.
:func:`grouped_matmul_backward_plain` (a loop of float32 ``torch.matmul``
per group) is B6's oracle on the card and nothing else.

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

B6's bound at granite-moe-1b-a400m's training shape (8192 rows, K 1024,
N 512), per product: 3 · 2 · 8192 · 1024 · 512 ≈ 25.8 GFLOP of 3xTF32,
≈ 0.052 ms at 495 TFLOP/s; its bytes ≈ 0.03-0.04 ms a product (a training
step makes 144 B6 launches).  Both products run one kernel template
(``b6::kernel`` in the source), with the same 3xTF32 arithmetic and
per-stage partial sums as B3 but 128 × 128 output tiles: two consumer
warpgroups only issue ``wgmma``s, and two split warpgroups take the
32-deep stages in turn, each waiting for its own TMA slot, splitting the
operands into TF32 big and small parts (d_rhs transposes both, since its
contraction, a group's rows, is contiguous in neither lhs nor g) and
refilling its slot with its next stage.  So a group's weights are split
once per 128 rows in d_lhs, not once per 32 as B3's engine did.  The
source note says what the card showed against the other layouts tried
(one split warpgroup, both on the same stage, 64-wide tiles, splitting a
hot group's rows over several items); a group with half the rows makes
d_rhs's items long, so Zipf-sized groups take about twice the time of
routed ones.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.launch.roofline import counted


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


class _GroupedMatmul(torch.autograd.Function):
    """B3 as an autograd node whose backward is :func:`grouped_matmul_backward`
    on every device.  CPU tensors run the plain versions both ways; CUDA
    tensors launch B3 forward and B6 backward (one launch for each input
    whose gradient is needed)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        if lhs.device.type == "meta":  # a dry run: the shape only
            return lhs.new_empty((lhs.shape[0], rhs.shape[2]))
        if lhs.device.type == "cpu":
            return grouped_matmul_plain(lhs, rhs, group_sizes)
        return _launch(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        return grouped_matmul_backward(lhs, rhs, group_sizes, g,
                                       need=ctx.needs_input_grad[:2]) + (None,)


def _b3_work(lhs, rhs, group_sizes):
    """B3's bound (PERF.md §6): 2·M·K·N FLOPs (every row in a group, as the
    MoE layer's rows are); lhs, every expert's weights, the sizes and the
    output, each once."""
    (m, k), (g, _, n) = lhs.shape, rhs.shape
    return 2 * m * k * n, 4 * (m * k + g * k * n + g + m * n)


@counted(_b3_work)
def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``ragged_dot(lhs, rhs, group_sizes)`` in float32 (see the module
    docstring).  CUDA tensors launch the Hopper kernel, and B6 in the
    backward; CPU tensors run :func:`grouped_matmul_plain`, and
    :func:`grouped_matmul_backward_plain` in the backward; ``meta`` tensors
    (a dry run) give the output's shape and compute nothing; any other
    device raises."""
    lhs, rhs, group_sizes = _check(lhs, rhs, group_sizes)
    dev = lhs.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"grouped_matmul runs on cuda, cpu or meta tensors, not {dev}")
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)


def _b6_work(lhs, rhs, group_sizes, g, *, need=(True, True)):
    """B6's bound (PERF.md §6), a product each: 2·M·K·N FLOPs; d_lhs reads
    g and the weights and writes (M, K), d_rhs reads lhs and g and writes
    (G, K, N); the sizes once a product."""
    (m, k), (e, _, n) = lhs.shape, rhs.shape
    flops = nbytes = 0
    if need[0]:
        flops, nbytes = flops + 2 * m * k * n, nbytes + 4 * (m * n + e * k * n + m * k + e)
    if need[1]:
        flops, nbytes = flops + 2 * m * k * n, nbytes + 4 * (m * k + m * n + e * k * n + e)
    return flops, nbytes


@counted(_b6_work)
def grouped_matmul_backward(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                            g: torch.Tensor, *, need=(True, True)):
    """Kernel B6: ``(d_lhs, d_rhs)``, the VJP of ``grouped_matmul(lhs, rhs,
    group_sizes)`` at the cotangent ``g`` (M, N): ``d_lhs`` (M, K), rows past
    the groups zero; ``d_rhs`` (G, K, N), an empty group's zero.  ``need``
    names which of the two to compute (None for the other).  CUDA tensors
    launch one kernel a product (``csrc/grouped_matmul.cu``; the sizes stay
    on the device) and raise if they cannot; CPU tensors run
    :func:`grouped_matmul_backward_plain`; ``meta`` tensors give the
    shapes."""
    lhs, rhs, group_sizes = _check(lhs, rhs, group_sizes)
    g = _check_cotangent(lhs, rhs, g)
    if lhs.device.type == "meta":
        return (torch.empty_like(lhs) if need[0] else None,
                torch.empty_like(rhs) if need[1] else None)
    if lhs.device.type == "cpu":
        d_lhs, d_rhs = grouped_matmul_backward_plain(lhs, rhs, group_sizes, g)
        return d_lhs if need[0] else None, d_rhs if need[1] else None
    if lhs.device.type != "cuda":
        raise ValueError(f"grouped_matmul_backward runs on cuda or cpu tensors, not {lhs.device}")
    d_lhs = d_rhs = None
    if need[0]:
        d_lhs = torch.empty_like(lhs)
        _launch_dlhs(g, rhs, group_sizes, d_lhs)
    if need[1]:
        d_rhs = torch.empty_like(rhs)
        _launch_drhs(lhs, g, group_sizes, d_rhs)
    return d_lhs, d_rhs


grouped_matmul_backward.launches = 0  # B6 kernel launches: one a product (CUDA tensors only)


def _check_cotangent(lhs: torch.Tensor, rhs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    want = (lhs.shape[0], rhs.shape[2])
    if tuple(g.shape) != want or g.dtype != torch.float32 or g.device != lhs.device:
        raise ValueError(f"the cotangent must be float32 {want} on {lhs.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    return g.contiguous()


def _stream(dev: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(dev.index if dev.index is not None
                                               else torch.cuda.current_device())


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.grouped_matmul_error_string(err).decode())


def _launch_dlhs(g: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                 out: torch.Tensor) -> None:
    """B6's d_lhs launch into ``out`` (M, K), which it writes whole (a
    contraction N of 0 leaves zeros without a launch)."""
    m, n = g.shape
    gcount, k, _ = rhs.shape
    if m == 0 or k == 0:
        return
    if n == 0:
        out.zero_()
        return
    lib = _kernel_library()
    _raise_on(lib, lib.grouped_matmul_dlhs_launch(
        g.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, k, n, gcount,
        _stream(g.device)), "grouped_matmul_backward (d_lhs)")
    grouped_matmul_backward.launches += 1


def _launch_drhs(lhs: torch.Tensor, g: torch.Tensor, group_sizes: torch.Tensor,
                 out: torch.Tensor) -> None:
    """B6's d_rhs launch into ``out`` (G, K, N), which it writes whole."""
    m, k = lhs.shape
    gcount, _, n = out.shape
    if gcount == 0 or k == 0 or n == 0:
        return
    lib = _kernel_library()
    _raise_on(lib, lib.grouped_matmul_drhs_launch(
        lhs.data_ptr(), g.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, k, n, gcount,
        _stream(lhs.device)), "grouped_matmul_backward (d_rhs)")
    grouped_matmul_backward.launches += 1


def _launch(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors checked by :func:`_check`."""
    dev = lhs.device
    m, k = lhs.shape
    g, _, n = rhs.shape
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _kernel_library()
    _raise_on(lib, lib.grouped_matmul_launch(
        lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), m, k, n, g,
        _stream(dev)), "grouped_matmul")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0  # kernel launches (CUDA tensors only)


def _kernel_library() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load_library("grouped_matmul")
    fn = lib.grouped_matmul_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for f in (fn, lib.grouped_matmul_dlhs_launch, lib.grouped_matmul_drhs_launch):
            f.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, i32, ptr]
            f.restype = ctypes.c_int
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


def grouped_matmul_backward_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
                                  g: torch.Tensor):
    """B6's plain version, on any device: ``(d_lhs, d_rhs)`` by a loop over
    groups of float32 ``torch.matmul`` (it reads the sizes on the host):
    ``d_lhs[rows] = g[rows] @ rhs[e]ᵀ`` and ``d_rhs[e] = lhs[rows]ᵀ @
    g[rows]``; rows past the last group and empty groups zero.  Negative
    sizes count as 0 and rows are clamped to M, as in the kernels."""
    lhs, rhs, group_sizes = _check(lhs, rhs, group_sizes)
    g = _check_cotangent(lhs, rhs, g)
    m = lhs.shape[0]
    d_lhs = torch.zeros_like(lhs)
    d_rhs = torch.zeros_like(rhs)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), m)
        if end > start:
            d_lhs[start:end] = g[start:end] @ rhs[e].T
            d_rhs[e] = lhs[start:end].T @ g[start:end]
        start = end
    return d_lhs, d_rhs
