#!/usr/bin/env python3
"""Kernels B3 and B6 (``csrc/grouped_matmul.cu``) and textual variants of
the source, each built, held to its plain version and timed on the card.

    python3 tools/gmm_variants.py [--b6] [VARIANT ...]      (default: base)

Without ``--b6`` each variant runs B3; with it, B6.  A variant is the
source with a few lines replaced (``+`` joins several):

- ``base``: the source as it is;
- ``one``: one CTA an SM instead of two;
- ``three``: three CTAs an SM and two-stage rings (the shared memory
  that three CTAs leave);
- ``plain``: both rings filled by 4-byte ``cp.async`` copies (the path for
  operands TMA cannot address);
- ``cvt``: TF32 rounding by ``cvt.rna.tf32.f32`` instead of two integer
  operations;
- ``trace``: ``clock64()`` stamps a stage on CTA 0 (the consumer's waits,
  barrier and wgmma issue, the producer's waits), printed after the
  timings;
- B6's: ``n64`` (64-wide N tiles: d_rhs's g columns and d_lhs's rows,
  half the split's reuse), ``regs152`` and ``regs168`` (the consumers'
  registers a thread after ``setmaxnreg``, against 160; the split
  warpgroups get the rest), ``b6trace`` (``clock64()`` stamps a stage on
  CTA 0: its split warpgroup's wait for the copies, A's loads and the wait
  for a free buffer, A's stores with B's loads and the barrier, the refill
  with B's stores; the first consumer thread's wait and its wgmmas).

Each variant is compiled with ``nvcc -Xptxas -v`` (the ptxas report is
printed), every ``mbarrier`` wait traps after 2^24 polls instead of
hanging, and the variant then runs in a subprocess with a time limit.
B3: four identity diagnostics, ``chip_smoke.gmm_cases`` (|Δ| <= GMM_RTOL ·
max|plain|, rows past Σ sizes 0) and ``chip_smoke.GMM_SHAPES`` timed warm
and cold (CUDA events) and by CUDA-graph replay beside ``gmm_bound``.  B6:
``chip_smoke.gmm_bwd_cases`` (each product within GMM_RTOL · max|plain|,
outputs filled with NaN first, d_lhs rows past Σ sizes and empty groups'
d_rhs 0) and ``chip_smoke.b6_shape_cases`` by CUDA-graph replay (the call,
each product alone) beside ``b6_bound``.  Libraries and sources go to
``build/gmm_variants/``.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)
OUT = os.path.join(ROOT, "build", "gmm_variants")
CU = os.path.join(ROOT, "src", "repro_torch", "csrc", "grouped_matmul.cu")

GUARD = [("  uint32_t done;\n  do {", "  uint32_t done, spins = 0;\n  do {"),
         ("  } while (!done);", "  } while (!done && ++spins < (1u << 24));\n"
                                "  if (!done) asm volatile(\"trap;\");")]

TRACE_POINT = "  if (tr) g_trace[r0 * 8 + {}] = clock64();\n"
PRODUCER = ("        if (blockIdx.x == 0 && lane == 0 && ring < 500) "
            "g_trace[ring * 8 + {}] = clock64();\n")
SPLIT = ("  {{ const uint32_t gs_ = 2 * k + sw; if (blockIdx.x == 0 && ts == 0 && gs_ < 500) "
         "g_trace[gs_ * 8 + {}] = clock64(); }}\n")
MMA = "    if (blockIdx.x == 0 && tid == 0 && ring < 500) g_trace[ring * 8 + {}] = clock64();\n"
TRACE_EXPORT = ('}  // extern "C"', "int gmm_trace(void* host) {\n  return static_cast<int>("
                "cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));\n}\n\n"
                '}  // extern "C"')

SUBS = {
    "one": [("constexpr int kCtasPerSm = 2; ", "constexpr int kCtasPerSm = 1; ")],
    "three": [("constexpr int kCtasPerSm = 2; ", "constexpr int kCtasPerSm = 3; "),
              ("constexpr int kWStages = 5; ", "constexpr int kWStages = 2; "),
              ("constexpr int kLStages = 5; ", "constexpr int kLStages = 2; ")],
    "plain": [("p.w_tma = G > 0 &&", "p.w_tma = false &&"),
              ("p.l_tma = tensor_map(", "p.l_tma = false && tensor_map(")],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
             "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
             "  return r;")],
    "trace": [
        ("namespace {\n", "namespace {\n__device__ long long g_trace[4096];\n"),
        ("  wgmma_wait<0>();  // this warp's previous stage is done\n",
         "  const bool tr = blockIdx.x == 0 && tid == 0 && ring < 500;\n"
         "  const uint32_t r0 = ring;\n" + TRACE_POINT.format(0) +
         "  wgmma_wait<0>();\n"),
        ("  mbar_wait(sh.full_l(ls), (ring / kLStages) & 1);\n",
         "  mbar_wait(sh.full_l(ls), (ring / kLStages) & 1);\n" + TRACE_POINT.format(1)),
        ("  mbar_wait(sh.full_w(ws), (ring / kWStages) & 1);\n",
         "  mbar_wait(sh.full_w(ws), (ring / kWStages) & 1);\n" + TRACE_POINT.format(2)),
        ("  consumer_sync();  // the buffer written by every warp; every warp past its wait\n",
         "  consumer_sync();\n" + TRACE_POINT.format(3)),
        ("  wgmma_commit();\n}\n", "  wgmma_commit();\n" + TRACE_POINT.format(4) + "}\n"),
        ("        mbar_wait(sh.empty_w(ws), ((ring / kWStages) & 1) ^ 1);\n",
         PRODUCER.format(6) + "        mbar_wait(sh.empty_w(ws), ((ring / kWStages) & 1) ^ 1);\n" +
         PRODUCER.format(5)),
        ("        mbar_wait(sh.empty_l(ls), ((ring / kLStages) & 1) ^ 1);\n",
         "        mbar_wait(sh.empty_l(ls), ((ring / kLStages) & 1) ^ 1);\n" + PRODUCER.format(7)),
        TRACE_EXPORT,
    ],
    "n64": [("constexpr int kNT = 128; ", "constexpr int kNT = 64; ")],
    "regs152": [("constexpr int kMmaRegs = 160; ", "constexpr int kMmaRegs = 152; "),
                ("constexpr int kSplitRegs = 96; ", "constexpr int kSplitRegs = 104; ")],
    "regs168": [("constexpr int kMmaRegs = 160; ", "constexpr int kMmaRegs = 168; "),
                ("constexpr int kSplitRegs = 96; ", "constexpr int kSplitRegs = 88; ")],
    "b6trace": [
        ("namespace {\n", "namespace {\n__device__ long long g_trace[4096];\n"),
        ("      mbar_wait(sh.full(sw), k & 1);\n",
         SPLIT.format(0) + "      mbar_wait(sh.full(sw), k & 1);\n" + SPLIT.format(1)),
        ("  mbar_wait(sh.op_empty(sw), (k & 1) ^ 1);  // the consumers are done with the buffer\n",
         "  mbar_wait(sh.op_empty(sw), (k & 1) ^ 1);\n" + SPLIT.format(2)),
        ("  split_sync(sw);  // the warpgroup has read the slot\n",
         "  split_sync(sw);\n" + SPLIT.format(3)),
        ("      fence_async_shared();\n      mbar_arrive(sh.op_full(sw));\n",
         SPLIT.format(4) + "      fence_async_shared();\n      mbar_arrive(sh.op_full(sw));\n"),
        ("    mbar_wait(sh.op_full(buf), (ring / kBufs) & 1);\n",
         MMA.format(5) + "    mbar_wait(sh.op_full(buf), (ring / kBufs) & 1);\n" + MMA.format(6)),
        ("      default: mma_stage<N, 4>(sh, buf, wg, part); break;\n    }\n",
         "      default: mma_stage<N, 4>(sh, buf, wg, part); break;\n    }\n" + MMA.format(7)),
        TRACE_EXPORT,
    ],
}


def variant_source(name):
    """The source of variant ``name``, written to the build directory."""
    s = open(CU).read()
    for part in ["guard"] + [p for p in name.split("+") if p != "base"]:
        for old, new in GUARD if part == "guard" else SUBS[part]:
            if old not in s:
                raise SystemExit(f"variant {part}: the source has no {old[:60]!r}")
            s = s.replace(old, new)
    path = os.path.join(OUT, f"gmm_{name.replace('+', '_')}.cu")
    with open(path, "w") as f:
        f.write(s)
    return path


def build(name):
    src = variant_source(name)
    so = src[:-3] + ".so"
    nvcc = "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    return name, so, p.returncode, time.perf_counter() - t0, p.stdout + p.stderr


def print_trace(lib, name, buf):
    t = list(buf)
    base = t[0]
    print(f"trace {name} (cycles; CTA 0): stage: start, +wait rows, +wait weights, +barrier, "
          f"+wgmma issue | period | producer waited on empty, weights issued -> consumed")
    for r in list(range(0, 6)) + list(range(28, 34)) + list(range(58, 62)):
        e, nxt = t[r * 8:(r + 1) * 8], t[(r + 1) * 8]
        if not e[0] or not nxt:
            continue
        print(f"  {r:3d}: {e[0] - base:7d} {e[1] - e[0]:6d} {e[2] - e[1]:6d} {e[3] - e[2]:6d} "
              f"{e[4] - e[3]:6d} | {nxt - e[0]:6d} | {e[5] - e[6]:7d} {e[2] - e[5]:7d}")


def print_b6_trace(name, buf):
    t = list(buf)
    base = t[0]
    print(f"trace {name} (cycles; CTA 0): stage: start, split warpgroup: +wait copies, +A loads "
          f"and wait buffer, +A stores, B loads, barrier, +refill, B stores | consumer: waited, "
          f"wgmmas | period of the warpgroup (two stages)")
    for r in list(range(0, 6)) + list(range(28, 34)) + list(range(120, 124)):
        e, nxt = t[r * 8:(r + 1) * 8], t[(r + 2) * 8]
        if not e[0] or not nxt:
            continue
        print(f"  {r:3d}: {e[0] - base:8d} {e[1] - e[0]:6d} {e[2] - e[1]:6d} {e[3] - e[2]:6d} "
              f"{e[4] - e[3]:6d} | {e[6] - e[5]:6d} {e[7] - e[6]:6d} | {nxt - e[0]:6d}")


def load(so):
    """The variant's library, with the wrapper's argument types, installed
    as the wrapper's library."""
    from repro_torch.kernels import grouped_matmul as gm

    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for f in (lib.grouped_matmul_launch, lib.grouped_matmul_dlhs_launch,
              lib.grouped_matmul_drhs_launch):
        f.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, i32, ptr]
        f.restype = ctypes.c_int
    lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
    lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    gm._kernel_library = lambda: lib
    return lib


def run_b6(so):
    """B6 of the variant: held to its plain version on ``gmm_bwd_cases``,
    timed on ``b6_shape_cases`` by graph replay.  Returns an exit code."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gm

    lib = load(so)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for name, (lhs, rhs, sizes, g) in cs.gmm_bwd_cases(gen, dev).items():
        d_lhs, d_rhs = torch.full_like(lhs, float("nan")), torch.full_like(rhs, float("nan"))
        gm._launch_dlhs(g.contiguous(), rhs.contiguous(), sizes, d_lhs)
        gm._launch_drhs(lhs.contiguous(), g.contiguous(), sizes, d_rhs)
        torch.cuda.synchronize()
        w_lhs, w_rhs = gm.grouped_matmul_backward_plain(lhs, rhs, sizes, g)
        total = min(int(sizes.clamp(min=0).sum()), lhs.shape[0])
        good, errs = True, []
        for got, want in ((d_lhs, w_lhs), (d_rhs, w_rhs)):
            err = float((got - want).abs().nan_to_num(float("inf")).max()) if got.numel() else 0.0
            scale = float(want.abs().max()) if want.numel() else 0.0
            good &= bool(torch.isfinite(got).all()) and err <= cs.GMM_RTOL * scale
            errs.append(f"max|Δ|={err:.3g} rel={err / max(scale, 1e-30):.3g}")
        good &= not bool(d_lhs[total:].any()) and not bool(d_rhs[sizes <= 0].any())
        ok &= good
        print(f"case {name}: M={lhs.shape[0]} K={lhs.shape[1]} N={rhs.shape[2]} d_lhs "
              f"{errs[0]}, d_rhs {errs[1]} {'ok' if good else 'FAIL'}", flush=True)
    res = {}
    for name, (lhs, rhs, sizes) in cs.b6_shape_cases(gen, dev).items():
        g = torch.randn(lhs.shape[0], rhs.shape[2], generator=gen, device=dev)
        d_lhs, d_rhs = torch.empty_like(lhs), torch.empty_like(rhs)
        r = res[name] = dict(
            graph=cs.time_graph(lambda: gm.grouped_matmul_backward(lhs, rhs, sizes, g)),
            dlhs=cs.time_graph(lambda: gm._launch_dlhs(g, rhs, sizes, d_lhs)),
            drhs=cs.time_graph(lambda: gm._launch_drhs(lhs, g, sizes, d_rhs)),
            **cs.b6_bound(lhs, rhs, sizes))
        print(f"time {name}: graph {r['graph']:.4f} (d_lhs {r['dlhs']:.4f}, d_rhs "
              f"{r['drhs']:.4f}) ms; bound {r['bound_ms']:.4f} ({r['bound_by']}); largest group "
              f"{int(sizes.max())} rows", flush=True)
        if hasattr(lib, "gmm_trace"):
            for what, fn in (("d_lhs", lambda: gm._launch_dlhs(g, rhs, sizes, d_lhs)),
                             ("d_rhs", lambda: gm._launch_drhs(lhs, g, sizes, d_rhs))):
                fn()
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * 4096)()
                lib.gmm_trace.argtypes = [ctypes.c_void_p]
                if lib.gmm_trace(ctypes.addressof(buf)) == 0:
                    print_b6_trace(f"{name} {what}", buf)
    print("times " + json.dumps(res))
    return 0 if ok else 1


def run(so):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gm

    lib = load(so)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in ((8, 8, 64), (8, 32, 64), (16, 32, 64), (128, 64, 128)):
        # one group, lhs = identity: out = the first rows of rhs
        lhs = torch.zeros(m, k, device=dev)
        lhs[torch.arange(min(m, k)), torch.arange(min(m, k))] = 1.0
        rhs = torch.arange(k * n, device=dev, dtype=torch.float32).reshape(1, k, n) / 16
        sizes = torch.tensor([m], dtype=torch.int32, device=dev)
        bad = (gm.grouped_matmul(lhs, rhs, sizes) - gm.grouped_matmul_plain(lhs, rhs, sizes))
        print(f"identity m={m} k={k} n={n}: {int((bad.abs() > 1e-4).sum())} of {bad.numel()} "
              "wrong", flush=True)
    ok = True
    for name, (lhs, rhs, sizes) in cs.gmm_cases(gen, dev).items():
        got = gm.grouped_matmul(lhs, rhs, sizes)
        torch.cuda.synchronize()
        want = gm.grouped_matmul_plain(lhs, rhs, sizes)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        total = min(int(sizes.clamp(min=0).sum()), lhs.shape[0])
        good = (err <= cs.GMM_RTOL * scale and not bool(got[total:].any())
                and bool(torch.isfinite(got).all()))
        ok &= good
        print(f"case {name}: M={lhs.shape[0]} K={lhs.shape[1]} N={rhs.shape[2]} max|Δ|={err:.3g} "
              f"rel={err / max(scale, 1e-30):.3g} {'ok' if good else 'FAIL'}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    res = {}
    for name, (tokens, k, n) in cs.GMM_SHAPES.items():
        lhs, rhs, sizes = cs.gmm_case(gen, dev, tokens, k, n)

        def call():
            return gm.grouped_matmul(lhs, rhs, sizes)

        res[name] = dict(warm=cs.time_cuda(call, 7), cold=cs.time_cold(call, flush, 7),
                         graph=cs.time_graph(call), **cs.gmm_bound(lhs, rhs, sizes))
        r = res[name]
        print(f"time {name}: warm {r['warm']:.4f} cold {r['cold']:.4f} graph {r['graph']:.4f} ms; "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        if hasattr(lib, "gmm_trace"):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 4096)()
            lib.gmm_trace.argtypes = [ctypes.c_void_p]
            if lib.gmm_trace(ctypes.addressof(buf)) == 0:
                print_trace(lib, name, buf)
    print("times " + json.dumps(res))
    return 0 if ok else 1


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--run":
        return (run_b6 if sys.argv[3] == "b6" else run)(sys.argv[2])
    os.makedirs(OUT, exist_ok=True)
    args = sys.argv[1:]
    kernel = "b6" if args[:1] == ["--b6"] else "b3"
    names = args[1 if kernel == "b6" else 0:] or ["base"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a variant, together
        built = list(pool.map(build, names))
    rc = 0
    for name, so, brc, secs, log in built:
        print(f"== build {name}: rc {brc}, {secs:.1f} s", flush=True)
        print("\n".join(ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "C75" in ln or "error" in ln),
              flush=True)
        rc |= bool(brc)
    for name, so, brc, secs, log in built:
        if brc:
            continue
        print(f"== run {name}", flush=True)
        try:
            p = subprocess.run([sys.executable, __file__, "--run", so, kernel], timeout=240)
            print(f"== run {name}: rc {p.returncode}", flush=True)
            rc |= p.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"== run {name}: timed out", flush=True)
            rc = 1
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
