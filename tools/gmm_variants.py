#!/usr/bin/env python3
"""Kernel B3 (``csrc/grouped_matmul.cu``) and textual variants of it, each
built, held to ``grouped_matmul_plain`` and timed on the card.

    python3 tools/gmm_variants.py [VARIANT ...]      (default: base)

A variant is the source with a few lines replaced (``+`` joins several):

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
  timings.

Each variant is compiled with ``nvcc -Xptxas -v`` (the ptxas report is
printed), every ``mbarrier`` wait traps after 2^24 polls instead of
hanging, and the variant then runs in a subprocess with a time limit:
four identity diagnostics, ``chip_smoke.gmm_cases`` (|Δ| <= GMM_RTOL ·
max|plain|, rows past Σ sizes 0) and ``chip_smoke.GMM_SHAPES`` timed warm
and cold (CUDA events) and by CUDA-graph replay beside ``gmm_bound``.
Libraries and sources go to ``build/gmm_variants/``.
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
        ('}  // extern "C"', "int gmm_trace(void* host) {\n  return static_cast<int>("
                             "cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));\n}\n\n"
                             '}  // extern "C"'),
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


def run(so):
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import grouped_matmul as gm

    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul_launch.argtypes = [ptr] * 4 + [ctypes.c_longlong, i32, i32, i32, ptr]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_error_string.argtypes = [ctypes.c_int]
    lib.grouped_matmul_error_string.restype = ctypes.c_char_p
    gm._kernel_library = lambda: lib
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
    if len(sys.argv) > 2 and sys.argv[1] == "--run":
        return run(sys.argv[2])
    os.makedirs(OUT, exist_ok=True)
    names = sys.argv[1:] or ["base"]
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
            p = subprocess.run([sys.executable, __file__, "--run", so], timeout=150)
            print(f"== run {name}: rc {p.returncode}", flush=True)
            rc |= p.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"== run {name}: timed out", flush=True)
            rc = 1
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
