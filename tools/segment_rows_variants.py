#!/usr/bin/env python3
"""Kernel B5 (``csrc/segment_rows.cu``) and textual variants of it, each
built, held to ``segment_rows_plain`` and timed on the card.

    python3 tools/segment_rows_variants.py [VARIANT ...]      (default: base)

A variant is the source with a few lines replaced (``+`` joins several):

- ``base``: the source as it is (W = 8 columns a CTA, 256 threads, 8
  float4 sums a thread, 8 row loads a thread in flight);
- ``w4`` / ``w16``: W = 4 (with 4 sums a thread) / 16 columns a CTA on
  the 16-byte path;
- ``out4``: 4 float4 sums a thread (half the tickets a CTA: two ticket
  ranges at G = 1024, 256 CTAs);
- ``loads4``: 4 row loads a thread in flight (half the rows a round);
- ``t128``: 128 threads a CTA;
- ``short8`` / ``short128``: the whole warp adds a sum of more than 8 /
  128 rows (32 in the source);
- diagnostics, which are not the function and may fail its check:
  ``storeonly`` (no row is read: the stores alone), ``empty`` (the
  kernel returns at once: the launch), ``nosum`` (a sum adds its
  ticket's first row only: what the hot tickets' rows cost) and
  ``twice`` (the rows are staged, sorted and summed twice in one launch:
  with ``trace``, the second pass's stages, on warm caches);
- ``trace``: ``clock64()`` stamps between the stages of the first and the
  last CTA, printed after the timings.

The base variant's run also prints the host microseconds a call of the
wrapper's pieces and of the library call.

Each variant is compiled with ``nvcc -Xptxas -v`` (the ptxas report and
the shared-memory atomic instructions of ``cuobjdump -sass`` are printed),
then runs in a subprocess with a time limit: ``chip_smoke``'s phase-2
cases of B5 (skipped for a diagnostic), then the training shape (1024
rows of d = 1024 at the tickets of 1024 Zipf ids, G = 1024) at those
tickets and at distinct ones, and R = G = 16384, by CUDA events and by
CUDA-graph replay, beside the bytes bound and ``torch.zeros`` +
``index_add_`` timed the same way.  Libraries and sources go to
``build/segment_rows_variants/``.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)
OUT = os.path.join(ROOT, "build", "segment_rows_variants")
CU = os.path.join(ROOT, "src", "repro_torch", "csrc", "segment_rows.cu")
CUDA_BIN = "/usr/local/cuda/bin"

SUBS = {
    "w4": [("? launch<8, true>(", "? launch<4, true>("),
           ("constexpr int kOut = 8; ", "constexpr int kOut = 4; ")],
    "w16": [("? launch<8, true>(", "? launch<16, true>(")],
    "out4": [("constexpr int kOut = 8; ", "constexpr int kOut = 4; ")],
    "loads4": [("constexpr int kLoads = 8; ", "constexpr int kLoads = 4; ")],
    "t128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "storeonly": [("base < R; base += kChunk", "base < 0; base += kChunk")],
    "twice": [("  for (long long base = 0; base < R; base += kChunk) {",
               "  for (int rep = 0; rep < 2; ++rep)\n"
               "  for (long long base = 0; base < R; base += kChunk) {")],
    "nosum": [("      n[j] = t < gn ? count[t] : 0;", "      n[j] = t < gn ? min(count[t], 1) : 0;")],
    "short8": [("constexpr int kShort = 32; ", "constexpr int kShort = 8; ")],
    "short128": [("constexpr int kShort = 32; ", "constexpr int kShort = 128; ")],
    "empty": [("  const int tid = threadIdx.x, lane", "  if (R >= 0) return;\n"
               "  const int tid = threadIdx.x, lane")],
    "trace": [
        ("namespace {\n", "namespace {\n__device__ long long g_trace[64];\n"
                          "#define STAMP(i) if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x "
                          "== gridDim.x - 1)) g_trace[(blockIdx.x ? 16 : 0) + (i)] = clock64()\n"
                          "#define NOW(i) if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x "
                          "== gridDim.x - 1)) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
                          "\"=l\"(g_trace[(blockIdx.x ? 40 : 32) + (i)]))\n"),
        ("  const int gn = min(span, G - g0);\n",
         "  const int gn = min(span, G - g0);\n  STAMP(0); NOW(0);\n"),
        ("    if (!__syncthreads_or(any)) continue;",
         "    if (base == 0) STAMP(1);\n    if (!__syncthreads_or(any)) continue;\n"
         "    if (base == 0) STAMP(2);"),
        ("    // 2. sort: exclusive scan", "    if (base == 0) STAMP(3);\n    // 2. sort: exclusive scan"),
        ("    int at = inclusive - sum;", "    if (base == 0) STAMP(4);\n    int at = inclusive - sum;"),
        ("    // 3. sum:", "    if (base == 0) STAMP(6);\n    // 3. sum:"),
        ("  }\n\n#pragma unroll\n  for (int j = 0; j < kOut; ++j) {\n    const int t = own(j);",
         "  }\n  STAMP(7);\n\n#pragma unroll\n  for (int j = 0; j < kOut; ++j) {\n"
         "    const int t = own(j);"),
        ("acc[j]);\n  }\n}\n", "acc[j]);\n  }\n  STAMP(8); NOW(1);\n}\n"),
        ("      unsigned hot = __ballot_sync", "      if (base == 0 && j == 0) STAMP(9);\n"
                                                "      unsigned hot = __ballot_sync"),
        ('}  // extern "C"', "int segment_rows_trace(void* host) {\n  return static_cast<int>("
                             "cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));\n}\n\n"
                             '}  // extern "C"'),
    ],
}
DIAGNOSTIC = {"storeonly", "empty", "twice", "nosum"}


def variant_source(name):
    """The source of variant ``name``, written to the build directory."""
    s = open(CU).read()
    for part in (p for p in name.split("+") if p != "base"):
        for old, new in SUBS[part]:
            if old not in s:
                raise SystemExit(f"variant {part}: the source has no {old[:60]!r}")
            s = s.replace(old, new)
    path = os.path.join(OUT, f"segment_rows_{name.replace('+', '_')}.cu")
    with open(path, "w") as f:
        f.write(s)
    return path


def tool(name):
    path = os.path.join(CUDA_BIN, name)
    return path if os.path.exists(path) else name


def build(name):
    src = variant_source(name)
    so = src[:-3] + ".so"
    cmd = [tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, src]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    return name, so, p.returncode, time.perf_counter() - t0, p.stdout + p.stderr


def atomics_of(so):
    """``{opcode: count}`` of the atomic, local-memory and barrier
    instructions in the library's SASS."""
    try:
        p = subprocess.run([tool("cuobjdump"), "-sass", so], capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"error": str(e)}
    counts = {}
    for ln in p.stdout.splitlines():
        for word in ln.replace(";", " ").split():
            if word.startswith(("ATOMS", "ATOMG", "RED", "ATOM.", "LDL", "STL", "BAR.")):
                counts[word] = counts.get(word, 0) + 1
    return counts


def run(so, name):
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.kernels import ticket_hash as th

    lib = ctypes.CDLL(so)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.segment_rows_launch.argtypes = [ptr] * 3 + [ctypes.c_longlong, i32, i32, i32, ptr]
    lib.segment_rows_launch.restype = ctypes.c_int
    lib.segment_rows_error_string.argtypes = [ctypes.c_int]
    lib.segment_rows_error_string.restype = ctypes.c_char_p
    sr._LIB, sr._LAUNCHER = lib, lib.segment_rows_launch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    if not set(name.split("+")) & DIAGNOSTIC:
        try:
            err = cs.phase2_segment_rows(sr, th, gen, dev)
            print(f"cases: max|Δ|={err:.3g} ok", flush=True)
        except cs.SmokeFailure as e:
            print(f"cases: FAIL {e}", flush=True)
            ok = False
    res = {}
    for shape, rows_n in (("train", cs.TRAIN_BATCH * cs.TRAIN_SEQ), ("batch_16384", 8 * 2048)):
        _, tickets, _, _, mu, _ = cs.embed_tickets(th, dev, rows=rows_n, seed=1)
        d = 1024
        rows = torch.randn(mu, d, generator=gen, device=dev)
        idx = tickets.long()
        cases = {shape: tickets}
        if shape == "train":
            cases["train_distinct"] = torch.randperm(mu, generator=gen, device=dev).to(torch.int32)
        for case, tk in cases.items():
            call = lambda: sr.segment_rows(rows, tk, mu)  # noqa: E731
            res[case] = {"event": cs.time_cuda(call, 7), "graph": cs.time_graph(call),
                         "bound": 4 * (2 * mu * d + mu) / cs.HBM_BYTES_PER_S * 1e3}
        lib_call = lambda: torch.zeros(mu, d, device=dev).index_add_(0, idx, rows)  # noqa: E731
        res[shape].update(library_event=cs.time_cuda(lib_call, 7),
                          library_graph=cs.time_graph(lib_call))
    for case, r in res.items():
        print(f"time {case}: event {r['event']:.4f} graph {r['graph']:.4f} ms; bound "
              f"{r['bound']:.4f}" + (f"; zeros + index_add_ event {r['library_event']:.4f} "
                                     f"graph {r['library_graph']:.4f}"
                                     if "library_graph" in r else ""), flush=True)
    print("times " + json.dumps(res), flush=True)
    if hasattr(lib, "segment_rows_trace"):
        print_trace(lib, sr, th, cs, dev, gen)
    if name == "base":
        print_host(sr, th, cs, dev, gen)
    return 0 if ok else 1


def print_trace(lib, sr, th, cs, dev, gen):
    """Cycles between the stages of CTA 0 and of the last CTA (thread 0,
    the training shape's one round), and their start and end on the
    device's global timer."""
    import ctypes

    import torch

    _, tickets, _, _, mu, _ = cs.embed_tickets(th, dev, seed=1)
    rows = torch.randn(mu, 1024, generator=gen, device=dev)
    for _ in range(5):
        sr.segment_rows(rows, tickets, mu)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 64)()
    lib.segment_rows_trace.argtypes = [ctypes.c_void_p]
    lib.segment_rows_trace(ctypes.addressof(buf))
    stamps = ((1, "tickets in"), (2, "bins ready"), (3, "counted"), (4, "warp sums"),
              (6, "starts and staged"), (9, "first rows and ticket 0's short tail"),
              (7, "summed"), (8, "stored"))
    for cta, off in (("first", 0), ("last", 16)):
        t, prev, steps = buf[off:off + 16], 0, []
        for i, what in stamps:
            steps.append(f"{what} +{t[i] - t[prev]}")
            prev = i
        print(f"trace {cta} CTA (cycles): {', '.join(steps)}; whole {t[8] - t[0]}", flush=True)
    print(f"trace: last CTA starts {buf[40] - buf[32]} ns after the first, ends "
          f"{buf[41] - buf[33]} ns after it", flush=True)


def print_host(sr, th, cs, dev, gen, n=2000):
    """Host microseconds a call of the wrapper's pieces and of the library
    call, on the host clock over ``n`` calls."""
    import torch

    _, tickets, _, _, mu, _ = cs.embed_tickets(th, dev, seed=1)
    rows = torch.randn(mu, 1024, generator=gen, device=dev)
    out = torch.empty(mu, 1024, device=dev)
    idx = tickets.long()
    pieces = {
        "_check": lambda: sr._check(rows, tickets, mu),
        "torch.empty": lambda: torch.empty((mu, 1024), dtype=torch.float32, device=dev),
        "new_empty": lambda: rows.new_empty((mu, 1024)),
        "data_ptr x3": lambda: (rows.data_ptr(), tickets.data_ptr(), out.data_ptr()),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "_launch": lambda: sr._launch(rows, tickets, out, mu),
        "segment_rows": lambda: sr.segment_rows(rows, tickets, mu),
        "torch.zeros": lambda: torch.zeros(mu, 1024, device=dev),
        "zeros + index_add_": lambda: torch.zeros(mu, 1024, device=dev).index_add_(0, idx, rows),
    }
    got = {}
    for name, fn in pieces.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i % 200 == 199:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        got[name] = (time.perf_counter() - t0) / n * 1e6
    print("host us a call " + json.dumps({k: round(v, 2) for k, v in got.items()}), flush=True)


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--run":
        return run(sys.argv[2], sys.argv[3])
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
                        if "registers" in ln or "spill" in ln or "error" in ln), flush=True)
        if not brc:
            print(f"== sass {name}: {json.dumps(atomics_of(so))}", flush=True)
        rc |= bool(brc)
    for name, so, brc, secs, log in built:
        if brc:
            continue
        print(f"== run {name}", flush=True)
        try:
            p = subprocess.run([sys.executable, __file__, "--run", so, name], timeout=150)
            print(f"== run {name}: rc {p.returncode}", flush=True)
            rc |= p.returncode != 0 and not set(name.split("+")) & DIAGNOSTIC
        except subprocess.TimeoutExpired:
            print(f"== run {name}: timed out", flush=True)
            rc = 1
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
