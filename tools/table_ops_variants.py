#!/usr/bin/env python3
"""The table ops' lookup and migration kernels (``csrc/table_ops.cu``) and
textual variants of them, each built and timed on the card.

    python3 tools/table_ops_variants.py [VARIANT ...]      (default: all)

A variant is the source with a few lines replaced:

- ``base``: the source as it is;
- ``tile1k`` / ``tile4k``: tiles of 1024 new slots on 128 threads / 4096
  on 512 threads (the source: 2048 on 256), 8 old slots a thread;
- ``rows1`` / ``rows2`` / ``rows8``: 1 / 2 / 8 rows a thread on lookup's
  probe path below 2^23 slots (the source: 4; 1 from there); ``large4``:
  4 rows a thread on every table;
- ``shared512``: 512 threads a CTA on lookup's shared-memory path (the
  source: 1024);
- ``nol1``: the probe path's home-slot loads with no L1 allocation
  (``ld.global.nc.L1::no_allocate``);
- diagnostics, which are not the function (their answers are not
  checked): ``tickonly`` (the probe path loads each row's ticket word and
  not its key word: one random sector a row instead of two, so on a table
  past the L2 the time a sector), ``noprobe`` (the shared-memory path
  copies the table and streams the rows but does not probe: its floor) and
  ``noplace`` (the tiled migration loads, clears and stores its tiles but
  places no key: its floor).

Each variant is compiled with ``nvcc -Xptxas -v`` (all at once), loaded
with ctypes and launched through its own C interface on the same inputs:
``chip_smoke``'s phase-4 chunks (seed 0: one 2^21-row main-path chunk a
class, each in a table of its class's capacity holding it) on each lookup
path that takes the table, and 2^21 keys migrated from 2^22 slots into
2^23 and 2^24, each timed by CUDA-graph replay (``chip_smoke.time_graph``)
twice.  The base variant's lookups are held to the plain version (equal)
and its migrations to ``table_map_discrepancies`` (0).  Also printed: the
graph time of ``Tensor.copy_`` of a chunk's 2^21 int32 keys (the bytes of
a lookup's rows, read and written once).  Prints one JSON line
``{variant: {case: [ms, ms]}}``.  Sources and libraries go to
``build/table_ops_variants/``.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)
OUT = os.path.join(ROOT, "build", "table_ops_variants")
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

TILE = "constexpr int kTile = 2048; "
TILE_THREADS = "constexpr int kTileThreads = 256;"
SUBS = {
    "base": [],
    "tile1k": [(TILE, "constexpr int kTile = 1024; "),
               (TILE_THREADS, "constexpr int kTileThreads = 128;")],
    "tile4k": [(TILE, "constexpr int kTile = 4096; "),
               (TILE_THREADS, "constexpr int kTileThreads = 512;")],
    "rows1": [("constexpr int kProbeRows = 4; ", "constexpr int kProbeRows = 1; ")],
    "rows2": [("constexpr int kProbeRows = 4; ", "constexpr int kProbeRows = 2; ")],
    "rows8": [("constexpr int kProbeRows = 4; ", "constexpr int kProbeRows = 8; ")],
    "large4": [("constexpr int kLargeSlots = 1 << 23;", "constexpr int kLargeSlots = 1 << 30;")],
    "shared512": [("constexpr int kSharedThreads = 1024;",
                   "constexpr int kSharedThreads = 512; ")],
    "nol1": [("      tick[r] = __ldg(ttks + slot[r]);\n      held[r] = __ldg(tkeys + slot[r]);",
              '      asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(tick[r])'
              ' : "l"(ttks + slot[r]));\n'
              '      asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(held[r])'
              ' : "l"(tkeys + slot[r]));')],
    "tickonly": [("      held[r] = __ldg(tkeys + slot[r]);", "      held[r] = key[r];")],
    "noprobe": [("          const int2 e = s_tab[slot];",
                 "          const int2 e = make_int2(key[r], 1);")],
    "noplace": [("    off[u] = t[u] > 0 ? slot_hash(k[u], mask2) - T0 : kNone;",
                 "    off[u] = t[u] > 0 && k[u] == 0x7ABCDEF1 ? slot_hash(k[u], mask2) - T0"
                 " : kNone;")],
}


def variant_source(name):
    """The source of variant ``name``: each replaced line must be there."""
    with open(os.path.join(CSRC, "table_ops.cu")) as f:
        src = f.read()
    for old, new in SUBS[name]:
        if old not in src:
            raise ValueError(f"variant {name}: {old!r} is not in table_ops.cu")
        src = src.replace(old, new)
    return src


def build_all(names):
    """Compile every variant at once; returns name → (library path, ptxas lines)."""
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        lib = os.path.join(OUT, f"lib{name}.so")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines() if "registers" in ln])
    return out


def load(lib):
    so = ctypes.CDLL(lib)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    so.table_lookup_launch.argtypes = [ptr, i64, ptr, ptr, i32, ptr, i32, ptr]
    so.table_lookup_launch.restype = i32
    so.table_migrate_launch.argtypes = [ptr, ptr, i64, ptr, ptr, i32, ptr, ptr, i32, ptr]
    so.table_migrate_launch.restype = i32
    return so


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.core import resize
    from repro_torch.core import ticketing as tk
    from repro_torch.core.hashing import table_capacity
    from repro_torch.kernels import table_ops as tops

    if not torch.cuda.is_available():
        print("table_ops_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(SUBS)
    built = build_all(names)
    for name, (_, ptxas) in built.items():
        print(name, "ptxas:", " | ".join(ptxas))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    src = tk.make_table(1 << 22, 1 << 21, device=dev)
    tops.get_or_insert(src, torch.randperm(1 << 24, generator=gen, device=dev)[:1 << 21]
                       .to(torch.int32))
    classes, _ = cs.phase4_chunks(torch.Generator(device=dev).manual_seed(0), dev)
    tables = {}
    for cls, (keys, g) in classes.items():
        k32 = cs.to_i32(keys)
        table = tk.make_table(table_capacity(g), g, device=dev)
        tops.get_or_insert(table, k32)
        tables[cls] = (table, k32, tk.lookup(table, k32))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    res = {}
    for _ in range(2):
        for name, (lib, _) in built.items():
            so, r = load(lib), res.setdefault(name, {})
            for ratio in (2, 4):
                c2 = ratio << 22
                nk = torch.empty(c2, dtype=torch.int32, device=dev)
                nt = torch.empty_like(nk)
                aux = torch.zeros(2, dtype=torch.int32, device=dev)
                ovf = torch.empty(1 << 22, dtype=torch.int32, device=dev)
                call = lambda: so.table_migrate_launch(  # noqa: E731
                    src.keys.data_ptr(), src.tickets.data_ptr(), 1 << 22, nk.data_ptr(),
                    nt.data_ptr(), c2, aux.data_ptr(), ovf.data_ptr(), 1, stream())
                assert call() == 0
                r.setdefault(f"migrate_x{ratio}", []).append(cs.time_graph(call, calls=5))
                if name == "base" and len(r[f"migrate_x{ratio}"]) == 1:
                    got = tk.TicketTable(nk, nt, src.key_by_ticket, src.count, src.overflowed)
                    bad = tops.table_map_discrepancies(got, resize.migrate(src, c2))
                    cs.check(bad == 0, f"base migrate x{ratio}: {bad} discrepancies")
            for cls, (table, k32, want) in tables.items():
                o = torch.empty_like(k32)
                for path, mode in (("shared", 0), ("probe", 1)):
                    if mode == 0 and table.capacity > 1 << 14:
                        continue
                    call = lambda: so.table_lookup_launch(  # noqa: E731
                        k32.data_ptr(), k32.numel(), table.keys.data_ptr(),
                        table.tickets.data_ptr(), table.capacity, o.data_ptr(), mode, stream())
                    assert call() == 0
                    r.setdefault(f"lookup_{cls}_{path}", []).append(cs.time_graph(call))
                    if name == "base":
                        cs.check(torch.equal(o, want), f"base lookup {cls} {path}: differs")
    keys = tables["low"][1]
    o = torch.empty_like(keys)
    res["copy_"] = {"chunk": [cs.time_graph(lambda: o.copy_(keys)) for _ in range(2)]}
    print(json.dumps({name: {case: [round(t, 4) for t in ts] for case, ts in r.items()}
                      for name, r in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
