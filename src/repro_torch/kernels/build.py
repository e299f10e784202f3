"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface (no PyTorch
headers), so ``nvcc`` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The library lands in ``build/repro_torch/`` at the repository root (listed
in ``.gitignore``), named by a hash of the source, the ``csrc/*.cuh``
headers it includes and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.  A missing
``nvcc`` or a failed build raises: no kernel wrapper falls back to its
plain version when it holds a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name → {"cmd", "seconds", "ptxas", "path"} of the build this process did
# or found; name → loaded library.
BUILD_INFO: dict = {}
_LIBS: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch build from source at first use"
        )
    return nvcc


def _ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def _source_digest(src: Path) -> str:
    """sha256 of the source, the ``csrc`` headers it includes and the flags."""
    text = src.read_bytes()
    digest = hashlib.sha256(text)
    for header in re.findall(rb'^#include "([^"]+)"', text, flags=re.M):
        digest.update((CSRC / header.decode()).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into the build directory unless a library
    of the same source, headers and flags is already there.  Returns its
    path."""
    src = CSRC / f"{name}.cu"
    digest = _source_digest(src)
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, {"cmd": None, "seconds": 0.0,
                                     "ptxas": [], "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO[name] = {
        "cmd": " ".join(cmd), "seconds": seconds,
        "ptxas": _ptxas_lines(proc.stdout + proc.stderr), "path": str(out),
    }
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
