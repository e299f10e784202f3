"""The port's kernel build cache (``repro_torch.kernels.build``): a library
is named by its source, the ``csrc`` headers that source includes and the
compiler flags, so an edited header rebuilds every kernel that includes
it.  No compiler is needed: these tests stop short of ``nvcc``."""
import pytest
import torch

from repro_torch.kernels import build

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)


def _sources(tmp_path):
    (tmp_path / "probe.cuh").write_text("// protocol v1\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "probe.cuh"\n__global__ void k() {}\n')
    return src


def test_digest_follows_included_headers_only(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = _sources(tmp_path)
    first = build._source_digest(src)
    assert build._source_digest(src) == first
    (tmp_path / "other.cuh").write_text("// edited, still not included\n")
    assert build._source_digest(src) == first
    (tmp_path / "probe.cuh").write_text("// protocol v2\n")
    assert build._source_digest(src) != first


def test_a_library_of_the_same_digest_loads_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "BUILD_INFO", {})

    def no_nvcc():
        raise RuntimeError("nvcc must not be called for a cached library")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    src = _sources(tmp_path)
    cached = tmp_path / "out" / f"libk-{build._source_digest(src)[:16]}.so"
    cached.parent.mkdir()
    cached.write_bytes(b"")
    assert build.build("k") == cached
    (tmp_path / "probe.cuh").write_text("// protocol v2\n")
    with pytest.raises(RuntimeError, match="must not be called"):
        build.build("k")  # an edited header asks for a rebuild


def test_both_table_kernels_include_the_shared_protocol():
    for name in ("fused_groupby", "ticket_hash"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "hash_probe.cuh"' in text, name
        assert "slot_hash(int" not in text, name  # no private copy of the protocol


def test_the_tile_protocol_is_shared_and_the_scan_kernel_has_its_own():
    header = (build.CSRC / "hash_probe.cuh").read_text()
    for helper in ("int block_scan(", "int claim_tickets(", "int dedupe_role(",
                   "int warp_append("):
        assert helper in header, helper
    for name in ("fused_groupby", "ticket_hash"):
        text = (build.CSRC / f"{name}.cu").read_text()
        for helper in ("int block_scan(", "int claim_tickets(", "int dedupe_role("):
            assert helper not in text, (name, helper)  # no private copy of the protocol
    fused = (build.CSRC / "fused_groupby.cu").read_text()
    assert "kTicketOnly" not in fused
    assert "scan_ticket_kernel(" in fused and "claim_tickets<T>(" in fused
