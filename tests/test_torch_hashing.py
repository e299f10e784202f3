"""repro_torch hashing, key canonicalization and event layout vs the JAX
reference: every hash bit for bit (uint32 values read back from the
port's int64 results; int32 key bit patterns compared as uint32)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashing as jh
from repro.engine import columns as jcol
from repro.engine import morsels as jmor
from repro.kernels.ticket_hash import _slot_hash_i32
from repro.obs import metrics as jmet
from repro_torch.core import hashing as th
from repro_torch.engine import columns as tcol
from repro_torch.engine import morsels as tmor
from repro_torch.obs import metrics as tmet

# One intra-op thread: the suite's xdist workers share the cores, and a pool
# per worker of torch's default size oversubscribes them many times over.
torch.set_num_threads(1)

SPECIALS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE], dtype=np.uint32)


def _keys(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([SPECIALS, rng.integers(0, 1 << 32, size=n, dtype=np.uint32)])


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy → the port's int32 bit pattern."""
    return torch.from_numpy(a.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_murmur3_fmix32_bit_exact(seed):
    k = _keys(seed)
    assert np.array_equal(_u32(th.murmur3_fmix32(_t(k))),
                          np.asarray(jh.murmur3_fmix32(jnp.asarray(k))))


@pytest.mark.parametrize("seed", [0, 3, 123457])
def test_xxhash32_mix_bit_exact(seed):
    k = _keys(seed)
    assert np.array_equal(_u32(th.xxhash32_mix(_t(k), seed=seed)),
                          np.asarray(jh.xxhash32_mix(jnp.asarray(k), seed=seed)))


@pytest.mark.parametrize("size,seed", [(16, 0), (1024, 0), (1 << 20, 0), (4096, 13)])
def test_slot_hash_bit_exact(size, seed):
    k = _keys(size)
    got = th.slot_hash(_t(k), size, seed=seed).numpy()
    want = np.asarray(jh.slot_hash(jnp.asarray(k), size, seed=seed))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("capacity", [16, 2048, 1 << 22])
def test_slot_hash_i32_matches_kernel_hash(capacity):
    k = _keys(capacity).view(np.int32)
    got = th.slot_hash_i32(torch.from_numpy(k.copy()), capacity).numpy()
    want = np.asarray(_slot_hash_i32(jnp.asarray(k), capacity))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("parts", [1, 4, 6, 7, 12, 64])
def test_partition_hash_bit_exact(parts):
    k = _keys(parts)
    got = th.partition_hash(_t(k), parts, seed=5).numpy()
    want = np.asarray(jh.partition_hash(jnp.asarray(k), parts, seed=5))
    assert np.array_equal(got, want)


def test_fingerprint_bit_exact():
    k = _keys(7)
    assert np.array_equal(_u32(th.fingerprint(_t(k))),
                          np.asarray(jh.fingerprint(jnp.asarray(k))))


@pytest.mark.parametrize("max_groups,lf", [(0, 0.5), (1, 0.5), (7, 0.5), (1000, 0.5),
                                           (1 << 20, 0.5), (1677721, 0.5),
                                           (300, 0.75), (4096, 1.0)])
def test_table_capacity_matches(max_groups, lf):
    assert th.table_capacity(max_groups, lf) == jh.table_capacity(max_groups, lf)


def test_hash_accepts_int64_and_uint32_inputs():
    k = _keys(9)
    want = np.asarray(jh.slot_hash(jnp.asarray(k), 1 << 16))
    for t in (torch.from_numpy(k.astype(np.int64)), torch.from_numpy(k.copy())):
        assert np.array_equal(th.slot_hash(t, 1 << 16).numpy(), want)


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_combine_keys_bit_exact(ncols):
    rng = np.random.default_rng(ncols)
    cols = [rng.integers(0, 1 << 32, size=2048, dtype=np.uint32) for _ in range(ncols)]
    cols[0][:5] = SPECIALS
    want = np.asarray(jcol.combine_keys(*(jnp.asarray(c) for c in cols)))
    got = tcol.combine_keys(*(_t(c) for c in cols))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_combine_keys_keeps_the_sentinel_free():
    # find a column value whose single-column combine hits EMPTY_KEY: the
    # remap must agree with the reference (0x7FFFFFFF)
    got = tcol.combine_keys(torch.arange(1 << 16, dtype=torch.int64))
    assert not bool((got == th.EMPTY_I32).any())


@pytest.mark.parametrize("raw", [True, False])
def test_chunk_key_column_with_mask(raw):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 500, size=1000).astype(np.uint32)
    b = rng.integers(0, 7, size=1000).astype(np.uint32)
    mask = rng.random(1000) < 0.7
    names = ("a",) if raw else ("a", "b")
    jk, _ = jcol.chunk_key_column(
        jcol.Table({"a": jnp.asarray(a), "b": jnp.asarray(b), "__mask__": jnp.asarray(mask)}),
        names, raw,
    )
    tk_, cols = tcol.chunk_key_column(
        tcol.Table({"a": torch.from_numpy(a.astype(np.int64)), "b": _t(b),
                    "__mask__": torch.from_numpy(mask)}),
        names, raw,
    )
    assert "__mask__" not in cols
    assert np.array_equal(tk_.numpy().view(np.uint32), np.asarray(jk))


@pytest.mark.parametrize("n,morsel", [(1000, 256), (1024, 256), (1, 512)])
def test_morselize_chunk_matches(n, morsel):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 100, size=n).astype(np.uint32)
    v = rng.normal(size=n).astype(np.float32)
    jkm, jvm, jnum = jmor.morselize_chunk(jnp.asarray(k), {"v": jnp.asarray(v)}, morsel)
    tkm, tvm, tnum = tmor.morselize_chunk(_t(k), {"v": torch.from_numpy(v)}, morsel)
    assert jnum == tnum
    assert np.array_equal(tkm.numpy().view(np.uint32), np.asarray(jkm))
    assert np.array_equal(tvm["v"].numpy(), np.asarray(jvm["v"]))


def test_event_vector_layout_matches():
    for name in ("EVT_MORSELS", "EVT_ROWS", "EVT_ROWS_MASKED", "EVT_PROBE_STEPS",
                 "EVT_PROBE_SATURATIONS", "EVT_PAUSES", "NUM_EVENTS",
                 "PROBE_HIST_EDGES", "PROBE_HIST_BUCKETS", "EVENT_VEC_LEN",
                 "EVENT_NAMES", "PROBE_HIST_LABELS"):
        assert getattr(tmet, name) == getattr(jmet, name), name
    assert tmet.EVENT_VEC_LEN == 14
    vec = np.arange(14, dtype=np.int32)
    assert tmet.event_vector_to_dict(torch.from_numpy(vec)) == jmet.event_vector_to_dict(vec)
    assert tmet.zero_event_vector().tolist() == [0] * 14


def test_event_publisher_is_delta_based():
    tmet.clear()
    tmet.enable()
    try:
        pub = tmet.EventPublisher(strategy="fused")
        pub.publish({"groupby.rows": 10, "groupby.probe_len": [1] * 8})
        pub.publish({"groupby.rows": 15, "groupby.probe_len": [2] * 8})
        snap = tmet.snapshot()
        assert snap["counters"]["groupby.rows"]["strategy=fused"] == 15
        assert snap["histograms"]["groupby.probe_len"]["strategy=fused"]["counts"] == [2] * 8
    finally:
        tmet.disable()
        tmet.clear()



def test_lookup_of_an_absent_key_on_a_full_table_returns_minus_one():
    """No empty slot stops the probe on a full table: ``lookup`` bounds it
    at ``capacity`` slots.  Run in a thread under a time limit of its own,
    so that an unbounded probe fails the test instead of hanging it."""
    import threading

    from repro_torch.core import ticketing as ttk

    cap = 64
    present = _t(np.arange(1, cap + 1, dtype=np.uint32) * np.uint32(2654435761))
    tickets, table = ttk.get_or_insert(ttk.make_table(cap, device="cpu"), present)
    assert int(table.count) == cap and bool((table.tickets != 0).all())
    absent = 7
    assert absent not in present.tolist()
    probe = torch.cat([present[[5, 0]], torch.tensor([absent, ttk.EMPTY_I32], dtype=torch.int32)])
    out = {}
    worker = threading.Thread(target=lambda: out.update(got=ttk.lookup(table, probe)),
                              daemon=True)
    worker.start()
    worker.join(timeout=10.0)
    assert not worker.is_alive(), "lookup did not end on a full table"
    assert out["got"].tolist() == [int(tickets[5]), int(tickets[0]), -1, -1]
