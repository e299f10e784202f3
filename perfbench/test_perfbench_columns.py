"""The column generators' distributions at small sizes, on the CPU."""
import torch

from perfbench import harness
from perfbench.spec import load_cell


def _make(kind, spec, rows, seed=2**31 + 11):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(harness.column_seed(seed, "c"))
    return harness._load("columns", kind).make(spec, rows, gen, "cpu")


def test_dense_keys_are_every_rank_below_distinct():
    keys = _make("dense_keys", {"distinct": 5000}, 200_000)
    assert keys.dtype == torch.int32
    # 200k draws over 5000 ranks: every rank seen, none outside [0, 5000)
    assert torch.unique(keys).tolist() == list(range(5000))


def test_dense_keys_are_uniform():
    keys = _make("dense_keys", {"distinct": 10}, 100_000)
    counts = torch.bincount(keys, minlength=10)
    assert counts.numel() == 10 and int(counts.min()) > 9500 and int(counts.max()) < 10500


def test_uniform_f64_rounds_to_its_decimals():
    v = _make("uniform_f64", {"low": 0.0, "high": 100.0, "decimals": 6}, 50_000)
    assert v.dtype == torch.float64 and float(v.min()) >= 0 and float(v.max()) <= 100
    micro = v * 1e6
    assert float((micro - micro.round()).abs().max()) < 1e-6
    # not rounded further: most values use the sixth decimal
    assert float(((micro.round() % 10) != 0).double().mean()) > 0.85


def test_same_seed_same_columns_other_seed_other_columns():
    a = _make("uniform_int", {"low": 1, "high": 5}, 1000, seed=7)
    b = _make("uniform_int", {"low": 1, "high": 5}, 1000, seed=7)
    c = _make("uniform_int", {"low": 1, "high": 5}, 1000, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_h2o_ranges():
    cell = load_cell("h2o_G1_1e8_1e2.q5").resized(50_000, id6={"high": 500},
                                                   id3={"high": 500})
    cols = harness.make_columns(cell, 2**31 + 5, "cpu")
    assert set(cols) == {"id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"}
    for c, k in (("id1", 100), ("id2", 100), ("id3", 500), ("id4", 100), ("id5", 100),
                 ("id6", 500), ("v1", 5), ("v2", 15)):
        assert cols[c].dtype == torch.int32
        assert torch.unique(cols[c]).tolist() == list(range(1, k + 1)), c
    v3 = cols["v3"]
    assert v3.dtype == torch.float64 and float(v3.min()) >= 0 and float(v3.max()) <= 100
    assert abs(float(v3.mean()) - 50) < 1
    # each column from its own seed: two id columns of one range differ
    assert not torch.equal(cols["id1"], cols["id2"])


def test_paper41_distinct_share():
    cell = load_cell("paper41_high.uniform").resized(1 << 16, k={"distinct": 6553})
    cols = harness.make_columns(cell, 3, "cpu")
    n = torch.unique(cols["k"]).numel()
    # 2^16 draws over 6553 ranks: all but ≈ e^-10 of them appear
    assert 6500 <= n <= 6553
