"""The graph route's store into the bank's buffers (``core/segments._store``
through ``ops/bank_copy.py``) with CPU tensors: the plan's decisions (what
folds, the per-launch cap, the one-block path and the staging of aliased
sources), checked by running each planned launch as the kernel does it
(``_run_plan``), and the plain version, which ``store`` runs on the CPU.
The kernel itself is compared with the plain version on the card
(``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.ops import bank_copy  # noqa: E402
from cannoles_tpu_torch.utils.testing import copy_expected, copy_layout, copy_pairs  # noqa: E402


def _bank(**entries):
    bank = segments.Bank("graph", "test")
    segments.load(bank, **entries)
    return bank


def _deltas(fn):
    """(launches, entries, left) that ``fn()`` adds to the counters."""
    c0 = segments.counters()
    fn()
    c1 = segments.counters()
    return tuple(c1[k] - c0[k] for k in ("bank_copy", ("bank_copy", "entries"), ("bank_copy", "left")))


def _run_plan(pairs):
    """Run ``bank_copy.plan``'s launches on the CPU as the kernel runs them
    on a card, then the pairs left as ``store`` does: a one-block launch
    reads every source before it writes any destination; a grid launch
    copies in any order, so none of its sources may share storage with its
    destinations.  Returns the launches as (one_block, entries) and the
    number of pairs left."""
    written = {bank_copy._storage(d) for d, _ in pairs}
    launches, left = bank_copy.plan(pairs, written)
    left = [(d, s.clone() if bank_copy._storage(s) in written else s) for d, s in left]
    for one_block, items in launches:
        assert len(items) <= bank_copy.CAP
        if one_block:
            assert sum(bank_copy._padded(d.nbytes) for d, _ in items) <= bank_copy.STAGE_BYTES
            items = [(d, s.clone()) for d, s in items]
        else:
            dst = {bank_copy._storage(d) for d, _ in items}
            assert not any(bank_copy._storage(s) in dst for _, s in items)
        for d, s in items:
            d.copy_(s)
    for d, s in left:
        d.copy_(s)
    return [(one, len(items)) for one, items in launches], len(left)


def _swap(n):
    """A bank of four float64 entries of about n elements, and a store in
    which two entries swap their buffers, one reads its own buffer and one
    a shifted view of another's; with the values each must end with."""
    g = torch.Generator().manual_seed(n)
    x, y, w = (torch.randn(n, generator=g, dtype=torch.float64) for _ in range(3))
    z = torch.randn(n + 1, generator=g, dtype=torch.float64)
    bank = _bank(x=x.clone(), y=y.clone(), z=z.clone(), w=w.clone())
    upd = {"x": bank.y, "y": bank.x, "z": -bank.z, "w": bank.z[1:]}
    return bank, upd, dict(x=y, y=x, z=-z, w=z[1:])


@pytest.mark.parametrize("n", [4, 4096], ids=["one_block", "staged"])
def test_aliased_sources_give_their_values_from_before_the_store(n):
    """Each entry gets its source's value from before the store, through
    ``_store`` (the plain version) and through the plan: one one-block
    launch for 4 floats each, and for 4,096 doubles (above ``STAGE_BYTES``)
    one launch that stages the aliased sources and one that copies."""
    bank, upd, want = _swap(n)
    kept = dict(bank.__dict__)
    assert _deltas(lambda: segments._store(bank, upd)) == (0, 0, 0)
    assert all(bank.__dict__[k] is kept[k] for k in "xyzw")
    assert all(torch.equal(bank.__dict__[k], v) for k, v in want.items())
    bank, upd, want = _swap(n)
    pairs = [(bank.__dict__[k], v) for k, v in upd.items()]
    launches, left = _run_plan(pairs)
    assert all(torch.equal(bank.__dict__[k], v) for k, v in want.items())
    assert left == 0 and launches == {4: [(True, 4)], 4096: [(False, 3), (False, 4)]}[n]


def test_strided_and_converting_pairs_are_left_to_copy():
    """A transposed source and a float32 source into a float64 buffer stay
    on ``copy_``; the contiguous pair of one dtype folds."""
    a = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    for run in ("store", "plan"):
        bank = _bank(m=torch.zeros(4, 3, dtype=torch.float64), f=torch.zeros(5, dtype=torch.float64),
                     k=torch.zeros(2, dtype=torch.int32))
        src = dict(m=a.T, f=torch.linspace(0, 1, 5, dtype=torch.float32),
                   k=torch.tensor([7, 8], dtype=torch.int32))
        assert not src["m"].is_contiguous()
        if run == "store":
            segments._store(bank, src)
        else:
            assert _run_plan([(bank.__dict__[k], v) for k, v in src.items()]) == ([(True, 1)], 2)
        assert torch.equal(bank.m, a.T) and torch.equal(bank.f, src["f"].double())
        assert torch.equal(bank.k, src["k"])


def test_pairs_above_the_size_cut_are_left_to_copy():
    """A pair one byte above ``CUT_BYTES`` stays on ``copy_``; one at the cut
    folds (above ``STAGE_BYTES``, so the grid path)."""
    n = bank_copy.CUT_BYTES
    big, edge = torch.zeros(n + 1, dtype=torch.uint8), torch.zeros(n, dtype=torch.uint8)
    src = (torch.full((n + 1,), 3, dtype=torch.uint8), torch.full((n,), 5, dtype=torch.uint8))
    assert _run_plan([(big, src[0]), (edge, src[1])]) == ([(False, 1)], 1)
    assert torch.equal(big, src[0]) and torch.equal(edge, src[1])


def test_stores_beyond_the_cap_take_more_launches():
    """``CAP`` + 5 small entries take two launches of the grid path (``CAP``
    and 5 entries); with each source another entry's buffer, one launch of
    ``CAP`` and one of 5 stage them first."""
    n = bank_copy.CAP + 5
    bank = _bank(**{f"e{k}": torch.full((3,), float(k)) for k in range(n)})
    new = {f"e{k}": torch.full((3,), float(-k)) for k in range(n)}
    launches = [(False, bank_copy.CAP), (False, 5)]
    assert _run_plan([(getattr(bank, k), v) for k, v in new.items()]) == (launches, 0)
    assert all(torch.equal(getattr(bank, k), v) for k, v in new.items())
    pairs = [(getattr(bank, f"e{k}"), getattr(bank, f"e{(k + 1) % n}")) for k in range(n)]
    assert _run_plan(pairs) == (2 * launches, 0)
    assert all(torch.equal(getattr(bank, f"e{k}"), new[f"e{(k + 1) % n}"]) for k in range(n))


def test_every_pair_is_folded_or_left_once():
    """The plan folds each contiguous pair of one dtype and leaves each
    other, once; a zero-byte pair folds with no launch of its own.  On the
    CPU ``_store`` runs the plain version, which counts nothing, and the
    buffers keep their tensors."""
    bank = _bank(a=torch.zeros(3), c=torch.zeros(2, 2), d=torch.zeros(3, dtype=torch.float64))
    kept = dict(bank.__dict__)
    upd = dict(a=torch.ones(3), c=torch.ones(2, 3)[:, :2], d=torch.ones(3))
    pairs = [(bank.__dict__[k], v) for k, v in upd.items()]
    launches, left = bank_copy.plan(pairs, {bank_copy._storage(d) for d, _ in pairs})
    assert [len(items) for _, items in launches] == [1] and launches[0][1][0][0] is bank.a
    assert [d for d, _ in left] == [bank.c, bank.d]
    assert _deltas(lambda: segments._store(bank, upd)) == (0, 0, 0)
    assert all(bank.__dict__[k] is kept[k] for k in "acd")
    assert torch.equal(bank.c, torch.ones(2, 2)) and torch.equal(bank.d, torch.ones(3, dtype=torch.float64))
    empty = [(torch.zeros(0), torch.ones(0))]
    assert bank_copy.plan(empty, set()) == ([], [])
    assert _deltas(lambda: bank_copy.store(empty)) == (0, 0, 0)


def test_the_eager_route_copies_nothing():
    """On the eager route ``load`` replaces the entries: no store, no count."""
    bank = segments.Bank("eager", "test")
    x = torch.ones(3)
    assert _deltas(lambda: segments.load(bank, x=x)) == (0, 0, 0)
    assert bank.x is x


@pytest.mark.parametrize("delta", [
    {"fused_ldlt": 3, "chol_fused": 1, "chol_block": 2},
    {("fused_ldlt", (5, 16384)): 4},
    {"bank_copy": 2, ("bank_copy", "entries"): 75, ("bank_copy", "left"): 3},
    {"obs_products": 5, ("obs_products", "jtw"): 5},
    {"obs_blocks": 3, ("obs_blocks", "calls"): 3},
    {"schur_pairs": 2},
    {("host_syncs", "check:test.segment"): 2, "host_syncs": 2},
    {("all_false", "check:test.segment"): 1},
    {("rescue_lanes", "test.stage"): 7},
    {("schur", "assemble"): 2, ("schur", "pairs"): 90},
], ids=["launches", "by_shape", "bank_copy", "obs_products", "obs_blocks", "schur_pairs", "host_syncs", "all_false",
        "rescue_lanes", "schur"])
def test_the_counters_add_up_and_restore(delta):
    """A replayed graph's counts (``_capture``'s delta, the derived
    ``"host_syncs"`` included) add to every kind of key, and
    ``restore_counters`` puts them back with the others."""
    before = segments.counters()
    segments._credit(delta)
    after = segments.counters()
    assert {k: after[k] - before.get(k, 0) for k in delta} == delta
    assert {k: n for k, n in after.items() if n != before.get(k, 0)}.keys() == delta.keys()
    segments.restore_counters(before)
    assert segments.counters() == before


@pytest.mark.parametrize("seed,n,max_numel", [(0, 20, 8), (1, 60, 40), (2, 150, 30), (3, 40, 3000)],
                         ids=["tiny", "one_block", "above_cap", "staged"])
def test_random_stores_give_every_destination_its_source(seed, n, max_numel):
    """Random stores (``utils.testing.copy_layout``: six dtypes, offsets
    off 16-byte alignment, sources overlapping destinations, strided
    sources): every destination holds its source's bytes from before the
    store, through the plan (on the one-block path, above the cap and on the
    staged path) and through the plain version."""
    pool, other, entries = copy_layout(seed, n, max_numel)
    want = copy_expected(entries, pool, other)
    for run in ("plan", "store"):
        tp, to = torch.from_numpy(pool.copy()), torch.from_numpy(other.copy())
        pairs = copy_pairs(entries, tp, to)
        if run == "plan":
            launches, left = _run_plan(pairs)
            assert left == sum(e[5] == 2 and e[1] > 1 for e in entries) and launches
        else:
            bank_copy.store(pairs)
        assert np.array_equal(tp.numpy(), want) and np.array_equal(to.numpy(), other)
