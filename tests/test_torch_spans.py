"""PyTorch port, the spans and host-sync counts of ``utils/spans.py`` on
the CPU (the eager route).

A small batch of the bench family (``lm_bench_family``: N = 5, the fused
LDLT kernel's plain version) through ``vsolve`` in chunks, with a cap on
evaluations that ends some lanes ``max_eval`` and so sends them to the
rescue's stage 0:

* inside a ``torch.profiler`` session the ``cannoles.`` spans appear,
  nested vsolve > chunk > run > init/outer > eager/check, and rescue >
  stage0 > run; with no session no span is made at all;
* the results are bit-equal with and without a session;
* the process-wide count of host syncs (``core.segments.counters()``)
  grows by the primary solver's ``host_syncs`` plus its siblings' plus the
  rescue's status reads; the all-false checks are at most the checks, per
  site; ``_warm_up`` leaves every counter where it found it;
* the matrix-free solver's checks count under ``check:matfree.<loop>``.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.core.solver import TENSOR_FIELDS  # noqa: E402
from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family  # noqa: E402
from cannoles_tpu_torch.utils import spans  # noqa: E402

B, CHUNK, CAP = 64, 16, 12


def _solver():
    pb = lm_bench_family(torch.float32, "cpu")
    return pb, tc.CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32)


def _vsolve(pb, solver):
    x0, d = lm_bench_batch(B, seed=3)
    return tc.vsolve(pb, x0, data_batch=d, solver=solver, max_iter=50, chunk_size=CHUNK, rescue=True,
                     max_eval=CAP)


def _spans(prof):
    """The session's ``cannoles.`` events: (name, start ns, end ns, args)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.kwinputs())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("cannoles.")]


def _parent(ev, evs):
    """The name of the innermost span that holds ``ev`` (None at the top)."""
    holders = [o for o in evs if o[1] <= ev[1] and ev[2] <= o[2] and o[2] - o[1] > ev[2] - ev[1]]
    return min(holders, key=lambda o: o[2] - o[1])[0] if holders else None


@pytest.fixture(scope="module")
def traced():
    """Two calls of one solver, the second inside a profiler session
    (recording the spans' args), with the counters around each."""
    from torch.profiler import ProfilerActivity, profile

    pb, solver = _solver()
    c0 = segments.counters()
    off = _vsolve(pb, solver)
    c1 = segments.counters()
    sibs = solver.__dict__.get("_rescue_siblings", {})
    syncs = solver.host_syncs + sum(s.host_syncs for s in sibs.values())
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        on = _vsolve(pb, solver)
    return dict(off=off, on=on, c0=c0, c1=c1, syncs=syncs, events=_spans(prof))


def test_spans_are_named_and_nested(traced):
    evs = traced["events"]
    names = {e[0] for e in evs}
    for name in ("cannoles.vsolve", "cannoles.chunk", "cannoles.run", "cannoles.init", "cannoles.outer",
                 "cannoles.eager", "cannoles.check", "cannoles.rescue", "cannoles.rescue.stage0",
                 "cannoles.host_read"):
        assert name in names, name
    assert {n for n in names if not n.startswith("cannoles.rescue")} <= {
        "cannoles.vsolve", "cannoles.chunk", "cannoles.run", "cannoles.init", "cannoles.outer",
        "cannoles.eager", "cannoles.check", "cannoles.host_read"}
    allowed = {
        "cannoles.vsolve": {None},
        "cannoles.chunk": {"cannoles.vsolve"},
        "cannoles.rescue": {"cannoles.vsolve"},
        "cannoles.rescue.stage0": {"cannoles.rescue"},
        "cannoles.rescue.stage1": {"cannoles.rescue"},
        "cannoles.rescue.stage2": {"cannoles.rescue"},
        "cannoles.host_read": {"cannoles.rescue"},
        "cannoles.run": {"cannoles.chunk", "cannoles.rescue.stage0", "cannoles.rescue.stage1",
                         "cannoles.rescue.stage2"},
        "cannoles.init": {"cannoles.run"},
        "cannoles.outer": {"cannoles.run"},
        "cannoles.eager": {"cannoles.init", "cannoles.outer"},
        "cannoles.check": {"cannoles.init", "cannoles.outer"},
    }
    for ev in evs:
        assert _parent(ev, evs) in allowed[ev[0]], (ev[0], _parent(ev, evs))
    vs = [e for e in evs if e[0] == "cannoles.vsolve"]
    assert len(vs) == 1 and vs[0][3]["B"] == B and vs[0][3]["chunk_size"] == CHUNK
    chunks = sorted(e[3]["k"] for e in evs if e[0] == "cannoles.chunk")
    assert chunks == list(range(B // CHUNK))
    stage0 = [e for e in evs if e[0] == "cannoles.rescue.stage0"]
    assert stage0 and all(e[3]["lanes"] > 0 for e in stage0)
    checks = [e for e in evs if e[0] == "cannoles.check"]
    assert all(e[3]["segment"] for e in checks)
    runs = [e[3] for e in evs if e[0] == "cannoles.run"]
    assert {r["route"] for r in runs} == {"eager"}
    assert sorted(r["B"] for r in runs)[:B // CHUNK] == [CHUNK] * (B // CHUNK)


def test_results_equal_with_and_without_a_session(traced):
    for f in TENSOR_FIELDS:
        a, b = getattr(traced["off"].states, f), getattr(traced["on"].states, f)
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=f)


def test_no_span_without_a_session(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    made = []

    class Stub:
        def __init__(self, *a):
            made.append(a[0])

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(spans, "_Range", Stub)
    pb, solver = _solver()
    _vsolve(pb, solver)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("cannoles.test", {"k": 1}):
            pass
    assert made == ["cannoles.test"]


def test_process_count_is_every_solvers_syncs(traced):
    c0, c1 = traced["c0"], traced["c1"]
    reads = c1.get(("host_syncs", "rescue.status"), 0) - c0.get(("host_syncs", "rescue.status"), 0)
    assert reads >= 2
    assert c1["host_syncs"] - c0["host_syncs"] == traced["syncs"] + reads
    lanes = c1[("rescue_lanes", "stage0")] - c0.get(("rescue_lanes", "stage0"), 0)
    assert lanes > 0
    for k, n in c1.items():
        if isinstance(k, tuple) and k[0] == "all_false":
            assert n <= c1[("host_syncs", k[1])], k
            assert k[1].startswith("check:")


def test_warm_up_leaves_the_counters():
    pb, solver = _solver()
    x0, d = lm_bench_batch(1, seed=5)
    data = torch.as_tensor(d, dtype=torch.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    lam0 = pb.y0.to(torch.float32).expand(1, pb.ncon)
    _vsolve(pb, solver)  # counts to put back
    before = segments.counters()
    solver._warm_up((x0, lam0, data), {})
    assert segments.counters() == before
    assert solver._warm


def test_matfree_checks_count_by_loop():
    pb = tc.nls_problem(lambda x: torch.stack([x[0] - 1.0, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                        device="cpu")
    s = tc.MatrixFreeSolver(pb)
    before = segments.counters()
    st = s.solve()
    after = segments.counters()
    assert st.status == "first_order"
    sites = {k[1]: n - before.get(k, 0) for k, n in after.items()
             if isinstance(k, tuple) and k[0] == "host_syncs" and n != before.get(k, 0)}
    assert sites and all(k.startswith("check:matfree.") for k in sites)
    assert sum(sites.values()) == s.host_syncs
