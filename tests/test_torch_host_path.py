"""PyTorch port, the host path of a solve against the JAX package in
float64 on the CPU: the evaluators built once and called unbatched at
B = 1 (traced on the CPU), the weighted Hessians, the solver's host
checks, its segments (the in-place bank of the graph route), the warm-up
before the clock, and
``cannoles_tpu_torch.profile_ba_rung``.

The problems: ``biggs_exp6_24`` (the battery's slowest row), example 01's
constrained Rosenbrock (``examples/torch_01_basics.py``) and a
bundle-adjustment scene of 3 cameras and 16 points (data carried in the
problem, the BA rung's family).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cannoles_tpu as jc  # noqa: E402
from cannoles_tpu.models.families import bundle_adjustment as jba  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch import battery  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.models import chained_rosenbrock  # noqa: E402
from cannoles_tpu_torch.models.families import bundle_adjustment as tba  # noqa: E402
from cannoles_tpu_torch.models.families import bundle_adjustment_batch  # noqa: E402
from cannoles_tpu_torch.ops.cgls import cgls  # noqa: E402


def _jax_items():
    """``benchmarks/full_battery.py``'s problems (the JAX runner's list)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "full_battery.py"
    spec = importlib.util.spec_from_file_location("full_battery_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.collect()


JAX_ITEMS = _jax_items()
NAMES = ("biggs_exp6_24", "example01", "ba_3x16")


def _ex01_jax():
    return jc.nls_problem(
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), jnp.array([-1.2, 1.0]), 2,
        lambda x: jnp.array([x[0] + x[1]]), [1.0], [1.0],
    )


def _ex01_torch():
    return tc.nls_problem(
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
        cons=lambda x: (x[0] + x[1]).reshape(1), lcon=[1.0], ucon=[1.0], device="cpu",
    )


def _pair(name):
    """(JAX problem, port problem, the solver's keywords in both)."""
    if name == "example01":
        return _ex01_jax(), _ex01_torch(), dict(method="gauss_newton", kkt="condensed")
    if name == "ba_3x16":
        return jba(3, 16, seed=0)[0], tba(3, 16, seed=0, device="cpu")[0], dict(
            method="gauss_newton", kkt="condensed")
    jmake = next(it[2] for it in JAX_ITEMS if it[1] == name)
    tmake = next(it[2] for it in battery.collect() if it[1] == name)
    return jmake(), tmake(dtype=torch.float64, device="cpu"), dict(linsolve="ldlt")


def _points(pb, B, seed):
    rng = np.random.default_rng(seed)
    return pb.x0[None] + 0.05 * torch.as_tensor(rng.normal(size=(B, pb.nvar)))


@pytest.mark.parametrize("name", NAMES)
def test_b1_evaluators_equal_the_batch_lane_0(name):
    """At B = 1 every evaluator calls the unbatched function on lane 0; its
    outputs equal lane 0 of a B = 5 call (vmap) to 1e-15 of the largest
    entry: bit for bit on the elementwise residuals, within an ulp where
    the BA projection's matmuls sum in another order unbatched (measured
    9e-17)."""
    if name == "ba_3x16":
        pb, X, data, _ = bundle_adjustment_batch(5, 3, 16, dtype=torch.float64, device="cpu")
        lane0 = {k: v[:1] for k, v in data.items()}
    else:
        pb = _pair(name)[1]
        X, data, lane0 = _points(pb, 5, 1), None, None
    rng = np.random.default_rng(2)
    R = torch.as_tensor(rng.normal(size=(5, pb.nequ)))
    Y = torch.as_tensor(rng.normal(size=(5, pb.ncon)))
    evals = {
        "F": lambda x, d, r, y: pb.F(x, d),
        "c": lambda x, d, r, y: pb.c_shifted(x, d),
        "Jt": lambda x, d, r, y: pb.Jt(x, d),
        "F_and_Jt": lambda x, d, r, y: torch.cat([pb.F_and_Jt(x, d)[0][:, None, :], pb.F_and_Jt(x, d)[1]], 1),
        "Jc": lambda x, d, r, y: pb.Jc(x, d),
        "hess_res": lambda x, d, r, y: pb.hess_res(x, r, d),
        "hess_cons": lambda x, d, r, y: pb.hess_cons(x, y, d),
    }
    for key, f in evals.items():
        one = f(X[:1], lane0, R[:1], Y[:1])
        many = f(X, data, R, Y)
        assert one.shape == many[:1].shape, key
        scale = float(many[0].abs().max()) if many.numel() else 1.0
        np.testing.assert_allclose(one[0].numpy(), many[0].numpy(), rtol=0, atol=1e-15 * max(scale, 1e-300),
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", NAMES + ("hs27",))
def test_weighted_hessians_equal_jax(name):
    """Σ rᵢ∇²Fᵢ and Σ yᵢ∇²cᵢ (``hess_res``/``hess_cons``, built once, at
    B = 1) equal the JAX package's ``jax.hessian`` at the same x, r, y to
    1e-12 relative to the largest entry (hs27's constraint is nonlinear)."""
    pj, pt, _ = _pair(name)
    rng = np.random.default_rng(3)
    x = _points(pt, 1, 4)
    r = rng.normal(size=pt.nequ)
    y = rng.normal(size=pt.ncon)
    tdata = None if pt.data is None else {k: v[None] for k, v in pt.data.items()}
    got = {
        "res": pt.hess_res(x, torch.as_tensor(r)[None], tdata)[0].numpy(),
        "cons": pt.hess_cons(x, torch.as_tensor(y)[None], tdata)[0].numpy(),
    }
    xj = jnp.asarray(x[0].numpy())
    want = {"res": np.asarray(pj.hess_res(xj, jnp.asarray(r), pj.data))}
    want["cons"] = (np.asarray(pj.hess_cons(xj, jnp.asarray(y), pj.data)) if pt.ncon
                    else np.zeros((pt.nvar, pt.nvar)))
    for key in got:
        scale = max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12 * scale, err_msg=f"{name} {key}")


def _counters(st):
    ss = st.solver_specific
    return st.status, st.iter, ss["nfact"], ss["nlinsolve"], ss["nbk"]


@pytest.mark.parametrize("name", NAMES)
def test_b1_solve_keeps_jax_counters(name):
    """A B = 1 solve keeps the JAX package's status and counters, and its
    solution within 1e-10: ``biggs_exp6_24`` through its first 41 outer
    iterations (its whole solve takes 902, minutes on one CPU thread),
    example 01's problem from its three starts (the last one to a cap of
    2,000 evaluations), the BA scene to its end."""
    pj, pt, kw = _pair(name)
    runs = {
        "biggs_exp6_24": [dict(atol=0.0, rtol=1e-5, max_iter=40)],
        "example01": [dict(x0=[0.0, 0.0]), dict(x0=[3.0, -2.0]), dict(x0=[-5.0, 5.0], max_eval=2000)],
        "ba_3x16": [dict(atol=0.0, rtol=1e-5, max_iter=40)],
    }[name]
    js, ts = jc.CaNNOLeSSolver(pj, **kw), tc.CaNNOLeSSolver(pt, **kw)
    for run in runs:
        x0 = run.pop("x0", None)
        a = js.solve(x0=None if x0 is None else jnp.asarray(x0), max_time=600.0, **run)
        b = ts.solve(x0=None if x0 is None else torch.tensor(x0, dtype=torch.float64), max_time=600.0, **run)
        assert _counters(b) == _counters(a), (name, x0, _counters(a), _counters(b))
        xa = np.asarray(a.solution)
        np.testing.assert_allclose(b.solution, xa, rtol=0, atol=1e-10 * max(1.0, np.abs(xa).max()))


# host checks of whole solves, pinned so that no change can raise them
# unseen.  Per inner iteration: one after each ρ attempt, one after the
# trial point and each backtracking trip, and the loop's test; per outer
# iteration one more before the inner loop and one after the bookkeeping.
# Before the segments the same solves took 85 and 233 (a check for the
# solve guard, one for the trial guard and one before the first attempt).
PINNED_CHECKS = {"chained_rosenbrock": 58, "beale": 166}


@pytest.mark.parametrize("name", sorted(PINNED_CHECKS))
def test_host_checks_per_solve_are_pinned(name):
    if name == "chained_rosenbrock":
        pb = chained_rosenbrock(device="cpu")
        s = tc.CaNNOLeSSolver(pb)
        st = s.solve(max_time=600.0)
    else:
        pb = next(it[2] for it in battery.collect() if it[1] == name)(dtype=torch.float64, device="cpu")
        s = tc.CaNNOLeSSolver(pb, linsolve="ldlt")
        st = s.solve(atol=0.0, rtol=1e-5, max_time=600.0)
    assert st.status == "first_order"
    assert s.host_syncs == PINNED_CHECKS[name], (name, s.host_syncs)


class _Replay:
    """A stand-in for a captured CUDA graph on the CPU: each replay runs the
    segment again and copies its results into the bank's buffers, as a
    replay writes them in place."""

    def __init__(self, bank, fn):
        self.bank, self.fn, self.replays, self.delta = bank, fn, 0, {}

    def replay(self):
        self.replays += 1
        segments._store(self.bank, self.fn(self.bank))


@pytest.mark.parametrize("kw", [
    dict(linsolve="ldlt"), dict(linsolve="ldlt", robust_fallback=True),
    dict(kkt="condensed", multiplier_refit=True), dict(linsolve="pallas", quality_gate=False),
], ids=["ldlt", "robust_fallback", "condensed_refit", "descent_rescue"])
def test_in_place_bank_equals_the_eager_route(monkeypatch, kw):
    """The graph route's bank (persistent buffers written in place, every
    later run of a segment a replay) gives the eager route's states bit for
    bit, also where a segment's result is a view of a buffer it writes
    (``core/segments._store``); here with replays that rerun the segment,
    on the CPU.  A batched solve with the rescue too."""
    monkeypatch.setattr(segments, "_capture", lambda bank, name, fn: _Replay(bank, fn))
    pb = next(it[2] for it in battery.collect() if it[1] == "hs6")(dtype=torch.float64, device="cpu")
    out = {}
    for route in ("eager", "graph"):
        s = tc.CaNNOLeSSolver(pb, **kw)
        s.route = route
        st = s.solve(atol=0.0, rtol=1e-5, max_time=600.0)
        out[route] = (s.last_state, _counters(st), s.host_syncs)
        if route == "graph":
            assert sum(s.graph_replays().values()) > 0
    (a, ca, ha), (b, cb, hb) = out["eager"], out["graph"]
    assert ca == cb and ha == hb
    for f in a._fields[:-1]:
        assert torch.equal(getattr(a, f), getattr(b, f)) or (
            torch.equal(getattr(a, f).isnan(), getattr(b, f).isnan())
            and torch.equal(getattr(a, f).nan_to_num(), getattr(b, f).nan_to_num())), f
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    x0, d = lm_bench_batch(64, seed=0)
    res = {}
    for route in ("eager", "graph"):
        s = tc.CaNNOLeSSolver(lm_bench_family(torch.float64, "cpu"), method="lm", linsolve="pallas",
                              kkt="full")
        s.route = route
        res[route] = tc.vsolve(s.problem, x0, data_batch=d, solver=s, max_iter=50, rescue=True).states
    for f in res["eager"]._fields[:-1]:
        x, y = getattr(res["eager"], f), getattr(res["graph"], f)
        assert torch.equal(x.nan_to_num(), y.nan_to_num()), f


def test_graph_route_keeps_its_most_recent_banks(monkeypatch):
    """On the graph route a solver keeps one bank (buffers and captured
    segments) per batch size and data layout, the ``MAX_BANKS`` most
    recently used, all sharing one memory-pool holder; a batch size seen
    again after its bank was dropped is captured anew and gives the same
    bits (here with replays that rerun the segment, on the CPU)."""
    from cannoles_tpu_torch.core import solver as solver_mod
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    monkeypatch.setattr(segments, "_capture", lambda bank, name, fn: _Replay(bank, fn))
    monkeypatch.setattr(solver_mod, "MAX_BANKS", 3)
    pb = lm_bench_family(torch.float64, "cpu")
    x0, d = lm_bench_batch(6, seed=1)
    res = {}
    for route in ("eager", "graph"):
        s = tc.CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full")
        s.route = route
        res[route] = [tc.vsolve(pb, x0[:B], data_batch=d[:B], solver=s, max_iter=20).states
                      for B in (1, 2, 3, 4, 5, 1)]
        if route == "graph":
            assert [k[0] for k in s._banks] == [4, 5, 1]
            assert len({id(b._pool) for b in s._banks.values()}) == 1
        else:
            assert not s._banks
    for a, b in zip(res["eager"], res["graph"]):
        for f in a._fields[:-1]:
            assert torch.equal(getattr(a, f).nan_to_num(), getattr(b, f).nan_to_num()), f


@pytest.mark.parametrize("kw", [
    dict(linsolve="ldlt"), dict(linsolve="ldlt", robust_fallback=True),
    dict(kkt="condensed", multiplier_refit=True), dict(linsolve="pallas", quality_gate=False),
], ids=["ldlt", "robust_fallback", "condensed_refit", "descent_rescue"])
def test_traced_evaluators_equal_the_eager_ones(monkeypatch, kw):
    """The CPU's traced B = 1 evaluators (aten operations recorded by
    ``make_fx`` and replayed by the recorded ``GraphModule``) give the eager
    evaluators' states, counters and host checks bit for bit; here every
    evaluator is traced at its first call (``TRACE_CALLS`` = 1) against
    none traced, on ``hs6`` (constrained) and ``biggs_exp6_24`` to 80 outer
    iterations."""
    from cannoles_tpu_torch import problem

    rows = {"hs6": dict(max_iter=-1), "biggs_exp6_24": dict(max_iter=80)}
    for name, cap in rows.items():
        make = next(it[2] for it in battery.collect() if it[1] == name)
        out = {}
        for calls in (10**9, 1):
            monkeypatch.setattr(problem, "TRACE_CALLS", calls)
            pb = make(dtype=torch.float64, device="cpu")
            s = tc.CaNNOLeSSolver(pb, **kw)
            assert s.route == "eager" and s.route_reason == "cpu"
            st = s.solve(atol=0.0, rtol=1e-5, max_time=600.0, **cap)
            out[calls] = (s.last_state, _counters(st), s.host_syncs)
            traced = [k for k, v in pb._traces.items() if isinstance(v, problem._Trace)]
            assert not pb.untraced and (len(traced) >= 2 if calls == 1 else not traced), (name, pb._traces)
        (a, ca, ha), (b, cb, hb) = out[10**9], out[1]
        assert ca == cb and ha == hb, name
        for f in a._fields[:-1]:
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype.is_floating_point:
                x, y = x.view(torch.int64), y.view(torch.int64)
            assert torch.equal(x, y), (name, f)


def test_evaluator_traced_at_its_call_count_or_left_eager(monkeypatch):
    """A B = 1 evaluator on the CPU runs eagerly for its first
    ``TRACE_CALLS`` - 1 calls with one input layout and through its trace
    from the next; one that reads a value on the host (a Python branch on x)
    cannot be traced, stays eager with the same results, and
    ``NLSProblem.untraced`` says why."""
    from cannoles_tpu_torch import problem

    monkeypatch.setattr(problem, "TRACE_CALLS", 3)
    pb = chained_rosenbrock(device="cpu")
    x = pb.x0[None] + 0.1
    ref = pb.F_and_Jt(x)
    for call in range(2, 5):
        got = pb.F_and_Jt(x)
        kinds = {type(v).__name__ for v in pb._traces.values()}
        assert kinds == ({"int"} if call < 3 else {"_Trace"}), (call, pb._traces)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    pb.F_and_Jt(torch.cat([x, x]))  # B = 2: vmapped, never traced
    assert len(pb._traces) == 1

    def branchy(z):
        s = 2.0 if float(z[0]) > 0 else 3.0
        return torch.stack([z[0] - 1, s * (z[1] - z[0] ** 2)])

    pb = tc.nls_problem(branchy, [0.5, 1.0], 2, device="cpu")
    ref = [pb.F_and_Jt(x) for _ in range(2)]
    got = pb.F_and_Jt(x)
    assert all(torch.equal(g, r) for g, r in zip(got, ref[0]))
    (why,) = pb.untraced.values()
    assert "RuntimeError" in why
    st = tc.CaNNOLeSSolver(pb).solve(max_time=600.0)
    assert st.status == "first_order"


def test_warm_up_is_outside_the_clock_and_the_counts():
    """The first solve of a solver pays its one-time costs before the clock
    (init and one outer step of at most two inner iterations, dropped):
    they count in neither ``host_syncs`` nor the solve's statistics, and
    only once per solver."""
    pb = chained_rosenbrock(device="cpu")
    s = tc.CaNNOLeSSolver(pb)
    assert not s._warm and s.route == "eager" and s.route_reason == "cpu"
    a = s.solve(max_time=600.0)
    first = s.host_syncs
    assert s._warm and first == PINNED_CHECKS["chained_rosenbrock"]
    b = s.solve(max_time=600.0)
    assert s.host_syncs == 2 * first and _counters(a) == _counters(b)
    np.testing.assert_array_equal(a.solution, b.solution)


def test_host_ldlt_equals_the_pytorch_loop(monkeypatch):
    """On the CPU ``ldlt_factor`` runs in host C++ (``csrc/ldlt_exact.cpp``):
    L and the raw pivots equal the PyTorch loop's bit for bit, in float64
    and float32, with zero, NaN, Inf and tiny pivots; without the library
    the loop runs."""
    from cannoles_tpu_torch.ops import ldlt

    assert ldlt._host_functions()
    g = torch.Generator().manual_seed(0)
    for trial in range(60):
        N, B = 1 + trial % 37, 1 + trial % 4
        for dt, it in ((torch.float64, torch.int64), (torch.float32, torch.int32)):
            G = torch.randn(B, N, N, generator=g, dtype=torch.float64)
            A = ((G + G.transpose(1, 2)) * (trial % 9 - 4.0)).to(dt)
            if trial % 5 == 0:
                A[0, 0, 0] = 0.0
            if trial % 7 == 0:
                A[-1, 0, N - 1] = A[-1, N - 1, 0] = float("nan")
            if trial % 11 == 0:
                A[0, N - 1, N - 1] = float("inf")
            if trial % 13 == 0:
                A = A * 1e-9
            tol = float(torch.finfo(dt).eps)
            a, b = ldlt.ldlt_factor_torch(A, tol), ldlt.ldlt_factor(A, tol)
            assert torch.equal(a.mat.view(it), b.mat.view(it)) and torch.equal(a.vec.view(it), b.vec.view(it))
    monkeypatch.setattr(ldlt, "_HOST", False)
    A = torch.eye(3, dtype=torch.float64)[None]
    assert torch.equal(ldlt.ldlt_factor(A, 1e-15).vec, torch.ones(1, 3, dtype=torch.float64))


def test_cgls_without_host_checks_is_the_same():
    """CGLS with ``check=False`` (all ``itmax`` trips, for a captured
    segment) returns the early-exit loop's result bit for bit."""
    rng = np.random.default_rng(5)
    B = torch.as_tensor(rng.normal(size=(7, 9, 3)))
    b = torch.as_tensor(rng.normal(size=(7, 9)))
    B[3] = 0.0  # a lane that stops at once
    assert torch.equal(cgls(B, b), cgls(B, b, check=False))


def test_profile_ba_rung_on_the_cpu():
    """The port of ``benchmarks/profile_ba_rung.py`` at B = 2 on the CPU:
    the counts of the solved batch, the four stages with their host
    operations, their totals scaled by the largest counts, and the rest."""
    from cannoles_tpu_torch import profile_ba_rung

    out = profile_ba_rung.profile("cpu", scenes=2, reps=1)
    assert out["solved"] == 2 and out["N"] == 73 and out["route"] == "eager"
    assert set(out["stage_unit_ms"]) == {"kernel", "jacobian", "condensation", "residual"}
    assert all(v > 0 for v in out["stage_unit_ms"].values())
    assert out["max_counts"]["kernel"] >= out["counts"]["mean_nfact"] > 0
    total = sum(out["stage_total_ms"].values())
    assert out["accounted_ms"] == pytest.approx(total)
    assert out["other_ms"] == pytest.approx(out["full_solve_ms"] - total)
    assert all(o["host_ops"] > 0 and o["device_ops"] is None for o in out["stage_ops_per_call"].values())
    assert out["full_solve_host_syncs"] > 0
