"""PyTorch port, single solves against the JAX package in float64: status,
counters, internal_msg and solution through ``CaNNOLeSSolver.solve()`` and
``cannoles()``, plus a mid-trajectory resume of a JAX state in the port."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch.core.solver import TENSOR_FIELDS  # noqa: E402
from cannoles_tpu_torch.utils.convert import state_from_numpy  # noqa: E402

# (name, jax residual, torch residual, jax cons, torch cons, x0):
# _pb of tests/test_precision_trajectory.py and three problems of
# tests/test_basic.py (unconstrained Rosenbrock, Rosenbrock + quadratic
# constraints, F_larger(3) + quadratic constraints).  test_basic's
# (F_linear, c_quad) is left out: its KKT matrix at x0 is singular in the
# Hessian block, so the rho = 0 attempt's second pivot lands within
# rounding of eig_tol, and XLA's fused multiply-adds decide it differently
# (ROADMAP.md queue 3).
PROBLEMS = {
    "pb": (
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        lambda x: jnp.array([jnp.sum(x) - 1]),
        lambda x: torch.stack([x.sum() - 1]),
        [-1.2, 1.0],
    ),
    "rosen": (
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        None, None,
        [-1.2, 1.0],
    ),
    "rosen_quad": (
        lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
        lambda x: jnp.array([jnp.sum(x**2) - 5, jnp.prod(x) - 2]),
        lambda x: torch.stack([(x**2).sum() - 5, x.prod() - 2]),
        [0.9, 1.9],
    ),
    "larger_quad": (
        lambda x: jnp.concatenate([jnp.array([10 * (x[i + 1] - x[i] ** 2) for i in range(2)]),
                                   jnp.array([x[i] - 1 for i in range(2)])]),
        lambda x: torch.cat([torch.stack([10 * (x[i + 1] - x[i] ** 2) for i in range(2)]),
                             torch.stack([x[i] - 1 for i in range(2)])]),
        lambda x: jnp.array([jnp.sum(x**2) - 5, jnp.prod(x) - 2]),
        lambda x: torch.stack([(x**2).sum() - 5, x.prod() - 2]),
        [0.5, 1.0, 1.5],
    ),
}


def make(name):
    Fj, Ft, cj, ct, x0 = PROBLEMS[name]
    x0 = np.asarray(x0, dtype=np.float64)
    m = len(Fj(jnp.asarray(x0)))
    if cj is None:
        return jc.nls_problem(Fj, jnp.asarray(x0), m), tc.nls_problem(Ft, x0, m, device="cpu")
    p = len(cj(jnp.asarray(x0)))
    return (
        jc.nls_problem(Fj, jnp.asarray(x0), m, cj, np.zeros(p), np.zeros(p)),
        tc.nls_problem(Ft, x0, m, ct, np.zeros(p), np.zeros(p), device="cpu"),
    )


def assert_same(a, b):
    assert b.status == a.status
    assert b.iter == a.iter
    for key in ("nfact", "nbk", "nlinsolve", "internal_msg", "neval_residual", "neval_cons"):
        assert b.solver_specific[key] == a.solver_specific[key], key
    np.testing.assert_allclose(b.solution, np.asarray(a.solution), rtol=0, atol=1e-10)
    np.testing.assert_allclose(b.multipliers, np.asarray(a.multipliers), rtol=0, atol=1e-10)


@pytest.mark.parametrize("linsolve", ["ldlt", "pallas", "eigh"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_solve_matches_jax(name, linsolve):
    pj, pt = make(name)
    a = jc.CaNNOLeSSolver(pj, linsolve=linsolve).solve()
    b = tc.CaNNOLeSSolver(pt, linsolve=linsolve).solve()
    assert_same(a, b)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_cannoles_auto_matches_jax(name):
    pj, pt = make(name)
    assert_same(jc.cannoles(pj), tc.cannoles(pt))


@pytest.mark.parametrize(
    "method,kkt",
    [("lm", "full"), ("gauss_newton", "full"), ("newton_vanishing", "full"),
     ("newton", "condensed"), ("lm", "condensed")],
)
def test_methods_and_kkt_forms_match_jax(method, kkt):
    pj, pt = make("pb")
    a = jc.CaNNOLeSSolver(pj, method=method, kkt=kkt, linsolve="pallas").solve()
    b = tc.CaNNOLeSSolver(pt, method=method, kkt=kkt, linsolve="pallas").solve()
    assert_same(a, b)


@pytest.mark.parametrize("linsolve,kkt", [("ldlt", "full"), ("pallas", "full"), ("pallas", "condensed")])
def test_mid_trajectory_step_matches_jax(linsolve, kkt):
    """Run 2 outer steps in JAX, carry the state over, take one outer step
    in each package and compare every field."""
    pj, pt = make("larger_quad")
    sj = jc.CaNNOLeSSolver(pj, linsolve=linsolve, kkt=kkt)
    cfg = sj.make_config()
    s = sj._init_fn(pj.x0, pj.y0, cfg, None)
    for _ in range(2):
        s = sj._outer_fn(s, cfg)
    fields = {k: np.asarray(v) for k, v in s._asdict().items() if v is not None}
    st = tc.CaNNOLeSSolver(pt, linsolve=linsolve, kkt=kkt)
    ts = state_from_numpy(fields, device="cpu", dtype=torch.float64)
    assert ts.x.shape == (1, pt.nvar) and ts.iter.dtype == torch.int32
    ref = sj._outer_fn(s, cfg)
    got = st._outer_step(ts, st.make_config(), torch.ones(1, dtype=torch.bool))
    assert int(ref.iter) == 3
    for f in TENSOR_FIELDS:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f)[0].numpy()
        assert g.shape == r.shape, f
        if r.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_array_equal(g, r, err_msg=f)


def test_callback_user_stop_and_max_time():
    _, pt = make("pb")
    seen = []

    def cb(problem, state, stats):
        seen.append(stats.iter)
        if stats.iter == 2:
            stats.status = "user"

    st = tc.CaNNOLeSSolver(pt).solve(callback=cb)
    assert st.status == "user" and st.iter == 2 and seen == [0, 1, 2]
    assert tc.CaNNOLeSSolver(pt).solve(max_time=-1.0).status == "max_time"


def test_out_of_slice_options_raise():
    """linsolve='cpp' and resume_from were once out of the port; both are in
    it now (tests/test_torch_cpp_ldlt.py, tests/test_torch_checkpoint.py).
    'cpp' must build and solve to the 'ldlt' result, and resume_from must
    continue a solve to the straight-through result."""
    _, pt = make("pb")
    via_cpp = tc.CaNNOLeSSolver(pt, linsolve="cpp").solve()
    via_ldlt = tc.CaNNOLeSSolver(pt, linsolve="ldlt").solve()
    assert (via_cpp.status, via_cpp.iter) == (via_ldlt.status, via_ldlt.iter)
    assert via_cpp.solver_specific["nfact"] == via_ldlt.solver_specific["nfact"]
    np.testing.assert_allclose(via_cpp.solution, via_ldlt.solution, rtol=0, atol=1e-12)
    s = tc.CaNNOLeSSolver(pt)
    s.solve(max_iter=1)
    resumed = s.solve(resume_from=s.last_state)
    straight = tc.CaNNOLeSSolver(pt).solve()
    assert (resumed.status, resumed.iter) == (straight.status, straight.iter)
    assert np.array_equal(resumed.solution, straight.solution)
    with pytest.raises(ValueError):
        tc.CaNNOLeSSolver(pt, method="bogus")


def test_reset_to_problem_of_same_dims_matches_jax():
    """Re-solve through ``reset`` (tests/test_solver_behavior.py): no
    argument is a no-op; a problem of identical dimensions gets a solver
    with the same options, dtype and device; other dimensions raise."""
    from cannoles_tpu.models import hs6 as jhs6
    from cannoles_tpu_torch.models import hs6 as ths6

    def shifted(pkg):
        if pkg is jc:
            return jc.nls_problem(lambda x: jnp.array([x[0]]), jnp.array([-1.2, 1.0]), 1,
                                  lambda x: jnp.array([10 * (x[1] - x[0] ** 2)]), [0.0], [0.0])
        return tc.nls_problem(lambda x: torch.stack([x[0]]), [-1.2, 1.0], 1,
                              lambda x: torch.stack([10 * (x[1] - x[0] ** 2)]), [0.0], [0.0],
                              device="cpu")

    sj = jc.CaNNOLeSSolver(jhs6(), robust_fallback=True, delta_min=1e-6)
    st = tc.CaNNOLeSSolver(ths6(device="cpu"), robust_fallback=True, delta_min=1e-6)
    assert st.reset() is st
    assert_same(sj.solve(), st.solve())
    st2 = st.reset(shifted(tc))
    assert st2 is not st and st2.problem is not st.problem
    for key in ("method", "linsolve", "kkt", "quality_gate", "robust_fallback", "descent_rescue",
                "params", "dtype", "device", "pallas_chol_min"):
        assert getattr(st2, key) == getattr(st, key), key
    a, b = sj.reset(shifted(jc)).solve(), st2.solve()
    assert_same(a, b)
    assert b.status == "first_order" and np.allclose(b.solution, [0.0, 0.0], atol=1e-6)
    with pytest.raises(ValueError, match="identical dimensions"):
        st.reset(make("rosen")[1])


def test_max_time_is_read_inside_an_outer_step(monkeypatch):
    """After the first outer step, solve()'s budget is read at every host
    sync: a step that it interrupts is dropped and the last outer iterate
    comes back with status max_time, equal to a solve stopped there by
    max_iter.  The clock is faked: it advances one second at each reading
    by the solver.  The budget is set from an unbudgeted solve's readings,
    so that it runs out at the last reading taken at a host sync, inside
    the last outer step."""
    from cannoles_tpu_torch.core import solver as solver_mod
    from cannoles_tpu_torch.models import chained_rosenbrock

    pb = chained_rosenbrock(device="cpu")

    def fake_clock(log):
        now = [0]

        def read():
            code = sys._getframe(1).f_code
            if code.co_filename == solver_mod.__file__:  # the solver's readings advance the clock
                log.append(code.co_name)
                now[0] += 1
            return float(now[0] - 1)

        return read

    free = []
    monkeypatch.setattr(solver_mod.time, "time", fake_clock(free))
    tc.CaNNOLeSSolver(pb).solve(max_time=1e9)
    start = free.index("solve")  # the clock's value at the solve's start
    last = len(free) - 1 - free[::-1].index("_check")  # the last reading at a host sync
    assert start < last
    timed = []
    monkeypatch.setattr(solver_mod.time, "time", fake_clock(timed))
    s = tc.CaNNOLeSSolver(pb)
    st = s.solve(max_time=last - start - 0.5)
    monkeypatch.undo()
    # the budgeted solve read the clock as the free one did, up to the
    # reading at a host sync that ended it (then once more for the stats)
    assert timed[:last + 1] == free[:last + 1] and len(timed) == last + 2
    assert st.status == "max_time" and st.iter >= 2
    ref = tc.CaNNOLeSSolver(pb)
    r = ref.solve(max_iter=st.iter - 1, max_time=600.0)  # max_iter stops after iteration max_iter + 1
    assert r.status == "max_iter" and r.iter == st.iter
    assert st.solver_specific == r.solver_specific
    np.testing.assert_array_equal(st.solution, r.solution)
    assert s.host_syncs > ref.host_syncs  # the interrupted step's trips
    assert s._deadline is None
