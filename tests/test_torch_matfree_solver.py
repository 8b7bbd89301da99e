"""PyTorch port, the matrix-free engine (``core/matfree.py``) against the
JAX package in float64 on the CPU: the 11 tests of
``tests/test_matfree_solver.py``, the row-sharded one through
``MatrixFreeSolver(problem, mesh=...)`` on 4 spawned gloo ranks (their
program is ``tests/torch_ranks.py``'s ``matfree_rows``) against JAX's run
with the data on its 8 virtual CPU devices.

Each test runs the JAX test's problem through both packages and asserts
what the JAX test asserts, plus parity: status equal, ``iter``, ``nfact``,
``ncg`` and ``nlinsolve`` equal, and solutions within 1e-10 relative to
their scale (``SOL_TOL``).

Float64 knife edges (``KNIFE_EDGES``): where CG stops at eps^0.45 on an
ill-conditioned operator, the CG iteration count and the last digits of
the solution follow rounding.  For those runs the witness is the JAX
package itself: the same solve with one input moved by one ulp.  Status,
``iter``, ``nfact`` and ``nlinsolve`` stay equal; the port's ``ncg`` must
lie within twice the witnesses' spread of JAX's (at least ±2) and its
solution within ten times their spread of the JAX solution.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models.basic import mgh01con as jmgh01con  # noqa: E402
from cannoles_tpu_torch.models.basic import mgh01con as tmgh01con  # noqa: E402

SOL_TOL = 1e-10
COUNTERS = ("nfact", "ncg", "nlinsolve")
KNIFE_EDGES = {
    "mgh01con": "dual floor of λ ← λ − c/δ: x fixed to ~3e-9 by the CG tolerance",
    "meyer": "stiff exponential fit: every CG solve near its tolerance",
    "illscaled": "κ(JᵀJ) ~ 1e3, CG to eps^0.45 (none: at its n = 128 budget)",
}


def _ulp(a, j):
    a = np.array(a, dtype=np.float64)
    a.flat[j] = np.nextafter(a.flat[j], np.inf)
    return a


def assert_knife_edge(a, b, witnesses):
    """The port's ``b`` against JAX's ``a`` where JAX's own runs
    ``witnesses`` (one input one ulp away) show the spread of rounding."""
    assert (b.status, b.iter) == (a.status, a.iter)
    for k in ("nfact", "nlinsolve"):
        assert b.solver_specific[k] == a.solver_specific[k], k
    spread = max(abs(w.solver_specific["ncg"] - a.solver_specific["ncg"]) for w in witnesses)
    got = abs(b.solver_specific["ncg"] - a.solver_specific["ncg"])
    assert got <= 2 * max(spread, 1), (b.solver_specific["ncg"], a.solver_specific["ncg"], spread)
    xa = np.asarray(a.solution)
    dx = max([np.abs(np.asarray(w.solution) - xa).max() for w in witnesses]
             + [SOL_TOL * max(1.0, np.abs(xa).max())])
    assert np.abs(b.solution - xa).max() <= 10 * dx, (np.abs(b.solution - xa).max(), dx)


def assert_mf_parity(a, b, sol_tol=SOL_TOL):
    """JAX stats ``a`` against the port's ``b``."""
    assert (b.status, b.iter) == (a.status, a.iter)
    for k in COUNTERS:
        assert b.solver_specific[k] == a.solver_specific[k], k
    xa = np.asarray(a.solution)
    np.testing.assert_allclose(b.solution, xa, rtol=0, atol=sol_tol * max(1.0, np.abs(xa).max()))


def _rosenbrock(mod):
    if mod == "jax":
        return jc.nls_problem(lambda x: jnp.array([x[0] - 1.0, 10 * (x[1] - x[0] ** 2)]),
                              jnp.array([-1.2, 1.0]), 2)
    return tc.nls_problem(lambda x: torch.stack([x[0] - 1.0, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                          device="cpu")


def _curve_fit(mod):
    m, n = 20_000, 64
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, m)
    w_true = rng.normal(size=n) / np.arange(1, n + 1)
    freq = np.arange(1, n + 1, dtype=np.float64)
    y = np.sin(np.pi * t[:, None] * freq[None, :]) @ w_true
    if mod == "jax":
        data = {"t": jnp.asarray(t), "y": jnp.asarray(y), "f": jnp.asarray(freq)}
        pb = jc.nls_problem(lambda w, d: jnp.sin(jnp.pi * d["t"][:, None] * d["f"][None, :]) @ w - d["y"],
                            jnp.zeros(n), m, data=data, name="large_curvefit")
    else:
        data = {k: torch.as_tensor(v) for k, v in (("t", t), ("y", y), ("f", freq))}
        pb = tc.nls_problem(lambda w, d: torch.sin(np.pi * d["t"][:, None] * d["f"][None, :]) @ w - d["y"],
                            np.zeros(n), m, data=data, name="large_curvefit", device="cpu")
    return pb, w_true


def _constrained_fit(mod):
    m, n = 5_000, 16
    rng = np.random.default_rng(1)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    b = A @ rng.normal(size=n)
    if mod == "jax":
        return jc.nls_problem(lambda x, d: d["A"] @ x - d["b"], jnp.zeros(n), m,
                              lambda x: jnp.array([jnp.sum(x) - 1.0]), [0.0], [0.0],
                              data={"A": jnp.asarray(A), "b": jnp.asarray(b)})
    return tc.nls_problem(lambda x, d: d["A"] @ x - d["b"], np.zeros(n), m,
                          lambda x: (x.sum() - 1.0).reshape(1), [0.0], [0.0],
                          data={"A": torch.as_tensor(A), "b": torch.as_tensor(b)}, device="cpu")


def _rank_deficient(mod):
    if mod == "jax":
        return jc.nls_problem(lambda x: jnp.array([x[0] - 1.0, (x[0] - 1.0) * 2.0, x[1] * x[0] ** 2]),
                              jnp.array([0.0, 3.0]), 3)
    return tc.nls_problem(lambda x: torch.stack([x[0] - 1.0, (x[0] - 1.0) * 2.0, x[1] * x[0] ** 2]),
                          [0.0, 3.0], 3, device="cpu")


_MEYER_T = 45.0 + 5.0 * np.arange(1, 17)
_MEYER_Y = np.array([34780., 28610., 23650., 19630., 16370., 13720., 11540., 9744., 8261., 7030.,
                     6005., 5147., 4427., 3820., 3307., 2872.])


def _meyer(mod):
    if mod == "jax":
        return jc.nls_problem(lambda x, d: x[0] * jnp.exp(x[1] / (d["t"] + x[2])) - d["y"],
                              jnp.array([0.02, 4000.0, 250.0]), 16,
                              data={"t": jnp.asarray(_MEYER_T), "y": jnp.asarray(_MEYER_Y)}, name="meyer")
    return tc.nls_problem(lambda x, d: x[0] * torch.exp(x[1] / (d["t"] + x[2])) - d["y"],
                          [0.02, 4000.0, 250.0], 16,
                          data={"t": torch.as_tensor(_MEYER_T), "y": torch.as_tensor(_MEYER_Y)},
                          name="meyer", device="cpu")


def _ill_scaled(mod):
    m, n = 512, 128
    rng = np.random.default_rng(7)
    scales = np.logspace(0, 1.5, n)
    A = rng.normal(size=(m, n)) / np.sqrt(m) * scales
    x_true = rng.normal(size=n) / scales
    b = A @ x_true
    if mod == "jax":
        pb = jc.nls_problem(lambda x, d: d["A"] @ x - d["b"], jnp.zeros(n), m,
                            data={"A": jnp.asarray(A), "b": jnp.asarray(b)}, name="illscaled")
    else:
        pb = tc.nls_problem(lambda x, d: d["A"] @ x - d["b"], np.zeros(n), m,
                            data={"A": torch.as_tensor(A), "b": torch.as_tensor(b)}, name="illscaled",
                            device="cpu")
    return pb, x_true


def _run_budgeted_jax(pb, method, n_outer=300, precond="none"):
    s = jc.MatrixFreeSolver(pb, method=method, cg_maxiter=60, precond=precond)
    cfg = s.make_config(max_iter=n_outer, max_inner=100)
    st = s._init_fn(pb.x0, pb.y0, cfg, pb.data)
    for _ in range(n_outer):
        st = s._outer_fn(st, cfg)
        if int(st.status) != 0:
            break
    return st


def _run_budgeted_torch(pb, method, n_outer=300, precond="none"):
    from cannoles_tpu_torch.core.solver import _add_batch_axis

    s = tc.MatrixFreeSolver(pb, method=method, cg_maxiter=60, precond=precond)
    cfg = s.make_config(max_iter=n_outer, max_inner=100)
    st = s._init_state(pb.x0[None], pb.y0[None], cfg, _add_batch_axis(pb.data, "cpu"))
    for _ in range(n_outer):
        st = s._outer_step(st, cfg, st.status == 0)
        if int(st.status[0]) != 0:
            break
    return st


def _assert_state_parity(a, b, witnesses=()):
    """Budgeted states: counters equal and x within 1e-10 of its scale, or,
    with ``witnesses``, within ten times their spread."""
    for k in ("iter", "nfact", "ncg", "nlinsolve", "nbk", "status"):
        assert int(getattr(b, k)[0]) == int(getattr(a, k)), k
    xa = np.asarray(a.x)
    dx = b.x[0].numpy() - xa
    if witnesses:
        assert np.abs(dx).max() <= 10 * max(np.abs(np.asarray(w.x) - xa).max() for w in witnesses)
    else:
        assert np.abs(dx).max() <= SOL_TOL * max(1.0, np.abs(xa).max())


@pytest.fixture(scope="module")
def meyer_jax():
    import dataclasses

    pb = _meyer("jax")
    out = {m: _run_budgeted_jax(pb, m) for m in ("gauss_newton", "lm")}
    for m in ("gauss_newton", "lm"):
        out[m + "_witnesses"] = [
            _run_budgeted_jax(dataclasses.replace(pb, x0=jnp.asarray(_ulp(pb.x0, j))), m) for j in range(3)
        ]
    return out


def test_matches_dense_on_rosenbrock():
    a = jc.solve_matfree(_rosenbrock("jax"))
    b = tc.solve_matfree(_rosenbrock("torch"))
    assert_mf_parity(a, b)
    assert b.status == "first_order"
    np.testing.assert_allclose(b.solution, [1.0, 1.0], atol=1e-6)


def test_matches_dense_constrained():
    pj = jmgh01con()
    a = jc.solve_matfree(pj)
    pt = tmgh01con(device="cpu")
    b = tc.solve_matfree(pt)
    assert_knife_edge(a, b, [jc.solve_matfree(pj, x=jnp.asarray(_ulp(pj.x0, j))) for j in range(2)])
    dense = tc.cannoles(pt, method="gauss_newton")
    assert b.status == "first_order"
    np.testing.assert_allclose(b.solution, dense.solution, atol=1e-5)
    np.testing.assert_allclose(b.multipliers, dense.multipliers, atol=1e-4)
    np.testing.assert_allclose(b.multipliers, a.multipliers, rtol=0, atol=1e-8)


def test_rejects_newton_method():
    with pytest.raises(ValueError, match="Gauss"):
        jc.solve_matfree(jmgh01con(), method="newton")
    with pytest.raises(ValueError, match="Gauss"):
        tc.solve_matfree(tmgh01con(device="cpu"), method="newton")


def test_large_curve_fit_no_jacobian():
    """m = 20,000, n = 64: the state holds no (m, n) object (with the batch
    axis, no leaf of nequ·nvar or more elements)."""
    pj, w_true = _curve_fit("jax")
    pt, _ = _curve_fit("torch")
    a = jc.MatrixFreeSolver(pj, cg_maxiter=200).solve(max_time=120.0)
    s = tc.MatrixFreeSolver(pt, cg_maxiter=200)
    b = s.solve(max_time=120.0)
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual"), b.status
    np.testing.assert_allclose(b.solution, w_true, atol=1e-5)
    leaves = [getattr(s.last_state, f) for f in s.last_state._fields[:-1]]
    leaves += list(s.last_state.data.values())
    assert all(t.numel() < pt.nequ * pt.nvar for t in leaves)


def test_constrained_large():
    a = jc.solve_matfree(_constrained_fit("jax"))
    b = tc.solve_matfree(_constrained_fit("torch"))
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual")
    assert abs(float(np.sum(b.solution)) - 1.0) < 1e-6
    assert b.dual_feas < 1e-4


def test_cg_divergence_bumps_rho():
    """J is rank 1 at x0: CG at ρ = 0 cannot converge, the ladder engages."""
    a = jc.MatrixFreeSolver(_rank_deficient("jax")).solve()
    b = tc.MatrixFreeSolver(_rank_deficient("torch")).solve()
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual")
    assert b.solver_specific["nfact"] >= b.solver_specific["nlinsolve"]


def test_matfree_lm_damping_is_applied(meyer_jax):
    """method='lm' is not Gauss–Newton: the first direction already differs."""
    pj, pt = _meyer("jax"), _meyer("torch")
    gn = _run_budgeted_torch(pt, "gauss_newton", n_outer=1)
    lm = _run_budgeted_torch(pt, "lm", n_outer=1)
    _assert_state_parity(_run_budgeted_jax(pj, "gauss_newton", n_outer=1), gn)
    _assert_state_parity(_run_budgeted_jax(pj, "lm", n_outer=1), lm)
    assert not np.allclose(gn.x[0].numpy(), lm.x[0].numpy())


def test_matfree_lm_beats_gn_on_stiff_fit(meyer_jax):
    """Equal budgets on Meyer, unpreconditioned: LM's objective lands well
    below Gauss–Newton's."""
    pt = _meyer("torch")
    gn = _run_budgeted_torch(pt, "gauss_newton")
    lm = _run_budgeted_torch(pt, "lm")
    _assert_state_parity(meyer_jax["gauss_newton"], gn, meyer_jax["gauss_newton_witnesses"])
    _assert_state_parity(meyer_jax["lm"], lm, meyer_jax["lm_witnesses"])
    assert float(lm.fx[0]) < 0.9 * float(gn.fx[0])


def test_jacobi_precond_cuts_cg_iterations():
    """Ill-column-scaled fit: the Hutchinson Jacobi preconditioner (JAX's
    probes, bit for bit) cuts total CG iterations ≥ 3×, same answer."""
    import dataclasses

    pj, x_true = _ill_scaled("jax")
    pt, _ = _ill_scaled("torch")
    moved = [dataclasses.replace(pj, data={"A": pj.data["A"], "b": jnp.asarray(_ulp(pj.data["b"], j))})
             for j in range(3)]
    ncg = {}
    for precond in ("none", "jacobi"):
        a = jc.MatrixFreeSolver(pj, precond=precond).solve(max_iter=100)
        s = tc.MatrixFreeSolver(pt, precond=precond)
        b = s.solve(max_iter=100)
        assert_knife_edge(a, b, [jc.MatrixFreeSolver(w, precond=precond).solve(max_iter=100) for w in moved])
        assert b.status in ("first_order", "small_residual"), (precond, b.status)
        assert np.abs(b.solution - x_true).max() < 1e-5
        ncg[precond] = int(s.last_state.ncg[0])
    assert ncg["jacobi"] * 3 <= ncg["none"], ncg


def test_matfree_lm_still_solves_tame_problems():
    a = jc.solve_matfree(_rosenbrock("jax"), method="lm")
    b = tc.solve_matfree(_rosenbrock("torch"), method="lm")
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual")
    np.testing.assert_allclose(b.solution, [1.0, 1.0], atol=1e-4)


def test_row_sharded_matfree():
    """``tests/test_matfree_solver.py::test_row_sharded_matfree``: the rows of
    A and b split over the ranks; every Jᵀw all-reduced."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import torch_ranks
    from cannoles_tpu_torch.parallel.launch import launch

    A, b, x_true = torch_ranks.linear_rows_data()
    rows = NamedSharding(Mesh(np.asarray(jax.devices()[:8]), axis_names=("rows",)), P("rows"))
    data = {"A": jax.device_put(jnp.asarray(A), rows), "b": jax.device_put(jnp.asarray(b), rows)}
    pb = jc.nls_problem(lambda x, d: d["A"] @ x - d["b"], jnp.zeros(A.shape[1]), A.shape[0], data=data)
    a = jc.solve_matfree(pb)
    got = launch(torch_ranks.matfree_rows, 4)
    for r in got:
        assert r["status"] in ("first_order", "small_residual")
        np.testing.assert_allclose(r["x"], x_true, atol=1e-6)
        assert (r["status"], r["iter"]) == (a.status, a.iter)
        assert [r[k] for k in COUNTERS] == [a.solver_specific[k] for k in COUNTERS]
        np.testing.assert_allclose(r["x"], np.asarray(a.solution), rtol=0,
                                   atol=SOL_TOL * max(1.0, np.abs(a.solution).max()))
        np.testing.assert_array_equal(r["x"], got[0]["x"])
