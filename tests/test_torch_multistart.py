"""PyTorch port, batched multistart against the JAX package in float64: the
two cases of ``tests/test_multistart.py``.  Both packages draw the starts
from the same numpy generator, so they must pick the same best lane with
the same status, iterations and solution (to 1e-8) and count the same
solved lanes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models import mgh01con as jmgh01con, mgh_problem as jmgh  # noqa: E402
from cannoles_tpu.parallel.multistart import multistart as jms  # noqa: E402
from cannoles_tpu_torch.models import mgh01con as tmgh01con, mgh_problem as tmgh  # noqa: E402
from cannoles_tpu_torch.parallel.multistart import multistart as tms  # noqa: E402


def assert_same(a, b):
    assert b.status == a.status
    for key in ("n_starts", "n_solved", "best_lane"):
        assert b.solver_specific[key] == a.solver_specific[key], key
    assert b.iter == a.iter
    np.testing.assert_allclose(b.solution, np.asarray(a.solution), rtol=0, atol=1e-8)
    np.testing.assert_allclose(b.objective, a.objective, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(b.solver_specific["objectives"], a.solver_specific["objectives"],
                               rtol=1e-8, atol=1e-12)
    assert abs(b.primal_feas - a.primal_feas) <= 1e-8


def test_multistart_beats_local_minimum():
    pj, pt = jmgh("freudenstein_roth"), tmgh("freudenstein_roth", device="cpu")
    single = tc.CaNNOLeSSolver(pt).solve(atol=0.0, rtol=1e-5)
    assert 2 * single.objective > 1.0  # the standard start lands at the 48.98 local min
    a = jms(pj, n_starts=32, atol=0.0, rtol=1e-5, max_iter=150)
    b = tms(pt, n_starts=32, atol=0.0, rtol=1e-5, max_iter=150)
    assert_same(a, b)
    assert b.status == "first_order"
    assert 2 * b.objective < 1e-6  # global optimum f* = 0


def test_multistart_constrained():
    a = jms(jmgh01con(), n_starts=16, scale=0.5)
    solver = tc.CaNNOLeSSolver(tmgh01con(device="cpu"))
    b = tms(solver.problem, n_starts=16, scale=0.5, solver=solver)
    assert_same(a, b)
    assert b.status == "first_order"
    assert b.primal_feas < 1e-8
    assert np.allclose(b.solution, [0.5, 0.25], atol=1e-6)
    assert b.solver_specific["n_solved"] >= 14
    assert solver.host_syncs > 0  # the sweep ran on the solver it was given
    assert isinstance(b, tc.ExecutionStats) and isinstance(a, jc.ExecutionStats)
