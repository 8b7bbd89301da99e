"""PyTorch port, the MGH battery against the JAX package in float64: the 22
easy problems of ``tests/test_mgh.py`` through ``CaNNOLeSSolver(pb).solve()``
with the default configuration (newton, full KKT, ldlt).

Status, ``iter``, ``nfact``, ``nlinsolve`` and ``nbk`` equal, solutions
within 1e-8 relative to the solution's scale, and both at the certified
minimum, except for the knife edges named below (ROADMAP.md queue 3),
which must still agree on the status and, where solved, the objective.
Two problems have a minimizer that the first-order exit does not pin
down to 1e-8; their solutions are held to the bar named in ``LOOSE_X``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models import mgh_suite as jsuite  # noqa: E402
from cannoles_tpu_torch.models import mgh_suite as tsuite  # noqa: E402

EASY = {
    "rosenbrock", "beale", "helical_valley", "bard", "gaussian",
    "powell_singular", "wood", "kowalik_osborne", "box3d",
    "ext_rosenbrock", "ext_powell", "variably_dimensioned",
    "brown_almost_linear", "discrete_boundary_value", "discrete_integral",
    "broyden_tridiagonal", "broyden_banded", "linear_full_rank",
    "osborne1", "watson", "jennrich_sampson", "brown_dennis",
}

# name -> (JAX (iter, nfact, nlinsolve), port (iter, nfact, nlinsolve)).
# variably_dimensioned: the last bits of s = Σ j(x_j − 1) and s² differ
# after the first iteration (reduction order), and at iteration 2 the ρ = 0
# attempt's inertia test lands on either side: JAX accepts ρ = 0, the port
# regularizes once.  Neither package is wrong.
KNIFE_EDGES = {"variably_dimensioned": ((11, 21, 11), (11, 22, 11))}

# name -> bar on max |x_port − x_jax| relative to max |x|, where the
# counters agree but the last step leaves x less determined than 1e-8:
# brown_almost_linear is zero-residual with a nearly rank-deficient J at
# its root (measured 4.7e-6), wood stops where its Hessian's small
# eigenvalue leaves x free along one direction (measured 2.5e-8).
LOOSE_X = {"brown_almost_linear": 1e-5, "wood": 1e-7}

PAIRS = {t.name: (j, t) for j, t in zip(jsuite(), tsuite()) if t.name in EASY}


def counters(st):
    ss = st.solver_specific
    return st.iter, ss["nfact"], ss["nlinsolve"]


def assert_solve_parity(a, b, name, knife_edges, loose_x=None):
    assert b.status == a.status, (name, a.status, b.status)
    if name in knife_edges:
        assert (counters(a), counters(b)) == knife_edges[name], (name, counters(a), counters(b))
        if b.status in ("first_order", "small_residual"):
            np.testing.assert_allclose(b.objective, a.objective, rtol=1e-6, atol=1e-12)
        return
    assert counters(b) == counters(a), name
    assert b.solver_specific["nbk"] == a.solver_specific["nbk"], name
    xa = np.asarray(a.solution)
    bar = (loose_x or {}).get(name, 1e-8)
    np.testing.assert_allclose(b.solution, xa, rtol=0, atol=bar * max(1.0, np.abs(xa).max()))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_easy_mgh_solve_matches_jax(name):
    js, ts = PAIRS[name]
    a = jc.CaNNOLeSSolver(js.make()).solve(max_time=600.0)
    b = tc.CaNNOLeSSolver(ts.make(device="cpu")).solve(max_time=600.0)
    assert_solve_parity(a, b, name, KNIFE_EDGES, LOOSE_X)
    np.testing.assert_allclose(b.objective, a.objective, rtol=1e-6, atol=1e-12)
    assert b.status in ("first_order", "small_residual"), (name, b.status)
    tol = max(1e-6, 1e-4 * max(1.0, abs(ts.fmin)))
    assert 2 * b.objective <= ts.fmin + tol, (name, 2 * b.objective, ts.fmin)


def test_easy_set_is_the_jax_tests():
    assert len(PAIRS) == 22 and set(KNIFE_EDGES) | set(LOOSE_X) <= set(PAIRS)
