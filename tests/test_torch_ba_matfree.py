"""PyTorch port, the generic matrix-free CG engine on bundle-adjustment
scenes against the JAX package in float64 on the CPU: 3 of the 11 tests of
``tests/test_ba_schur.py`` (the rest are in ``test_torch_ba_schur.py``).

Parity as there: status, ``iter``, ``nfact``, ``nlinsolve`` equal; ``ncg``
and the last digits of the solution are held to JAX's own spread under a
one-ulp change of the start where CG stops at eps^0.45 on the BA operator
(``assert_knife_edge``), else ``ncg`` equal and solutions within 1e-10.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu.core.ba import SchurBASolver as JSchur  # noqa: E402
from cannoles_tpu.core.ba import ba_block_jacobi as jbj  # noqa: E402
from cannoles_tpu.core.matfree import MatrixFreeSolver as JMF  # noqa: E402
from cannoles_tpu_torch.core.ba import SchurBASolver as TSchur  # noqa: E402
from cannoles_tpu_torch.core.ba import ba_block_jacobi as tbj  # noqa: E402
from cannoles_tpu_torch.core.matfree import MatrixFreeSolver as TMF  # noqa: E402
from test_torch_ba_schur import _moved, _scenes  # noqa: E402
from test_torch_matfree_solver import assert_knife_edge, assert_mf_parity  # noqa: E402


TOL = dict(atol=1e-14, rtol=0.0)


def _mf_runs(pj, pt, pcj, pct):
    """The generic engine on the 3×12 scene (cg_maxiter=300) in both
    packages, and JAX's witnesses from starts one ulp away."""
    a = JMF(pj, cg_maxiter=300, precond=pcj).solve(max_time=600.0, **TOL)
    s = TMF(pt, cg_maxiter=300, precond=pct)
    b = s.solve(max_time=600.0, **TOL)
    witnesses = [JMF(_moved(pj, j), cg_maxiter=300, precond=pcj).solve(max_time=600.0, **TOL)
                 for j in (6, 20, 40)]
    return a, b, witnesses, int(s.last_state.ncg[0])


@pytest.fixture(scope="module")
def unpreconditioned():
    pj, pt, _ = _scenes()
    return _mf_runs(pj, pt, "none", "none")


def test_schur_ba_converges_and_matches_matfree(unpreconditioned):
    pj, pt, x_true = _scenes()
    tol = TOL
    a = JSchur(pj, 3, 12).solve(max_time=600.0, **tol)
    b = TSchur(pt, 3, 12).solve(max_time=600.0, **tol)
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual"), b.status
    assert np.abs(b.solution - x_true).max() < 1e-5
    # unpreconditioned CG to eps^0.45 on the BA operator: ncg is a knife edge
    a2, b2, witnesses, _ = unpreconditioned
    assert_knife_edge(a2, b2, witnesses)
    assert b2.status in ("first_order", "small_residual")
    assert np.allclose(b.solution, b2.solution, atol=1e-6)
    assert b.solver_specific["ncg"] <= b.solver_specific["nfact"]


def test_ba_block_jacobi_cuts_cg(unpreconditioned):
    """Block-Jacobi cuts the generic CG engine's total iterations ≥ 2.5×.
    Both runs stop CG at eps^0.45 on the BA operator: ``ncg`` is a knife
    edge (JAX's own start one ulp away moves it)."""
    pj, pt, x_true = _scenes()
    ncg = {}
    runs = {"none": unpreconditioned, "block": _mf_runs(pj, pt, jbj(3, 12), tbj(3, 12))}
    for label, (a, b, witnesses, n) in runs.items():
        assert_knife_edge(a, b, witnesses)
        assert b.status in ("first_order", "small_residual"), (label, b.status)
        assert np.abs(b.solution - x_true).max() < 1e-5
        ncg[label] = n
    assert ncg["block"] * 2.5 <= ncg["none"], ncg


def test_schur_ba_partial_visibility_converges():
    C, P = 4, 40
    pj, pt, x_true = _scenes(C, P, seed=1, gauge="fixed", visibility=0.3)
    assert "vis" in pt.data and float(pt.data["vis"].mean()) < 1.0
    frozen = np.asarray(pj.data["gidx"])
    tol = dict(atol=1e-11, rtol=0.0, max_iter=60)
    a = JSchur(pj, C, P, frozen_cam_coords=frozen).solve(**tol)
    b = TSchur(pt, C, P, frozen_cam_coords=frozen).solve(**tol)
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual"), b.status
    assert b.objective < 1e-14
    assert np.abs(b.solution - x_true).max() < 1e-4
    a2 = JMF(pj, cg_maxiter=500, precond=jbj(C, P)).solve(**tol)
    b2 = TMF(pt, cg_maxiter=500, precond=tbj(C, P)).solve(**tol)
    witnesses = [JMF(_moved(pj, j), cg_maxiter=500, precond=jbj(C, P)).solve(**tol) for j in (10, 25, 31)]
    assert_knife_edge(a2, b2, witnesses)
    assert b2.status in ("first_order", "small_residual"), b2.status
    assert b2.objective < 1e-14
