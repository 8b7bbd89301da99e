"""PyTorch port, the camera-Schur BA solver (``core/ba.py``) against the
JAX package in float64 on the CPU: 8 of the 11 tests of
``tests/test_ba_schur.py``; the 3 that run the generic CG engine at length
on BA scenes are in ``test_torch_ba_matfree.py`` (the two files keep each
under a minute and a half on one worker).

Each test asserts what the JAX test asserts, on the same scenes (the
scene functions draw them with numpy from one seed), and parity with the JAX
package: one Schur step to 1e-12 relative; whole solves with status,
``iter``, ``nfact``, ``ncg`` and ``nlinsolve`` equal and solutions within
1e-10 of their scale, except where CG's iteration count is a float64 knife
edge (``test_torch_matfree_solver.assert_knife_edge``: JAX's own solve
from a start one ulp away is the witness).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu.core.ba import SchurBASolver as JSchur  # noqa: E402
from cannoles_tpu.core.ba import inv3x3_sym as jinv3  # noqa: E402
from cannoles_tpu.core.matfree import MatrixFreeSolver as JMF  # noqa: E402
from cannoles_tpu.models.ba_large import large_bundle_adjustment as jscene  # noqa: E402
from cannoles_tpu_torch.core.ba import SchurBASolver as TSchur  # noqa: E402
from cannoles_tpu_torch.core.ba import ba_block_jacobi as tbj  # noqa: E402
from cannoles_tpu_torch.core.ba import inv3x3_sym as tinv3  # noqa: E402
from cannoles_tpu_torch.core.matfree import MatrixFreeSolver as TMF  # noqa: E402
from cannoles_tpu_torch.core.solver import _add_batch_axis  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment as tscene  # noqa: E402
from cannoles_tpu_torch.models.ba_large import project_point  # noqa: E402
from test_torch_matfree_solver import _ulp, assert_knife_edge, assert_mf_parity  # noqa: E402

STEP_TOL = 1e-12


def _scenes(C=3, P=12, **kw):
    pj, x_true = jscene(C, P, noise=0.0, dtype=jnp.float64, **{"seed": 0, **kw})
    pt, _ = tscene(C, P, noise=0.0, dtype=torch.float64, device="cpu", **{"seed": 0, **kw})
    return pj, pt, x_true


def _moved(pj, j):
    """The JAX problem started one ulp away in coordinate ``j``."""
    return dataclasses.replace(pj, x0=jnp.asarray(_ulp(pj.x0, j)))


def test_inv3x3():
    rng = np.random.default_rng(0)
    G = rng.normal(size=(50, 3, 3))
    V = G @ np.swapaxes(G, -1, -2) + 3 * np.eye(3)
    Vinv, ok = tinv3(torch.as_tensor(V), 1e-12)
    Vj, okj = jinv3(jnp.asarray(V), 1e-12)
    assert bool(ok.all())
    assert np.allclose(Vinv.numpy() @ V, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(Vinv.numpy(), np.asarray(Vj), rtol=0, atol=STEP_TOL * np.abs(Vj).max())
    Vbad = V.copy()
    Vbad[7] = -np.eye(3)
    Vinv2, ok2 = tinv3(torch.as_tensor(Vbad), 1e-12)
    assert not bool(ok2[7]) and bool(ok2[:7].all())
    assert np.isfinite(Vinv2.numpy()).all()
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(jinv3(jnp.asarray(Vbad), 1e-12)[1]))


def _step_check(C, P, **kw):
    """One Schur step at the init state in both packages, against each
    other and against the densely materialized operator."""
    pj, pt, _ = _scenes(C, P, **kw)
    js, ts = JSchur(pj, C, P), TSchur(pt, C, P)
    sj = js._init_fn(pj.x0, pj.y0, js.make_config(), pj.data)
    st = ts._init_state(pt.x0[None], pt.y0[None], ts.make_config(), _add_batch_axis(pt.data, "cpu"))
    np.testing.assert_allclose(st.x[0].numpy(), np.asarray(sj.x), rtol=0, atol=1e-15)
    zj, okj, _ = js._solve_condensed(sj, jnp.asarray(1e-3, jnp.float64))
    zt, okt, kt = ts._solve_condensed(st, torch.tensor([1e-3], dtype=torch.float64))
    assert bool(okt[0]) and bool(okj) and int(kt[0]) == 1
    zt = zt[0].numpy()
    np.testing.assert_allclose(zt, np.asarray(zj), rtol=0, atol=STEP_TOL * np.abs(zj).max())
    J = np.asarray(pj.J(sj.x, pj.data))
    Jc = np.asarray(pj.Jc(sj.x, pj.data))
    M = 1e-3 * np.eye(pj.nvar) + J.T @ J + Jc.T @ Jc / float(sj.delta)
    bx = np.asarray(sj.dual) + J.T @ np.asarray(sj.prim_r) + Jc.T @ np.asarray(sj.cx) / float(sj.delta)
    ref = np.linalg.solve(M, bx)
    assert np.allclose(zt, ref, atol=1e-8 * (1 + np.abs(ref).max()))


def test_schur_step_matches_dense_solve():
    _step_check(3, 12)


def test_schur_ba_frozen_gauge():
    pj, pt, xt = _scenes(4, 40, gauge="fixed", seed=1)
    frozen = np.asarray(pj.data["gidx"])
    tol = dict(atol=1e-11, rtol=0.0)
    a = JSchur(pj, 4, 40, frozen_cam_coords=frozen).solve(max_iter=60, **tol)
    b = TSchur(pt, 4, 40, frozen_cam_coords=frozen).solve(max_iter=60, **tol)
    assert_mf_parity(a, b)
    assert b.status in ("first_order", "small_residual"), b.status
    assert np.array_equal(b.solution[frozen], pt.x0.numpy()[frozen])
    assert np.abs(b.solution - xt).max() < 1e-4
    a2 = JMF(pj, cg_maxiter=500).solve(max_iter=60, **tol)
    b2 = TMF(pt, cg_maxiter=500).solve(max_iter=60, **tol)
    # unpreconditioned CG to eps^0.45: ncg is a knife edge (witnesses: JAX
    # from starts one ulp away in a landmark and in an unfrozen camera)
    witnesses = [JMF(_moved(pj, j), cg_maxiter=500).solve(max_iter=60, **tol) for j in (10, 25, 31)]
    assert_knife_edge(a2, b2, witnesses)
    assert b2.status in ("first_order", "small_residual")
    assert np.allclose(b.solution, b2.solution, atol=1e-5)
    with pytest.raises(ValueError, match="camera block"):
        TSchur(pt, 4, 40, frozen_cam_coords=[6 * 4 + 1])


def test_schur_ba_validation():
    _, pt, _ = _scenes()
    with pytest.raises(ValueError, match="BA layout"):
        TSchur(pt, 4, 12)
    pt_bad = dataclasses.replace(
        pt, cons=lambda x, d: (x[-1] - 1.0).reshape(1), ncon=1,
        lcon=torch.zeros(1, dtype=torch.float64), ucon=torch.zeros(1, dtype=torch.float64),
        y0=torch.zeros(1, dtype=torch.float64),
    )
    with pytest.raises(ValueError, match="camera block"):
        TSchur(pt_bad, 3, 12)


def test_project_consistency_with_families_model():
    from cannoles_tpu.models.ba_large import project_point as jproject
    from cannoles_tpu_torch.models.families import _rodrigues

    rng = np.random.default_rng(1)
    cam = rng.normal(size=6) * 0.3
    pt = rng.normal(size=3) + np.array([0, 0, 3.0])
    uv = project_point(torch.as_tensor(cam), torch.as_tensor(pt)).numpy()
    Xc = _rodrigues(torch.as_tensor(cam[:3]), torch.as_tensor(pt - cam[3:])[None, :])[0]
    uv_ref = (Xc[:2] / torch.clamp(Xc[2], min=1e-3)).numpy()
    assert np.allclose(uv, uv_ref, atol=1e-12)
    np.testing.assert_allclose(uv, np.asarray(jproject(jnp.asarray(cam), jnp.asarray(pt))), rtol=0, atol=1e-15)


def test_multiplier_refit_breaks_dual_floor():
    pj, pt, x_true = _scenes()
    kw = dict(max_time=600.0, atol=1e-9, rtol=0.0, max_iter=200)
    a = JSchur(pj, 3, 12, method="lm", multiplier_refit=True).solve(**kw)
    b = TSchur(pt, 3, 12, method="lm", multiplier_refit=True).solve(**kw)
    assert_mf_parity(a, b)
    assert b.status == "first_order", b.status
    assert b.dual_feas < 1e-9
    assert np.abs(b.solution - x_true).max() < 1e-8


def test_schur_step_matches_dense_solve_partial_visibility():
    _step_check(3, 12, visibility=0.3)


def test_ba_block_jacobi_validates_layout():
    _, pt, _ = _scenes()
    factory = tbj(4, 12)
    with pytest.raises(ValueError, match="BA layout"):
        factory(pt, pt.x0[None], _add_batch_axis(pt.data, "cpu"), torch.zeros(1), torch.ones(1))
