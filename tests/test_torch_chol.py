"""PyTorch port, the large-problem path (``linsolve='chol'``) against the JAX
package in float64: the plain versions of the two blocked-Cholesky kernels
against ``pallas_cholesky`` (Pallas in interpret mode on the CPU), the block
solves, the two-level Cholesky of the solver at both seams, ``vsolve``,
``multiplier_refit``/``lm_damping`` and the large rung's problem.  The CUDA
kernels are checked against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models.ba_large import large_bundle_adjustment as jba_large  # noqa: E402
from cannoles_tpu.ops import pallas_chol as jchol  # noqa: E402
from cannoles_tpu.parallel.batch import vsolve as jvsolve  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.core.solver import resolve_auto  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment as tba_large  # noqa: E402
from cannoles_tpu_torch.models.families import large_rung_problem  # noqa: E402
from cannoles_tpu_torch.ops import block_chol as tchol  # noqa: E402
from cannoles_tpu_torch.utils.convert import tree_to_torch  # noqa: E402

TOL = 1e-12
FIELDS = ("status", "iter", "nfact", "nbk", "nlinsolve", "msg", "neval_F", "neval_c")


def _spd(N, rng):
    G = rng.normal(size=(N, N))
    return G @ G.T + N * np.eye(N)


def _matrix(kind, N):
    """The inputs of tests/test_pallas_chol.py: SPD, indefinite (SPD − 3N·I)
    and a tiny positive pivot below tol."""
    rng = np.random.default_rng(N)
    if kind == "indefinite":
        return _spd(N, rng) - 3 * N * np.eye(N)
    if kind == "tiny_pivot":
        A = np.eye(N)
        A[7, 7] = 1e-14
        return A
    return _spd(N, rng)


def _close(got, ref, rel=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


# N = 130 and 300 take the fused kernel (K = 2 and 2), N = 400 too (padded
# 512); N = 960 at nb = 128 is 7.4 MB in float64, past 1280²·4, so the
# blocked driver with the per-block kernel runs (K = 8)
@pytest.mark.parametrize(
    "kind,N,nb",
    [("spd", 130, 128), ("spd", 300, 256), ("spd", 960, 128),
     ("indefinite", 400, 256), ("tiny_pivot", 300, 256)],
)
def test_plain_versions_and_block_solves_match_pallas(kind, N, nb):
    A = _matrix(kind, N)
    fj = jchol.pallas_cholesky(jnp.asarray(A), tol=TOL, nb=nb)
    ft = tchol.block_cholesky(torch.as_tensor(A)[None], TOL, nb=nb)
    assert tchol.uses_fused(ft.L.shape[-1], torch.float64) == (N != 960)
    assert (ft.n0, ft.nb, ft.Linv.shape[1]) == (fj.n0, fj.nb, fj.Linv.shape[0])
    for f in ("L", "Linv", "d"):
        _close(getattr(ft, f)[0].numpy(), getattr(fj, f))
    assert bool(ft.ok[0]) == bool(fj.ok) == (kind == "spd")
    assert torch.isfinite(ft.L).all()

    rng = np.random.default_rng(1)
    for b in (rng.normal(size=N), rng.normal(size=(N, 3))):
        bt = torch.as_tensor(b)[None]
        for jf, tf in ((jchol.block_forward_solve, tchol.block_forward_solve),
                       (jchol.block_backward_solve, tchol.block_backward_solve),
                       (jchol.block_cho_solve, tchol.block_cho_solve)):
            ref = jf(fj, jnp.asarray(b))
            got = tf(ft, bt)[0].numpy()
            assert got.shape == ref.shape
            _close(got, ref)
    if kind == "spd":
        np.testing.assert_allclose(tchol.block_cho_solve(ft, bt)[0].numpy(),
                                   np.linalg.solve(A, b), rtol=0, atol=1e-9)


def test_wrappers_take_plain_path_on_cpu():
    rng = np.random.default_rng(5)
    A = torch.as_tensor(np.stack([_spd(256, rng), _spd(256, rng) - 800 * np.eye(256)]))
    before = tuple(segments.counters()[k] for k in ("chol_block", "chol_fused"))
    for got, ref in ((tchol.chol_block(A, TOL), tchol.chol_block_reference(A, TOL)),
                     (tchol.chol_fused(A, TOL, 128), tchol.chol_fused_reference(A, TOL, 128))):
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    assert tuple(segments.counters()[k] for k in ("chol_block", "chol_fused")) == before == (0, 0)
    # one block is one panel: the fused and block versions agree
    Lf, Mf, df = tchol.chol_fused_reference(A, TOL, 256)
    Lb, Mb, db = tchol.chol_block_reference(A, TOL)
    assert torch.equal(Lf, Lb) and torch.equal(Mf[:, 0], Mb) and torch.equal(df, db)
    # the skip rule: lane 1 is indefinite, its skipped pivots give zero columns
    skipped = db[1] <= TOL
    assert skipped.any() and (Lb[1][:, skipped] == 0).all()
    # route rule and nb clamp of pallas_cholesky
    assert tchol.uses_fused(1280, torch.float32) and not tchol.uses_fused(1536, torch.float32)
    assert tchol.uses_fused(896, torch.float64) and not tchol.uses_fused(1024, torch.float64)
    assert tchol.block_cholesky(A, TOL, nb=64).nb == 128
    assert tchol.block_cholesky(A, TOL, nb=1000).nb == 512
    assert tchol.block_cholesky(A, TOL).ok.tolist() == [True, False]


def assert_same(a, b, atol=1e-10):
    assert b.status == a.status
    assert b.iter == a.iter
    for key in ("nfact", "nbk", "nlinsolve", "internal_msg", "neval_residual", "neval_cons"):
        assert b.solver_specific[key] == a.solver_specific[key], key
    np.testing.assert_allclose(b.solution, np.asarray(a.solution), rtol=0, atol=atol)


def _port_problem(pj, pt):
    """The port's problem with the JAX builder's x0 and data, so that
    rounding in the two syntheses cannot split the runs."""
    data = tree_to_torch({k: np.array(v) for k, v in pj.data.items()}, device="cpu",
                         dtype=torch.float64)
    return dataclasses.replace(pt, x0=torch.as_tensor(np.array(pj.x0)), data=data)


def _seam_problems():
    """``_large_problem`` of tests/test_pallas_chol.py in both packages."""
    rng = np.random.default_rng(4)
    n, m, ncon = 96, 160, 3
    B1 = rng.normal(size=(m, n)) / np.sqrt(n)
    xt = rng.normal(size=n)
    y = B1 @ xt + 0.05 * np.tanh(B1 @ xt)
    Ac = rng.normal(size=(ncon, n))
    data = {"B1": B1, "y": y, "Ac": Ac, "bc": Ac @ xt}
    pj = jc.nls_problem(
        lambda x, d: d["B1"] @ x + 0.05 * jnp.tanh(d["B1"] @ x) - d["y"],
        jnp.zeros(n), m, lambda x, d: d["Ac"] @ x - d["bc"], np.zeros(ncon), np.zeros(ncon),
        data={k: jnp.asarray(v) for k, v in data.items()}, name="chol_seam",
    )
    pt = tc.nls_problem(
        lambda x, d: d["B1"] @ x + 0.05 * torch.tanh(d["B1"] @ x) - d["y"],
        torch.zeros(n, dtype=torch.float64), m, lambda x, d: d["Ac"] @ x - d["bc"],
        np.zeros(ncon), np.zeros(ncon),
        data={k: torch.as_tensor(v) for k, v in data.items()}, name="chol_seam", device="cpu",
    )
    return pj, pt, dict(method="gauss_newton")


def _ba_problems():
    """``large_bundle_adjustment(4, 80)``: n = 264, m = 640, p = 7; the
    kernel route pads n to 512 (K = 2)."""
    pj, _ = jba_large(4, 80, dtype=jnp.float64)
    pt, _ = tba_large(4, 80, dtype=torch.float64, device="cpu")
    return pj, _port_problem(pj, pt), dict(method="lm")


@pytest.mark.parametrize("pallas_chol_min", [0, None], ids=["kernel", "default"])
@pytest.mark.parametrize("problems", [_seam_problems, _ba_problems], ids=["seam", "ba_4x80"])
def test_chol_solver_matches_jax_at_both_seams(problems, pallas_chol_min):
    pj, pt, kw = problems()
    kw = dict(kw, kkt="condensed", linsolve="chol", pallas_chol_min=pallas_chol_min)
    a = jc.CaNNOLeSSolver(pj, **kw).solve(max_time=600.0)
    b = tc.CaNNOLeSSolver(pt, **kw).solve(max_time=600.0)
    assert a.status == "first_order"
    assert_same(a, b)


def _well_conditioned(seed):
    """``_well_conditioned_problem`` of tests/test_step_equivalence.py."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(6, 3))
    b = rng.normal(size=6)
    x0 = rng.normal(size=3)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    pj = jc.nls_problem(
        lambda x: jnp.asarray(A) @ x - jnp.asarray(b) + 0.05 * jnp.sin(x).sum() * jnp.ones(6),
        jnp.asarray(x0), 6, lambda x: jnp.array([x[0] + x[1] + x[2] - 1.0]), [0.0], [0.0],
    )
    pt = tc.nls_problem(
        lambda x: At @ x - bt + 0.05 * torch.sin(x).sum() * torch.ones(6, dtype=x.dtype),
        x0, 6, lambda x: (x.sum() - 1.0).reshape(1), [0.0], [0.0], device="cpu",
    )
    return pj, pt


def test_chol_matches_eigh_condensed_and_jax():
    """test_step_equivalence.py::test_chol_matches_eigh_condensed in the
    port, and both backends against the JAX package."""
    pj, pt = _well_conditioned(seed=1)
    out = {}
    for linsolve in ("eigh", "chol"):
        a = jc.CaNNOLeSSolver(pj, linsolve=linsolve, kkt="condensed").solve()
        out[linsolve] = tc.CaNNOLeSSolver(pt, linsolve=linsolve, kkt="condensed").solve()
        assert_same(a, out[linsolve])
    e, c = out["eigh"], out["chol"]
    assert e.status == c.status == "first_order" and e.iter == c.iter
    np.testing.assert_allclose(c.solution, e.solution, rtol=0, atol=1e-9)


def test_vsolve_chol_matches_jax():
    pj, pt = _well_conditioned(seed=2)
    x0 = np.random.default_rng(7).normal(size=(3, 3))
    kw = dict(method="gauss_newton", kkt="condensed", linsolve="chol", max_iter=50)
    a = jvsolve(pj, jnp.asarray(x0), **kw)
    b = tc.vsolve(pt, x0, **kw)
    assert b.solver.linsolve == "chol"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b.states, f).numpy(), np.asarray(getattr(a.states, f)),
                                      err_msg=f)
    assert b.solved_mask().all()
    np.testing.assert_allclose(b.solution, a.solution, rtol=0, atol=1e-10)


@pytest.mark.parametrize(
    "options",
    [dict(multiplier_refit=True), dict(multiplier_refit=True, lm_damping=True)],
    ids=["refit", "refit+damping"],
)
def test_multiplier_refit_and_lm_damping_match_jax(options):
    """The BA scene of tests/test_round5.py in float64 from a stale λ0:
    the refit cuts the iterations (19 against 27 without it), the LM
    damping changes them again (41, max_iter); every counter as in JAX."""
    pj, _ = jba_large(3, 12, dtype=jnp.float64)
    pt = _port_problem(pj, tba_large(3, 12, dtype=torch.float64, device="cpu")[0])
    lam0 = np.r_[300.0 * np.ones(6), -200.0]
    kw = dict(method="lm", kkt="condensed", linsolve="chol", use_initial_multiplier=True)
    a = jc.CaNNOLeSSolver(pj, **kw, **options).solve(lam0=jnp.asarray(lam0), max_iter=40)
    b = tc.CaNNOLeSSolver(pt, **kw, **options).solve(lam0=lam0, max_iter=40)
    assert_same(a, b)
    np.testing.assert_allclose(b.multipliers, np.asarray(a.multipliers), rtol=0, atol=1e-10)
    assert b.iter == (19 if len(options) == 1 else 41)


def _large_rung_pair(m, n):
    """The port's large-rung problem and bench.py's construction in JAX on
    the same numpy draws."""
    pt, x_true, data = large_rung_problem(m=m, n=n, dtype=torch.float64, device="cpu")
    B1, B2 = jnp.asarray(data["B1"]), jnp.asarray(data["B2"])

    def model(x):
        return B1 @ x + 0.1 * jnp.sin(B2 @ x)

    y = model(jnp.asarray(x_true))
    return jc.nls_problem(lambda x: model(x) - y, jnp.zeros(n), m), pt, x_true


def test_large_rung_problem_matches_jax():
    """The large rung's problem at m = 256, n = 64: F and Jᵀ at x0 and at a
    random point against bench.py's construction in JAX."""
    pj, pt, x_true = _large_rung_pair(256, 64)
    assert x_true.dtype == np.float32 and pt.nequ == 256 and pt.ncon == 0
    np.testing.assert_array_equal(pt.x0.numpy(), np.zeros(64))
    data = {k: v[None] for k, v in pt.data.items()}
    for x in (np.zeros(64), np.random.default_rng(0).normal(size=64)):
        Ft, JtT = pt.F_and_Jt(torch.as_tensor(x)[None], data)
        _close(Ft[0].numpy(), pj.F(jnp.asarray(x)))
        _close(JtT[0].numpy(), pj.Jt(jnp.asarray(x)))


def test_cannoles_auto_takes_chol_on_the_large_rung():
    """``cannoles(pb, method='gauss_newton')`` on the large rung's problem
    (m = 4n) resolves to the condensed form with 'chol' and the in-loop
    eigh retry, and follows the JAX package."""
    pj, pt, x_true = _large_rung_pair(256, 64)
    assert resolve_auto(pt, "gauss_newton", "auto", "auto") == ("chol", "condensed", True)
    a = jc.cannoles(pj, method="gauss_newton")
    b = tc.cannoles(pt, method="gauss_newton")
    assert_same(a, b)
    assert b.status == "first_order" and np.abs(b.solution - x_true).max() < 1e-6
