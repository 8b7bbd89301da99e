"""PyTorch port on a CUDA card: the fused LDLᵀ kernel and the two blocked
Cholesky kernels against their plain versions, the wrappers' input checks,
and the solver on the card against the solver on the CPU.

Every test here is marked ``gpu`` and skips without a card.  The file
imports no JAX (the machine with the card has none), so on the card it runs
without the JAX-only ``conftest.py``:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu_torch import CaNNOLeSSolver, vsolve  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment  # noqa: E402
from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family  # noqa: E402
from cannoles_tpu_torch.ops import block_chol as tchol  # noqa: E402
from cannoles_tpu_torch.ops import fused_ldlt as tfused  # noqa: E402
from cannoles_tpu_torch.utils.testing import quasi_definite  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on the card: "
                    "python -m pytest --noconftest -m gpu tests/test_torch_gpu.py")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_kernel_matches_plain_on_card(cuda, dtype):
    # float64 to 1e-12 relative; float32 to 1e-4: the elimination is the
    # plain version's operation for operation (--fmad=false), only the
    # backward substitution sums in another order
    dt = getattr(torch, dtype)
    tol = float(torch.finfo(dt).eps)
    rel = 1e-12 if dt == torch.float64 else 1e-4
    for N, B in [(1, 3), (5, 257), (73, 257), (tfused.max_n(dt), 3)]:
        W, rhs, n1 = quasi_definite(B, N, seed=N)
        Wc = torch.as_tensor(W, dtype=dt, device=cuda)
        rc = torch.as_tensor(rhs, dtype=dt, device=cuda)
        before = tfused.LAUNCHES
        x, d = tfused.fused_ldlt_solve(Wc, rc, tol)
        torch.cuda.synchronize()
        assert tfused.LAUNCHES == before + 1
        xr, dr = tfused.fused_ldlt_solve_reference(Wc, rc, tol)
        assert float((d - dr).abs().max()) <= rel * float(dr.abs().max())
        assert float((x - xr).abs().max()) <= rel * float(xr.abs().max())
        assert torch.equal(d > tol, dr > tol) and torch.equal(d.abs() <= tol, dr.abs() <= tol)


def test_fused_kernel_rejects_what_it_does_not_take(cuda):
    W, rhs, _ = quasi_definite(4, 5, seed=0)
    Wc, rc = torch.as_tensor(W, device=cuda), torch.as_tensor(rhs, device=cuda)
    before = tfused.LAUNCHES
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc[:, :, :4], rc, 1e-16)  # not square
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc.transpose(1, 2), rc, 1e-16)  # not contiguous
    with pytest.raises(ValueError):
        tfused.fused_ldlt_solve(Wc, rc.cpu(), 1e-16)  # two devices
    with pytest.raises(TypeError):
        tfused.fused_ldlt_solve(Wc.half(), rc.half(), 1e-3)
    N = tfused.max_n(torch.float64) + 1
    with pytest.raises(ValueError, match="cap"):
        tfused.fused_ldlt_solve(torch.eye(N, dtype=torch.float64, device=cuda)[None],
                                torch.ones((1, N), dtype=torch.float64, device=cuda), 1e-16)
    assert tfused.LAUNCHES == before


def test_vsolve_on_card_matches_cpu(cuda):
    """The bench family in float64 through vsolve with the rescue: per-lane
    status and counters equal on the card (kernel) and the CPU (plain
    version), solutions within 1e-10."""
    x0, d = lm_bench_batch(32, seed=3)
    out = {}
    for where in (cuda, torch.device("cpu")):
        pb = lm_bench_family(torch.float64, where)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full")
        before = tfused.LAUNCHES
        out[where.type] = vsolve(pb, x0, data_batch=d, solver=s, max_iter=50, rescue=True)
        assert (tfused.LAUNCHES > before) == (where.type == "cuda")
    g, c = out["cuda"], out["cpu"]
    for f in ("status", "iter", "nfact", "nbk", "nlinsolve", "msg", "neval_F", "neval_c"):
        assert torch.equal(getattr(g.states, f).cpu(), getattr(c.states, f)), f
    np.testing.assert_allclose(g.solution, c.solution, rtol=0, atol=1e-10)
    assert g.solved_mask().all()


def _spd_batch(B, N, seed, dtype, device):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, N, N))
    A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
    return torch.as_tensor(A, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chol_kernels_match_plain_on_card(cuda, dtype):
    # float64 to 1e-12 relative, float32 to 1e-4: a block's elimination is
    # the plain version's operation for operation (--fmad=false), the
    # substitution sums and the panel products sum in another order than
    # torch.matmul (well-conditioned inputs: κ ≲ 10)
    dt = getattr(torch, dtype)
    rel = 1e-12 if dt == torch.float64 else 1e-4
    tol = float(torch.finfo(dt).eps)

    def close(got, ref):
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all())
            assert float((g - r).abs().max()) <= rel * float(r.abs().max())

    for nb, B in ((128, 3), (256, 1), (512, 2)):
        A = _spd_batch(B, nb, nb, dt, cuda)
        before = tchol.BLOCK_LAUNCHES
        got = tchol.chol_block(A, tol)
        torch.cuda.synchronize()
        assert tchol.BLOCK_LAUNCHES == before + 1
        ref = tchol.chol_block_reference(A, tol)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])  # L and d bit for bit
        close(got, ref)
    for N, nb, B in ((256, 128, 3), (1024, 256, 1)):
        A = _spd_batch(B, N, N, dt, cuda)
        before = tchol.FUSED_LAUNCHES
        got = tchol.chol_fused(A, tol, nb)
        torch.cuda.synchronize()
        assert tchol.FUSED_LAUNCHES == before + 1
        close(got, tchol.chol_fused_reference(A, tol, nb))
    # the ok verdict, with an indefinite lane and a tiny-pivot lane, on the
    # fused route (N = 300) and, in float64, the blocked route (N = 1024)
    for N in (300, 1024):
        A = _spd_batch(3, N, 7, dt, cuda)
        A[1] -= 3 * N * torch.eye(N, dtype=dt, device=cuda)
        A[2] = torch.eye(N, dtype=dt, device=cuda)
        A[2, 7, 7] = tol / 100
        fac = tchol.block_cholesky(A, tol, nb=256)
        torch.cuda.synchronize()
        ref = tchol.block_cholesky_reference(A, tol, nb=256)
        assert fac.ok.tolist() == ref.ok.tolist() == [True, False, False]
        close((fac.L, fac.Linv, fac.d), (ref.L, ref.Linv, ref.d))


def test_chol_kernels_reject_what_they_do_not_take(cuda):
    A = _spd_batch(2, 256, 0, torch.float64, cuda)
    before = (tchol.BLOCK_LAUNCHES, tchol.FUSED_LAUNCHES)
    with pytest.raises(TypeError):
        tchol.chol_block(A.half(), 1e-3)
    with pytest.raises(ValueError):
        tchol.chol_block(A[:, :, :128], 1e-12)  # not square
    with pytest.raises(ValueError, match="multiple"):
        tchol.chol_fused(A, 1e-12, 100)
    assert (tchol.BLOCK_LAUNCHES, tchol.FUSED_LAUNCHES) == before


def test_chol_solver_on_card_matches_cpu(cuda):
    """A constrained BA scene, LM, condensed, 'chol' through the kernels
    (pallas_chol_min=0) in float64: every counter equal on the card and the
    CPU (plain versions), solutions within 1e-10."""
    out = {}
    for where in (cuda, torch.device("cpu")):
        pb, _ = large_bundle_adjustment(4, 80, dtype=torch.float64, device=where)
        s = CaNNOLeSSolver(pb, method="lm", kkt="condensed", linsolve="chol", pallas_chol_min=0)
        before = tchol.FUSED_LAUNCHES
        out[where.type] = s.solve(max_time=600.0)
        assert (tchol.FUSED_LAUNCHES > before) == (where.type == "cuda")
    g, c = out["cuda"], out["cpu"]
    assert g.status == c.status == "first_order" and g.iter == c.iter
    assert g.solver_specific == c.solver_specific
    np.testing.assert_allclose(g.solution, c.solution, rtol=0, atol=1e-10)
