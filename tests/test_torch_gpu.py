"""PyTorch port on a CUDA card: the fused LDLᵀ kernel against its plain
version, the wrapper's input checks, and the batched solver on the card
against the solver on the CPU.

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
from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family  # noqa: E402
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
