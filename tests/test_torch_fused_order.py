"""PyTorch port: the order of arithmetic of the fused LDLᵀ kernel
(``cannoles_tpu_torch/csrc/fused_ldlt.cu``), written out in numpy, against
its plain version ``fused_ldlt_solve_reference`` on the CPU.

Both mappings of the kernel keep the upper triangle (i ≤ j) and give every
entry its updates in ascending k as A[i][j] − (d_k·l_i)·l_j, with
l_m = A[k][m]·(1/d_k); the forward solve is folded into the elimination.
The raw pivots d must then be the plain version's bit for bit, which the
card checks with ``torch.equal`` (``tests/test_torch_gpu.py``).  Keeping the
lower triangle instead rounds (d_k·l_j)·l_i and gives other pivots.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu_torch.ops import fused_ldlt as tfused  # noqa: E402
from cannoles_tpu_torch.utils.testing import quasi_definite  # noqa: E402


def _safe_inv(v, tol):
    ok = np.abs(v) > tol
    return np.where(ok, 1 / np.where(ok, v, 1), 0).astype(v.dtype)


def _kernel_order(W, rhs, tol, lower=False):
    """The kernel's elimination on a batch (numpy, the type of W): returns
    (x, d).  ``lower`` keeps the lower triangle instead of the upper."""
    A, y = W.copy(), rhs.copy()
    N = W.shape[-1]
    d = np.empty_like(rhs)
    for k in range(N):
        dk = d[:, k] = A[:, k, k].copy()
        inv = _safe_inv(dk, tol)
        lk = (A[:, k, :] if not lower else A[:, :, k]) * inv[:, None]
        yk = y[:, k].copy()
        for i in range(k + 1, N):
            y[:, i] = y[:, i] - lk[:, i] * yk
            if lower:  # entry (j, i), j ≥ i: row index j in the first product
                A[:, i:, i] = A[:, i:, i] - (dk[:, None] * lk[:, i:]) * lk[:, i : i + 1]
            else:
                A[:, i, i:] = A[:, i, i:] - (dk * lk[:, i])[:, None] * lk[:, i:]
        if lower:
            A[:, :, k] = np.where(np.arange(N) > k, lk, 0)
        else:
            A[:, k, :] = np.where(np.arange(N) > k, lk, 0)
    for k in range(N - 1, -1, -1):
        L = A[:, k, :] if not lower else A[:, :, k]
        s = (L[:, k + 1 :] * y[:, k + 1 :]).sum(-1)
        y[:, k] = y[:, k] * _safe_inv(d[:, k], tol) - s
    return y, d


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [5, 16, 17, 73])
def test_kernel_order_gives_reference_pivots_bit_for_bit(N, dtype):
    W, rhs, _ = quasi_definite(64, N, seed=100 + N)
    W, rhs = W.astype(dtype), rhs.astype(dtype)
    tol = float(np.finfo(dtype).eps)
    x, d = _kernel_order(W, rhs, tol)
    xr, dr = tfused.fused_ldlt_solve_reference(torch.as_tensor(W), torch.as_tensor(rhs), tol)
    assert np.array_equal(d, dr.numpy())
    assert d[0, 0] == 0 and d[1, 1] == 0  # the skip lanes ran
    rel = 1e-4 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(x, xr.numpy(), rtol=0, atol=rel * np.abs(xr.numpy()).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lower_triangle_order_gives_other_pivots(dtype):
    W, rhs, _ = quasi_definite(64, 73, seed=173)
    W, rhs = W.astype(dtype), rhs.astype(dtype)
    tol = float(np.finfo(dtype).eps)
    _, d = _kernel_order(W, rhs, tol, lower=True)
    _, dr = tfused.fused_ldlt_solve_reference(torch.as_tensor(W), torch.as_tensor(rhs), tol)
    assert not np.array_equal(d, dr.numpy())
    np.testing.assert_allclose(d, dr.numpy(), rtol=1e-3 if dtype == "float32" else 1e-10)
