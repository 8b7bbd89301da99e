"""PyTorch port, linear-algebra ops against the JAX package: the plain
version of the fused LDLᵀ kernel against the Pallas kernel (interpret mode
on the CPU), the ldlt/eigh backends, the inertia test and CGLS.  The CUDA
kernel itself is checked against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu.ops import cgls as jcgls  # noqa: E402
from cannoles_tpu.ops import ldlt as jldlt  # noqa: E402
from cannoles_tpu.ops.pallas_ldlt import batched_ldlt_solve_pallas  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.ops import cgls as tcgls  # noqa: E402
from cannoles_tpu_torch.ops import fused_ldlt as tfused  # noqa: E402
from cannoles_tpu_torch.ops import ldlt as tldlt  # noqa: E402
from cannoles_tpu_torch.utils.testing import quasi_definite  # noqa: E402

EIG_TOL = float(np.finfo(np.float64).eps)


@pytest.mark.parametrize(
    "N,B", [(1, 3), (1, 130), (5, 3), (5, 130), (34, 130), (73, 130)]
)
def test_fused_reference_matches_pallas_interpret(N, B):
    # N = 34 and 73 only at B = 130, which crosses the kernel's 128-lane
    # padding: the interpret-mode Pallas kernel takes ~10 s (N = 34) and
    # ~50 s (N = 73) per compiled shape on the CPU.
    W, rhs, _ = quasi_definite(B, N, seed=N + B)
    xj, dj = batched_ldlt_solve_pallas(jnp.asarray(W), jnp.asarray(rhs), EIG_TOL)
    xt, dt = tfused.fused_ldlt_solve_reference(torch.as_tensor(W), torch.as_tensor(rhs), EIG_TOL)
    xj, dj = np.asarray(xj), np.asarray(dj)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-12, atol=1e-12 * np.abs(dj).max())
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-12, atol=1e-12 * np.abs(xj).max())
    if B > 2:
        assert dt[0, 0] == 0 and (N < 2 or dt[1, 1] == 0)  # the skip lanes


def test_fused_wrapper_takes_plain_path_on_cpu():
    W, rhs, n1 = quasi_definite(8, 5, seed=0)
    before = segments.counters()["fused_ldlt"]
    x, d = tfused.fused_ldlt_solve(torch.as_tensor(W), torch.as_tensor(rhs), EIG_TOL)
    xr, dr = tfused.fused_ldlt_solve_reference(torch.as_tensor(W), torch.as_tensor(rhs), EIG_TOL)
    assert segments.counters()["fused_ldlt"] == before == 0
    assert torch.equal(x, xr) and torch.equal(d, dr)
    ok = tldlt.inertia_success(d, x, n1, EIG_TOL)
    assert ok.tolist() == [False, False] + [True] * 6
    assert tfused.max_n(torch.float32) == 240 and tfused.max_n(torch.float64) == 169


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [5, 40])
def test_ldlt_factor_solve_match_jax(N, dtype):
    W, rhs, n1 = quasi_definite(3, N, seed=7, skip=False)
    W, rhs = W.astype(dtype), rhs.astype(dtype)
    tol = float(np.finfo(dtype).eps)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    ref_L, ref_d, ref_x = [], [], []
    for i in range(3):
        fac = jldlt.ldlt_factor(jnp.asarray(W[i]), tol)
        ref_L.append(np.asarray(fac.mat))
        ref_d.append(np.asarray(fac.vec))
        ref_x.append(np.asarray(jldlt.ldlt_solve(fac, jnp.asarray(rhs[i]), tol)))
    fac = tldlt.ldlt_factor(torch.as_tensor(W), tol)
    x = tldlt.ldlt_solve(fac, torch.as_tensor(rhs), tol)
    np.testing.assert_allclose(fac.mat.numpy(), np.stack(ref_L), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(fac.vec.numpy(), np.stack(ref_d), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(x.numpy(), np.stack(ref_x), rtol=rtol, atol=rtol * np.abs(ref_x).max())
    assert tldlt.inertia_success(fac.vec, fac.mat, n1, tol).all()


def test_eigh_and_inertia_match_jax():
    W, rhs, n1 = quasi_definite(4, 9, seed=11)
    fac = tldlt.eigh_factor(torch.as_tensor(W), EIG_TOL)
    x = tldlt.eigh_solve(fac, torch.as_tensor(rhs), EIG_TOL)
    for i in range(4):
        jf = jldlt.eigh_factor(jnp.asarray(W[i]), EIG_TOL)
        xj = np.asarray(jldlt.eigh_solve(jf, jnp.asarray(rhs[i]), EIG_TOL))
        np.testing.assert_allclose(x[i].numpy(), xj, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(fac.vec[i].numpy(), np.asarray(jf.vec), rtol=1e-12, atol=1e-12)
        for nvar in (n1 - 1, n1, n1 + 1):
            for vec, mat in ((fac.vec[i], fac.mat[i]), (torch.tensor([1.0, np.nan]), fac.mat[i])):
                ref = bool(jldlt.inertia_success(jnp.asarray(vec.numpy()), jnp.asarray(mat.numpy()),
                                                 nvar, EIG_TOL))
                got = bool(tldlt.inertia_success(vec[None], mat[None], nvar, EIG_TOL)[0])
                assert got == ref


@pytest.mark.parametrize("n,p", [(6, 2), (3, 5), (4, 0)])
def test_cgls_matches_jax(n, p):
    rng = np.random.default_rng(n * 10 + p)
    Bm = rng.normal(size=(5, n, p))
    Bm[1] = 0.0  # a lane with zero curvature
    b = rng.normal(size=(5, n))
    got = tcgls.cgls(torch.as_tensor(Bm), torch.as_tensor(b)).numpy()
    assert got.shape == (5, p)
    for i in range(5):
        ref = np.asarray(jcgls.cgls(jnp.asarray(Bm[i]), jnp.asarray(b[i])))
        np.testing.assert_allclose(got[i], ref, rtol=1e-11, atol=1e-12)
