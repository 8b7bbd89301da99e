"""PyTorch port, basics: Params, status codes, norms, and the import
boundary (the port never imports JAX), each against the JAX package."""

import dataclasses
import itertools
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu.core.status as jst  # noqa: E402
import cannoles_tpu.params as jparams  # noqa: E402
import cannoles_tpu.utils.linalg as jla  # noqa: E402
import cannoles_tpu_torch.core.status as tst  # noqa: E402
import cannoles_tpu_torch.params as tparams  # noqa: E402
import cannoles_tpu_torch.utils.linalg as tla  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "jdt,tdt",
    [(jnp.float16, torch.float16), (jnp.float32, torch.float32), (jnp.float64, torch.float64)],
)
def test_params_equal_jax(jdt, tdt):
    assert dataclasses.asdict(tparams.Params.for_dtype(tdt)) == dataclasses.asdict(
        jparams.Params.for_dtype(jdt)
    )
    assert (tparams.MAX_DLAMBDA, tparams.F_BLOWUP, tparams.SMAX) == (
        jparams.MAX_DLAMBDA, jparams.F_BLOWUP, jparams.SMAX
    )


@pytest.mark.parametrize("with_iter", [False, True])
def test_status_code_truth_table(with_iter):
    combos = np.array(list(itertools.product([False, True], repeat=6)))
    opt, small, broken, over_eval, over_iter, stalled = combos.T
    evals = np.where(over_eval, 11, 10).astype(np.int32)
    iters = np.where(over_iter, 6, 5).astype(np.int32)
    extra_j, extra_t = {}, {}
    if with_iter:
        extra_j = dict(iter_=jnp.asarray(iters), max_iter=jnp.int32(5), stalled=jnp.asarray(stalled))
        extra_t = dict(iter_=torch.as_tensor(iters), max_iter=torch.tensor(5, dtype=torch.int32),
                       stalled=torch.as_tensor(stalled))
    ref = np.asarray(jst.get_status_code(
        optimal=jnp.asarray(opt), small_residual=jnp.asarray(small), broken=jnp.asarray(broken),
        evals=jnp.asarray(evals), max_eval=jnp.int32(10), **extra_j,
    ))
    got = tst.get_status_code(
        optimal=torch.as_tensor(opt), small_residual=torch.as_tensor(small),
        broken=torch.as_tensor(broken), evals=torch.as_tensor(evals),
        max_eval=torch.tensor(10, dtype=torch.int32), **extra_t,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    for code in range(9):
        assert tst.status_name(code) == jst.status_name(code)
    assert tst.MSG == jst.MSG


@pytest.mark.parametrize("n", [0, 1, 7])
def test_norms_match_jax(n):
    rng = np.random.default_rng(n)
    v = rng.normal(size=(4, n))
    if n:
        v[2, 0] = np.inf
        v[3, -1] = np.nan
    t = torch.as_tensor(v)
    for name in ("norm_inf", "norm_1", "norm_2", "check_nan_inf"):
        ref = np.stack([np.asarray(getattr(jla, name)(jnp.asarray(row))) for row in v])
        got = getattr(tla, name)(t).numpy()
        assert got.shape == (4,)
        np.testing.assert_allclose(got.astype(float), ref.astype(float), rtol=1e-15, atol=0)


def test_import_never_pulls_in_jax():
    code = (
        "import sys\n"
        "import cannoles_tpu_torch, cannoles_tpu_torch.parallel.batch, "
        "cannoles_tpu_torch.models.families, cannoles_tpu_torch.models.ba_large, "
        "cannoles_tpu_torch.utils.convert, cannoles_tpu_torch.ops._native, "
        "cannoles_tpu_torch.ops.block_chol, chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'cannoles_tpu') or m.startswith(('jax.', 'cannoles_tpu.')))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a CUDA card, and alone in a directory, chip_smoke exits
    nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
