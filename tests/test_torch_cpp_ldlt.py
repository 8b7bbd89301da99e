"""PyTorch port, the host C++ LDLᵀ backend (``linsolve="cpp"``,
``ops/cpp_ldlt.py`` and its own copy of the source, ``csrc/ldlt_host.cpp``)
against the JAX package's ``cpp`` backend and the port's ``ldlt``, in
float64 on the CPU: the four trials of ``tests/test_backends.py``, float32
inputs, the batch entry, the solve-level trajectory check of
``tests/test_precision_trajectory.py`` and ``vsolve``.  The build writes
only under its build directory.  Skipped only without ``g++``."""

import ctypes
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.ops.cpp_ldlt import cpp_ldlt_factor_solve as jax_cpp  # noqa: E402
from cannoles_tpu_torch.ops import _native, cpp_ldlt, ldlt  # noqa: E402
from cannoles_tpu_torch.ops.ldlt import inertia_success, ldlt_factor, ldlt_solve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EIG_TOL = 1e-13


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")


def _trial(trial):
    """tests/test_backends.py::test_cpp_matches_jnp_pivots's systems: a
    random symmetric 9×9 shifted by (trial − 1)·I, nvar = 5."""
    rng = np.random.default_rng(3)
    for _ in range(trial + 1):
        A = rng.normal(size=(9, 9))
        W = A + A.T + (trial - 1) * np.eye(9)
        rhs = rng.normal(size=9)
    return W, rhs


@pytest.mark.parametrize("trial", range(4))
def test_cpp_matches_jax_cpp_and_port_ldlt(trial):
    W, rhs = _trial(trial)
    xj, okj = jax_cpp(jnp.asarray(W), jnp.asarray(rhs), 5, EIG_TOL)
    x, ok = cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W), torch.as_tensor(rhs), 5, EIG_TOL)
    assert x.dtype == torch.float64 and ok.dtype == torch.bool
    assert bool(ok) == bool(okj)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-13)
    fac = ldlt_factor(torch.as_tensor(W)[None], EIG_TOL)
    assert bool(ok) == bool(inertia_success(fac.vec, fac.mat, 5, EIG_TOL)[0])
    if bool(ok):
        xl = ldlt_solve(fac, torch.as_tensor(rhs)[None], EIG_TOL)[0]
        np.testing.assert_allclose(x.numpy(), xl.numpy(), rtol=0, atol=1e-10)


def test_float32_is_solved_in_float64_and_cast_back():
    W, rhs = _trial(2)
    W32, r32 = W.astype(np.float32), rhs.astype(np.float32)
    x, ok = cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W32), torch.as_tensor(r32), 5, EIG_TOL)
    x64, ok64 = cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W32).double(), torch.as_tensor(r32).double(),
                                               5, EIG_TOL)
    assert x.dtype == torch.float32 and bool(ok) == bool(ok64)
    assert torch.equal(x, x64.float())
    xj, okj = jax_cpp(jnp.asarray(W32), jnp.asarray(r32), 5, EIG_TOL)
    assert np.asarray(xj).dtype == np.float32 and bool(okj) == bool(ok)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))


def test_batch_entry_matches_single_systems_and_jax():
    systems = [_trial(k) for k in range(4)]
    W = np.stack([s[0] for s in systems] * 2)
    rhs = np.stack([s[1] for s in systems] * 2)
    x, ok = cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W), torch.as_tensor(rhs), 5, EIG_TOL)
    assert x.shape == (8, 9) and ok.shape == (8,)
    for b in range(8):
        xs, oks = cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W[b]), torch.as_tensor(rhs[b]), 5, EIG_TOL)
        assert bool(ok[b]) == bool(oks) and torch.equal(x[b], xs)
    xj, okj = jax.vmap(lambda a, r: jax_cpp(a, r, 5, EIG_TOL))(jnp.asarray(W), jnp.asarray(rhs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-13)
    with pytest.raises(ValueError):
        cpp_ldlt.cpp_ldlt_factor_solve(torch.as_tensor(W), torch.as_tensor(rhs[:, :5]), 5, EIG_TOL)


def _pb(mod):
    """tests/test_precision_trajectory.py's problem."""
    if mod is jc:
        return jc.nls_problem(lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), jnp.array([-1.2, 1.0]),
                              2, lambda x: jnp.array([jnp.sum(x) - 1]), [0.0], [0.0])
    return tc.nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                          lambda x: (x.sum() - 1).reshape(1), [0.0], [0.0], device="cpu")


def test_identical_trajectories_across_backends_and_jax():
    """ldlt / pallas (plain version on the CPU) / cpp: the same unpivoted
    factorization, so identical iter and nfact and solutions to 1e-12; the
    cpp run equals the JAX package's cpp run on every counter."""
    runs = {b: tc.CaNNOLeSSolver(_pb(tc), linsolve=b).solve() for b in ("ldlt", "pallas", "cpp")}
    ref = runs["ldlt"]
    for b, st in runs.items():
        assert (st.status, st.iter) == (ref.status, ref.iter), b
        assert st.solver_specific["nfact"] == ref.solver_specific["nfact"], b
        np.testing.assert_allclose(st.solution, ref.solution, rtol=0, atol=1e-12)
    a, b = jc.CaNNOLeSSolver(_pb(jc), linsolve="cpp").solve(), runs["cpp"]
    assert (b.status, b.iter) == (a.status, a.iter)
    for k in ("nfact", "nbk", "nlinsolve", "internal_msg"):
        assert b.solver_specific[k] == a.solver_specific[k], k
    np.testing.assert_allclose(b.solution, np.asarray(a.solution), rtol=0, atol=1e-12)


def test_vsolve_with_cpp_matches_jax():
    """tests/test_backends.py::test_backend_batched with linsolve='cpp',
    through a given solver and through vsolve's own."""
    rng = np.random.default_rng(0)
    x0s = rng.normal(scale=0.3, size=(6, 2)) + np.array([-1.2, 1.0])
    pj = _pb(jc)
    ref = jc.vsolve(pj, jnp.asarray(x0s), solver=jc.CaNNOLeSSolver(pj, linsolve="cpp", kkt="condensed"))
    pt = _pb(tc)
    for res in (tc.vsolve(pt, x0s, solver=tc.CaNNOLeSSolver(pt, linsolve="cpp", kkt="condensed")),
                tc.vsolve(pt, x0s, linsolve="cpp", kkt="condensed")):
        assert res.solved_mask().all(), res.summary()
        np.testing.assert_array_equal(np.asarray(res.status), np.asarray(ref.status))
        np.testing.assert_array_equal(np.asarray(res.iterations), np.asarray(ref.iterations))
        np.testing.assert_allclose(np.asarray(res.solution), np.asarray(ref.solution), rtol=0, atol=1e-12)


def _snapshot(d: pathlib.Path):
    # the JAX package's own library (native/libcannoles_ldlt.so) is built by
    # the JAX tests in other processes; everything else under native/ is
    # fixed
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.iterdir()
            if p.name != "libcannoles_ldlt.so"}


def test_build_writes_only_under_the_port_build_dir(tmp_path):
    """Both host sources, through ``ops/_native.py``'s one build routine, into a
    build directory of the test's own: the libraries under their cached
    names there, no temporary file left, each loads with its functions, and
    nothing else changes."""
    native = ROOT / "native"
    assert cpp_ldlt.lib_path().parent == ROOT / "cannoles_tpu_torch" / "_build"
    assert _native.CSRC == ROOT / "cannoles_tpu_torch" / "csrc"
    sources = [(_native.CSRC / "ldlt_host.cpp", cpp_ldlt._FLAGS), (_native.CSRC / "ldlt_exact.cpp", ldlt._HOST_FLAGS)]
    before = _snapshot(native)
    libs = _native.build(sources, build_dir=tmp_path)
    assert sorted(tmp_path.iterdir()) == sorted(libs)
    assert [p.name for p in libs] == [_native.lib_path(src, flags).name for src, flags in sources]
    assert libs[0].name == cpp_ldlt.native_lib_path().name
    for lib, fn in zip(libs, ("cannoles_ldlt_factor_solve_batch", "cannoles_ldlt_exact_f64")):
        assert hasattr(ctypes.CDLL(str(lib)), fn)
    assert _snapshot(native) == before
