"""PyTorch port, its public API against the JAX package's.

For every public module of ``cannoles_tpu`` (its ``__all__``, or else the
functions and classes it defines), every public name, and every public
method of a public class, the port has a counterpart in the matching
module of ``cannoles_tpu_torch`` whose parameters include the JAX
signature's parameter names; the port may add its own (``device``,
``mesh``).  What the port leaves out on purpose stands in ``OMITTED`` with
its reason, and ``RENAMED`` maps the Pallas modules to the port's kernels.
The names the port gained last (``NLSProblem.J`` and ``F_and_J``, the
keyword ``v`` of ``jtprod_res``/``jtprod_cons``, ``ops.ldlt.factorize`` and
``factor_solve``, ``ops.cpp_ldlt.cpp_available`` and ``native_lib_path``)
are held to the JAX package's values in float64 on one problem (1e-12).
"""

import dataclasses
import importlib
import inspect
import pkgutil
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cannoles_tpu  # noqa: E402

TOL = 1e-12

# the JAX module → the port's module, where the port's is named otherwise
RENAMED = {"ops.pallas_ldlt": "ops.fused_ldlt", "ops.pallas_chol": "ops.block_chol"}

# what the port leaves out on purpose: "module.name", "module.Class.method"
# or "module.function(parameter)"
OMITTED = {
    "ops.pallas_chol.pallas_cholesky": "renamed ops.block_chol.block_cholesky: the CUDA kernels' driver",
    "ops.pallas_ldlt.fused_ldlt_solve(nb)": "the blocked-jnp panel width of the JAX scalar path; "
                                            "the port's kernel and plain version have no panels",
    "ops.pallas_ldlt.batched_ldlt_solve_pallas": "the lanes-last Pallas call; the port's wrapper "
                                                 "fused_ldlt_solve takes the batch itself",
    "ops.pallas_ldlt.PALLAS_MAX_N": "a TPU VMEM limit; the port's is fused_ldlt.max_n()",
    "ops.pallas_ldlt.PALLAS_EAGER_MAX_N": "a Mosaic compile-time limit; nvcc builds once",
    "ops.pallas_ldlt.pallas_large_n_opt_in": "opts in to the Mosaic compile above PALLAS_EAGER_MAX_N",
    "ops.ldlt.ldlt_factor(nb)": "the JAX elimination's panel width; the port's loop has no panels "
                                "(ops.ldlt.factorize accepts nb and reads it not)",
    "core.solver.CaNNOLeSSolver.batch_runner": "a cached jit of the vmapped run; the port's run() "
                                               "is batch-native and vsolve calls it",
    "core.matfree.MatrixFreeSolver.make_config(kw)": "forwards **kw to CaNNOLeSSolver.make_config; the "
                                                     "port names its keywords",
    "parallel.batch.make_batch_mesh(devices)": "a JAX device list; the port's mesh is a "
                                               "torch.distributed group (group=, device=)",
    "parallel.schur.make_row_mesh(devices)": "a JAX device list; as make_batch_mesh",
    "parallel.multihost.batch_convergence_stats(axis_name)": "a shard_map axis name; the port "
                                                             "reduces over mesh=",
    "utils.testing.force_cpu": "flips JAX's platform to the CPU; the port takes device=\"cpu\"",
}


def _jax_modules():
    return [""] + sorted(m.name[len("cannoles_tpu."):]
                         for m in pkgutil.walk_packages(cannoles_tpu.__path__, "cannoles_tpu."))


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__]
    return sorted(names)


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _missing_params(jobj, tobj, key, gaps):
    jp, tp = _params(jobj), _params(tobj)
    if jp is None or tp is None:
        return
    for p in jp:
        if p not in tp and f"{key}({p})" not in OMITTED:
            gaps.append(f"{key}: no parameter {p!r} (port: {tp})")


def _has_member(cls, name):
    if hasattr(cls, name):
        return True
    if dataclasses.is_dataclass(cls) and name in {f.name for f in dataclasses.fields(cls)}:
        return True
    return name in getattr(cls, "_fields", ())


@pytest.mark.parametrize("sub", _jax_modules(), ids=lambda s: s or "top")
def test_public_names_have_counterparts(sub):
    jmod = importlib.import_module("cannoles_tpu" + (f".{sub}" if sub else ""))
    tsub = RENAMED.get(sub, sub)
    tmod = importlib.import_module("cannoles_tpu_torch" + (f".{tsub}" if tsub else ""))
    where = sub or "top"
    gaps = []
    for name in _public(jmod):
        key = f"{sub}.{name}" if sub else name
        if key in OMITTED:
            continue
        jobj, tobj = getattr(jmod, name, None), getattr(tmod, name, None)
        if tobj is None:
            gaps.append(f"{key}: missing")
            continue
        if callable(jobj) and not inspect.isclass(jobj):
            _missing_params(jobj, tobj, key, gaps)
        if not inspect.isclass(jobj):
            continue
        _missing_params(jobj, tobj, key, gaps)
        home = f"{jobj.__module__[len('cannoles_tpu.'):]}.{name}" if jobj.__module__ != "cannoles_tpu" else key
        for meth, jm in vars(jobj).items():
            mkey = f"{home}.{meth}"
            if meth.startswith("_") or mkey in OMITTED:
                continue
            if not _has_member(tobj, meth):
                gaps.append(f"{mkey}: missing")
            elif inspect.isfunction(jm):
                _missing_params(jm, getattr(tobj, meth), mkey, gaps)
    assert not gaps, f"{where}: " + "; ".join(gaps)


def _jax_member(path):
    parts = path.split(".")
    for k in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module("cannoles_tpu." + ".".join(parts[:k]))
        except ImportError:
            continue
        for attr in parts[k:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(path)


def test_omissions_name_real_jax_members():
    """Every entry of OMITTED names something the JAX package has."""
    for key in OMITTED:
        path, _, param = key.partition("(")
        obj = _jax_member(path)
        if param:
            assert param.rstrip(")") in inspect.signature(obj).parameters, key


# ---- values of the names the port gained last ----

@pytest.fixture(scope="module")
def hs26():
    from cannoles_tpu.models.hs import hs_problem as jhs
    from cannoles_tpu_torch.models.hs import hs_problem as ths

    return jhs("hs26"), ths("hs26", device="cpu")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


def _draw(*sizes):
    rng = np.random.default_rng(3)
    return [rng.normal(size=s) for s in sizes]


def test_problem_J_and_F_and_J_match_jax(hs26):
    pj, pt = hs26
    (x,) = _draw(pj.nvar)
    xt = torch.as_tensor(x)[None]
    J = pt.J(xt)
    Fx, J2 = pt.F_and_J(xt)
    assert J.shape == (1, pj.nequ, pj.nvar)
    _close(J[0], pj.J(jnp.asarray(x)))
    Fj, Jj = pj.F_and_J(jnp.asarray(x))
    _close(Fx[0], Fj)
    _close(J2[0], Jj)
    # batch-leading: lane by lane the single-lane values
    xs = np.stack([x, x + 0.1])
    Jb = pt.J(torch.as_tensor(xs))
    assert Jb.shape == (2, pj.nequ, pj.nvar)
    _close(Jb[1], pj.J(jnp.asarray(xs[1])))


def test_jtprod_keyword_v_matches_jax(hs26):
    pj, pt = hs26
    x, v, w = _draw(pj.nvar, pj.nequ, pj.ncon)
    xt = torch.as_tensor(x)[None]
    _close(pt.jtprod_res(xt, v=torch.as_tensor(v)[None])[0], pj.jtprod_res(jnp.asarray(x), v=jnp.asarray(v)))
    _close(pt.jtprod_cons(xt, v=torch.as_tensor(w)[None])[0], pj.jtprod_cons(jnp.asarray(x), v=jnp.asarray(w)))


@pytest.mark.parametrize("backend", ["ldlt", "eigh"])
@pytest.mark.parametrize("eigs", [(3, 2, 1.5, 1, 0.8, 0.6, 0.5), (3, 2, 1.5, 1, -1, -2, -2.5)],
                         ids=["spd", "kkt_inertia"])
def test_factorize_and_factor_solve_match_jax(backend, eigs):
    """A = Q diag(eigs) Qᵀ: the inertia test passes with nvar = 4 positive
    and 3 negative eigenvalues and fails on the SPD one."""
    from cannoles_tpu.ops import ldlt as jl
    from cannoles_tpu_torch.ops import ldlt as tl

    N, nvar, tol = 7, 4, 1e-12
    G, b = _draw((N, N), N)
    Q = np.linalg.qr(G)[0]
    A = Q @ np.diag(eigs) @ Q.T
    A = (A + A.T) / 2
    jf, jok = jl.factorize(jnp.asarray(A), tol, nvar, backend=backend)
    tf, tok = tl.factorize(torch.as_tensor(A)[None], tol, nvar, backend=backend)
    assert bool(tok[0]) == bool(jok) == (min(eigs) < 0)
    x = tl.factor_solve(tf, torch.as_tensor(b)[None], tol, backend=backend)[0]
    _close(x, jl.factor_solve(jf, jnp.asarray(b), tol, backend=backend))
    if backend == "ldlt":
        _close(tf.vec[0], jf.vec)  # the raw pivots
        _close(tf.mat[0], jf.mat)
    else:
        _close(tf.vec[0], jf.vec)  # the eigenvalues
    with pytest.raises(ValueError):
        tl.factorize(torch.as_tensor(A)[None], tol, nvar, backend="lu")


def test_cpp_available_and_native_lib_path():
    from cannoles_tpu_torch.ops import cpp_ldlt

    ok = cpp_ldlt.cpp_available()
    assert ok == (shutil.which("g++") is not None)
    path = cpp_ldlt.native_lib_path()
    assert path == cpp_ldlt.lib_path() and path.suffix == ".so"
    assert path.exists() == ok
