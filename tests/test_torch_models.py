"""PyTorch port, the problem builders against the JAX package in float64:
every fixture of ``models/basic.py`` (and ``constrained`` of two bases in
both kinds), every spec of ``models/hs.py`` (16) and ``models/lvcon.py``
(5), and ``curve_fit_family``; the 55 specs of ``models/mgh.py`` are in
``test_torch_models_mgh.py``, through :func:`check_builder`.

F, Jᵀ, Jc, ``hess_res`` and ``hess_cons`` are compared at x0 and at a
numpy-seeded point near it, with seeded weights, to 1e-12 relative to the
largest entry of each array: the two packages evaluate the same formulas,
and their exp/log/pow and summation orders differ in the last bit only.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu.models as jm  # noqa: E402
import cannoles_tpu_torch.models as tm  # noqa: E402
from cannoles_tpu.models.families import curve_fit_family as jcurve  # noqa: E402
from cannoles_tpu_torch.models.families import curve_fit_family as tcurve  # noqa: E402

REL = 1e-12


CPU = dict(device="cpu")


def _pairs():
    """name → (JAX builder, port builder), each taking no argument."""
    cpu = CPU
    out = {}
    for name in ("readme_example", "rosenbrock_nls", "mgh01", "mgh01con", "mgh01_nofhess", "hs6",
                 "linear_nls", "chained_rosenbrock", "underdetermined"):
        out[f"basic:{name}"] = (getattr(jm, name), lambda name=name: getattr(tm, name)(**cpu))
    for base in ("rosenbrock_nls", "chained_rosenbrock"):
        for kind in ("linear", "quad"):
            out[f"constrained:{base}+{kind}"] = (
                lambda base=base, kind=kind: jm.constrained(getattr(jm, base)(), kind),
                lambda base=base, kind=kind: tm.constrained(getattr(tm, base)(**cpu), kind),
            )
    for js, ts in zip(jm.hs_suite(), tm.hs_suite()):
        out[f"hs:{ts.name}"] = (js.make, lambda ts=ts: ts.make(**cpu))
    for name in tm.LVCON_NAMES:
        out[f"lvcon:{name}"] = (lambda name=name: jm.lvcon_problem(name),
                                lambda name=name: tm.lvcon_problem(name, **cpu))
    out["curve_fit_family"] = (lambda: jcurve(64, jnp.float64), lambda: tcurve(64, torch.float64, **cpu))
    return out


PAIRS = _pairs()


def _close(got, ref, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * scale, err_msg=what)


def check_builder(name, mj, mt):
    """Dimensions, name, x0 and every evaluator of the two builders'
    problems at x0 and at a seeded point (the JAX side jitted, as its
    solver runs it)."""
    pj, pt = mj(), mt()
    assert (pt.nvar, pt.nequ, pt.ncon, pt.name) == (pj.nvar, pj.nequ, pj.ncon, pj.name)
    assert pt.has_residual_hessian == pj.has_residual_hessian
    assert pt.x0.dtype == torch.float64 and pt.x0.device.type == "cpu"
    x0 = np.asarray(pj.x0, dtype=float)
    np.testing.assert_array_equal(pt.x0.numpy(), x0)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = np.stack([x0, x0 + 0.1 * rng.normal(size=x0.shape) * np.maximum(1.0, np.abs(x0))])
    w = rng.normal(size=(2, pj.nequ))
    y = rng.normal(size=(2, pj.ncon))
    dj = pj.data
    dt = None if pt.data is None else {k: v.expand((2,) + v.shape) for k, v in pt.data.items()}
    xj, xt = jnp.asarray(x), torch.as_tensor(x)

    def ref(fn, *args):
        return jax.jit(jax.vmap(lambda *a: getattr(pj, fn)(*a, dj)))(*args)

    _close(pt.F(xt, dt), ref("F", xj), "F")
    _close(pt.Jt(xt, dt), ref("Jt", xj), "Jt")
    _close(pt.c_shifted(xt, dt), ref("c_shifted", xj), "c_shifted")
    _close(pt.Jc(xt, dt), ref("Jc", xj), "Jc")
    if pj.has_residual_hessian:
        _close(pt.hess_res(xt, torch.as_tensor(w), dt), ref("hess_res", xj, jnp.asarray(w)), "hess_res")
    _close(pt.hess_cons(xt, torch.as_tensor(y), dt), ref("hess_cons", xj, jnp.asarray(y)), "hess_cons")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_builder_matches_jax(name):
    check_builder(name, *PAIRS[name])


def test_registries_match_jax():
    assert tm.MGH_NAMES == jm.MGH_NAMES
    assert tm.HS_NAMES == jm.HS_NAMES
    assert tm.LVCON_NAMES == jm.LVCON_NAMES
    assert [(s.name, s.fmin) for s in tm.mgh_suite(True)] == [(s.name, s.fmin) for s in jm.mgh_suite(True)]
    assert [(s.name, s.fstar) for s in tm.hs_suite()] == [(s.name, s.fstar) for s in jm.hs_suite()]
    assert sorted(tm.__all__) == sorted(jm.__all__)
    with pytest.raises(KeyError):
        tm.lvcon_problem("nope", device="cpu")


def test_lvcon_scales_with_n():
    """One structure at n = 50: the gather/slice constraint assembly."""
    pj = jm.lvcon_problem("lvcon_powell_banded", n=50)
    pt = tm.lvcon_problem("lvcon_powell_banded", n=50, device="cpu")
    assert (pt.nvar, pt.nequ, pt.ncon) == (pj.nvar, pj.nequ, pj.ncon) == (50, 96, 48)
    x = np.asarray(pj.x0)[None] + 0.1
    _close(pt.Jc(torch.as_tensor(x)), jax.vmap(lambda z: pj.Jc(z, None))(jnp.asarray(x)), "Jc")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_builders_place_dtype(dtype):
    """A spec builds in the dtype it is given: x0, constants and values."""
    dt = getattr(torch, dtype)
    for make in (tm.mgh_suite(True)[19].make, tm.hs_suite()[5].make):
        pb = make(dtype=dt, device="cpu")
        assert pb.x0.dtype == dt
        assert pb.F(pb.x0[None]).dtype == dt
    pb = tm.lvcon_problem("lvcon_powell_banded", dtype=dt, device="cpu")
    assert pb.c_shifted(pb.x0[None]).dtype == dt
    assert tm.constrained(tm.mgh01(dtype=dt, device="cpu")).lcon.dtype == dt
