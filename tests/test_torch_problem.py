"""PyTorch port, problem evaluators: F, c_shifted, Jᵀ, Jc and the weighted
Hessians of the bench family and a small bundle-adjustment scene, batched,
against the JAX package at random points, to 1e-12 in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu import nls_problem as jnls  # noqa: E402
from cannoles_tpu.models.families import bundle_adjustment as jba  # noqa: E402
from cannoles_tpu_torch.models.families import bundle_adjustment as tba  # noqa: E402
from cannoles_tpu_torch.models.families import lm_bench_family  # noqa: E402

B = 4


def jax_bench_family():
    """bench.py's build_problem in float64."""
    return jnls(
        lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]]),
        jnp.array([-1.2, 1.0]), 2,
        lambda x, d: jnp.array([x[0] + x[1] - d[2]]), [0.0], [0.0],
        data=jnp.zeros((3,)), name="bench_lm_family",
    )


def _bench():
    rng = np.random.default_rng(3)
    x = rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0]
    d = rng.normal(size=(B, 3))
    return jax_bench_family(), lm_bench_family(torch.float64, "cpu"), x, d


def _ba():
    pj, _ = jba(2, 5, seed=1)
    pt, _ = tba(2, 5, seed=1, device="cpu")
    rng = np.random.default_rng(4)
    x = np.asarray(pj.x0) + 0.05 * rng.normal(size=(B, pj.nvar))
    d = {k: np.stack([np.asarray(v)] * B) for k, v in pj.data.items()}
    return pj, pt, x, d


FAMILIES = {"bench": _bench, "ba": _ba}
FUNCS = ["F", "c_shifted", "Jt", "F_and_Jt", "Jc", "hess_res", "hess_cons"]


@pytest.mark.parametrize("fn", FUNCS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluator_matches_jax(family, fn):
    pj, pt, x, d = FAMILIES[family]()
    rng = np.random.default_rng(5)
    dj = jax.tree.map(jnp.asarray, d)
    dt = jax.tree.map(torch.as_tensor, d)
    xt = torch.as_tensor(x)
    if fn == "hess_res":
        w = rng.normal(size=(B, pj.nequ))
        ref = jax.vmap(pj.hess_res)(jnp.asarray(x), jnp.asarray(w), dj)
        got = pt.hess_res(xt, torch.as_tensor(w), dt)
    elif fn == "hess_cons":
        w = rng.normal(size=(B, pj.ncon))
        ref = jax.vmap(pj.hess_cons)(jnp.asarray(x), jnp.asarray(w), dj)
        got = pt.hess_cons(xt, torch.as_tensor(w), dt)
    else:
        ref = jax.vmap(getattr(pj, fn))(jnp.asarray(x), dj)
        got = getattr(pt, fn)(xt, dt)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-12)


def test_unconstrained_problem_shapes_and_validation():
    from cannoles_tpu_torch import nls_problem

    pb = nls_problem(lambda x: torch.stack([x[0] - 1, x[1]]), np.zeros(2), 2, device="cpu")
    x = torch.zeros((3, 2), dtype=torch.float64)
    assert pb.c_shifted(x).shape == (3, 0)
    assert pb.Jc(x).shape == (3, 0, 2)
    assert pb.hess_cons(x, x[:, :0]).shape == (3, 2, 2)
    pb.validate_for_solve()
    bad = nls_problem(lambda x: x, np.zeros(2), 2, lambda x: x[:1], [0.0], [1.0], device="cpu")
    with pytest.raises(ValueError, match="inequalities"):
        bad.validate_for_solve()
    with pytest.raises(ValueError, match="lcon"):
        nls_problem(lambda x: x, np.zeros(2), 2, lambda x: x[:1], device="cpu")


def test_float32_jacobians_stay_float32():
    """A float32 residual or constraint that meets a Python float in a 0-d
    expression (``x[0] - 0.5``, ``2.5 * x[1]``) gets float32 Jacobians:
    PyTorch's forward mode makes those tangents float64."""
    from cannoles_tpu_torch import CaNNOLeSSolver, nls_problem

    pb = nls_problem(lambda x: torch.stack([2.5 * x[0], x[1] / 10.0]), [1.0, 2.0], 2,
                     lambda x: torch.stack([x[0] - 0.5]), [0.0], [0.0],
                     dtype=torch.float32, device="cpu")
    x = pb.x0[None]
    assert pb.Jt(x).dtype == pb.F_and_Jt(x)[1].dtype == pb.Jc(x).dtype == torch.float32
    assert CaNNOLeSSolver(pb).solve().status == "first_order"


def _builders():
    from cannoles_tpu_torch import nls_problem
    from cannoles_tpu_torch.models import basic, hs_problem, lvcon_problem, mgh_problem
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment
    from cannoles_tpu_torch.models.families import (
        bundle_adjustment, bundle_adjustment_batch, curve_fit_family, large_rung_problem,
        lm_bench_family)

    return {
        **{f"basic.{n}": getattr(basic, n) for n in (
            "readme_example", "rosenbrock_nls", "mgh01con", "mgh01_nofhess", "hs6", "linear_nls",
            "chained_rosenbrock", "underdetermined")},
        "mgh_problem": lambda **kw: mgh_problem("meyer", **kw),
        "mgh_suite make": lambda **kw: mgh_problem("watson_9", **kw),
        "hs_problem": lambda **kw: hs_problem("hs79", **kw),
        "lvcon_problem": lambda **kw: lvcon_problem("lvcon_powell_banded", **kw),
        "curve_fit_family": lambda **kw: curve_fit_family(16, **kw),
        "nls_problem": lambda **kw: nls_problem(lambda x: torch.stack([x[0] - 1, x[1]]),
                                                np.zeros(2), 2, **kw),
        "large_rung_problem": lambda **kw: large_rung_problem(m=16, n=4, **kw),
        "bundle_adjustment": lambda **kw: bundle_adjustment(2, 5, **kw),
        "bundle_adjustment_batch": lambda **kw: bundle_adjustment_batch(2, 2, 5, **kw),
        "large_bundle_adjustment": lambda **kw: large_bundle_adjustment(2, 6, **kw),
        "lm_bench_family": lambda **kw: lm_bench_family(torch.float64, **kw),
    }


def _x0(built):
    return (built[0] if isinstance(built, tuple) else built).x0


@pytest.mark.parametrize("name", sorted(_builders()))
def test_entry_point_without_card_raises_naming_cpu(name, monkeypatch):
    """The port runs on the card by default: with no CUDA device and no
    device given, each entry point raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _builders()[name]()


@pytest.mark.parametrize("name", sorted(_builders()))
def test_entry_point_builds_on_cpu_when_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x0 = _x0(_builders()[name](device="cpu"))
    assert x0.device.type == "cpu" and torch.isfinite(x0).all()
