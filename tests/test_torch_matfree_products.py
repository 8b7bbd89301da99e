"""PyTorch port, the matrix-free products of ``NLSProblem`` against the JAX
package in float64 (the 8 tests of ``tests/test_matfree.py``).

Each product of the port (batched over ``(x, data)``) is held to the JAX
package's product at the same numpy-seeded point, to 1e-12 relative to the
result's scale, and to the port's own materialized Jacobian or Hessian.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu import nls_problem as jnls  # noqa: E402
from cannoles_tpu.models import mgh01con as jmgh01con  # noqa: E402
from cannoles_tpu_torch import nls_problem as tnls  # noqa: E402
from cannoles_tpu_torch.models.basic import mgh01con as tmgh01con  # noqa: E402

TOL = 1e-12


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()))


@pytest.fixture(scope="module")
def pbs():
    return jmgh01con(), tmgh01con(device="cpu")


def _draws(pb, *sizes):
    rng = np.random.default_rng(7)
    return [rng.normal(size=s) for s in sizes]


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64).unsqueeze(0)


def test_jprod_jtprod_residual(pbs):
    pj, pt = pbs
    x, v, w = _draws(pj, pj.nvar, pj.nvar, pj.nequ)
    _close(pt.jprod_res(_t(x), _t(v))[0], pj.jprod_res(jnp.asarray(x), jnp.asarray(v)))
    _close(pt.jtprod_res(_t(x), _t(w))[0], pj.jtprod_res(jnp.asarray(x), jnp.asarray(w)))
    Jt = pt.Jt(_t(x))[0].numpy()
    _close(pt.jprod_res(_t(x), _t(v))[0], Jt.T @ v)


def test_jprod_jtprod_cons(pbs):
    pj, pt = pbs
    x, v, w = _draws(pj, pj.nvar, pj.nvar, pj.ncon)
    _close(pt.jprod_cons(_t(x), _t(v))[0], pj.jprod_cons(jnp.asarray(x), jnp.asarray(v)))
    _close(pt.jtprod_cons(_t(x), _t(w))[0], pj.jtprod_cons(jnp.asarray(x), jnp.asarray(w)))
    Jc = pt.Jc(_t(x))[0].numpy()
    _close(pt.jtprod_cons(_t(x), _t(w))[0], Jc.T @ w)


def test_hprod_residual(pbs):
    pj, pt = pbs
    x, r, v = _draws(pj, pj.nvar, pj.nequ, pj.nvar)
    got = pt.hprod_res(_t(x), _t(r), _t(v))[0]
    _close(got, pj.hprod_res(jnp.asarray(x), jnp.asarray(r), jnp.asarray(v)))
    _close(got, pt.hess_res(_t(x), _t(r))[0].numpy() @ v)


def test_hprod_cons(pbs):
    pj, pt = pbs
    x, y, v = _draws(pj, pj.nvar, pj.ncon, pj.nvar)
    got = pt.hprod_cons(_t(x), _t(y), _t(v))[0]
    _close(got, pj.hprod_cons(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v)))
    _close(got, pt.hess_cons(_t(x), _t(y))[0].numpy() @ v)


def test_hprod_lagrangian(pbs):
    """∇²(σ·½‖F‖² + yᵀc) v against JAX's product and the assembled
    Gauss–Newton + curvature + constraint-curvature Hessian."""
    pj, pt = pbs
    x, y, v = _draws(pj, pj.nvar, pj.ncon, pj.nvar)
    sigma = 0.7
    got = pt.hprod_lag(_t(x), _t(y), _t(v), obj_weight=sigma)[0]
    _close(got, pj.hprod_lag(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v), obj_weight=sigma))
    J = pt.Jt(_t(x))[0].numpy().T
    F = pt.F(_t(x))
    H = sigma * (J.T @ J + pt.hess_res(_t(x), F)[0].numpy()) + pt.hess_cons(_t(x), _t(y))[0].numpy()
    _close(got, H @ v, 1e-10)


def _rosenbrock(mod, **kw):
    if mod == "jax":
        return jnls(lambda x: jnp.array([x[0] - 1.0, 10 * (x[1] - x[0] ** 2)]),
                    jnp.array([-1.2, 1.0]), 2, **kw)
    return tnls(lambda x: torch.stack([x[0] - 1.0, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                device="cpu", **kw)


def test_unconstrained_products_empty():
    pj, pt = _rosenbrock("jax"), _rosenbrock("torch")
    x, v = pt.x0.unsqueeze(0), torch.ones(1, 2, dtype=torch.float64)
    z = torch.zeros(1, 0, dtype=torch.float64)
    shapes = (pt.jprod_cons(x, v).shape, pt.jtprod_cons(x, z).shape, pt.hprod_cons(x, z, v).shape)
    ref = (pj.jprod_cons(pj.x0, jnp.ones(2)).shape, pj.jtprod_cons(pj.x0, jnp.zeros(0)).shape,
           pj.hprod_cons(pj.x0, jnp.zeros(0), jnp.ones(2)).shape)
    assert shapes == tuple((1,) + s for s in ref) == ((1, 0), (1, 2), (1, 2))
    _close(pt.jtprod_cons(x, z)[0], pj.jtprod_cons(pj.x0, jnp.zeros(0)))


def test_nofhess_hprod_raises():
    pj = _rosenbrock("jax", has_residual_hessian=False)
    pt = _rosenbrock("torch", has_residual_hessian=False)
    with pytest.raises(NotImplementedError):
        pj.hprod_res(pj.x0, jnp.zeros(2), jnp.ones(2))
    with pytest.raises(NotImplementedError):
        pt.hprod_res(pt.x0.unsqueeze(0), torch.zeros(1, 2, dtype=torch.float64),
                     torch.ones(1, 2, dtype=torch.float64))


def test_products_batched_over_x_and_data():
    """The counterpart of the JAX test's jit(vmap(jprod_res)): the port's
    products take a batch of points and of data leaves; each lane equals
    the JAX product of that lane."""
    rng = np.random.default_rng(7)
    B, n, m = 4, 3, 5
    xs, vs, ws = rng.normal(size=(B, n)), rng.normal(size=(B, n)), rng.normal(size=(B, m))
    A = rng.normal(size=(B, m, n))

    def jres(x, d):
        return jnp.sin(d["A"] @ x) + x[0] * x[1]

    def tres(x, d):
        return torch.sin(d["A"] @ x) + x[0] * x[1]

    pt = tnls(tres, np.zeros(n), m, data={"A": torch.as_tensor(A[0])}, device="cpu")
    data = {"A": torch.as_tensor(A)}
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    jp = pt.jprod_res(T(xs), T(vs), data)
    jt = pt.jtprod_res(T(xs), T(ws), data)
    hp = pt.hprod_res(T(xs), T(ws), T(vs), data)
    assert jp.shape == (B, m) and jt.shape == (B, n) and hp.shape == (B, n)
    for i in range(B):
        pj = jnls(jres, jnp.zeros(n), m, data={"A": jnp.asarray(A[i])})
        d = pj.data
        _close(jp[i], pj.jprod_res(jnp.asarray(xs[i]), jnp.asarray(vs[i]), d))
        _close(jt[i], pj.jtprod_res(jnp.asarray(xs[i]), jnp.asarray(ws[i]), d))
        _close(hp[i], pj.hprod_res(jnp.asarray(xs[i]), jnp.asarray(ws[i]), jnp.asarray(vs[i]), d))
