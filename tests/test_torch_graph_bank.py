"""PyTorch port, the graph route's bank and ``linsolve="chol"`` at B > 1,
on the CPU against the eager route and the JAX package (float64).

* ``_cho_solve`` (at B > 1 two ``torch.linalg.solve_triangular`` calls,
  the structure of ``jax.scipy.linalg.cho_solve``; on a card cuBLAS's
  trsm, which a CUDA graph captures, where a batched
  ``torch.cholesky_solve`` goes to MAGMA and allocates inside the capture)
  gives ``torch.cholesky_solve``'s bits here (LAPACK's ``potrs`` is the
  same two trsm calls) and JAX's ``cho_solve`` to 1e-12;
* the exp-fit batch of the 2-D mesh's tests through ``vsolve`` with
  ``linsolve="chol"`` on the graph route's in-place bank (a stand-in
  replays each segment on the CPU, as in ``test_torch_host_path.py``)
  equals the eager route bit for bit and JAX's ``vsolve`` in status and
  counters, with the Cholesky kernels' plain versions too
  (``pallas_chol_min=0``);
* the bank keeps one buffer per data leaf whatever entries carry it,
  adopts the problem's own data in ``solve()`` and hands out states that
  carry the caller's data: on the large rung's problem its J-sized
  buffers are the three Jacobians that the eager route holds at the end
  of a step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.scipy.linalg as jsl  # noqa: E402
import torch_ranks  # noqa: E402

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.core.solver import _cho_solve  # noqa: E402
from cannoles_tpu_torch.models.families import large_rung_problem  # noqa: E402

KEYS = ("status", "iter", "nfact", "nlinsolve")


class _Replay:
    """A stand-in for a captured CUDA graph on the CPU: each replay runs the
    segment again and copies its results into the bank's buffers."""

    def __init__(self, bank, fn):
        self.bank, self.fn, self.replays, self.delta = bank, fn, 0, {}

    def replay(self):
        self.replays += 1
        segments._store(self.bank, self.fn(self.bank))


def _spd(B, n, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n + 3))
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(n)
    return torch.as_tensor(A, dtype=dtype), torch.as_tensor(rng.normal(size=(B, n)), dtype=dtype)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cho_solve_equals_cholesky_solve(dtype, B):
    """``_cho_solve`` gives ``torch.cholesky_solve``'s bits on the CPU at
    B = 1 (where it is that call) and B = 4 (two triangular solves:
    LAPACK's ``potrs`` is the same two trsm calls), at n = 2 (the exp-fit
    batch), 33 and 300."""
    for n in (2, 33, 300):
        A, b = _spd(B, n, dtype, seed=n)
        L = torch.linalg.cholesky(A)
        ref = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
        assert torch.equal(_cho_solve(L, b), ref), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cho_solve_matches_jax(dtype):
    """``_cho_solve`` against ``jax.scipy.linalg.cho_solve`` on the same
    factor, B = 4, n = 40: within 1e-12 relative in float64 and 1e-5 in
    float32 (two triangular solves each, the same order of operations, but
    other BLAS kernels)."""
    A, b = _spd(4, 40, dtype, seed=7)
    L = torch.linalg.cholesky(A)
    got = _cho_solve(L, b).numpy()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.stack([np.asarray(jsl.cho_solve((jnp.asarray(L[i].numpy(), jdt), True), jnp.asarray(b[i].numpy(), jdt)))
                    for i in range(4)])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _exp_fit(B, pallas_chol_min):
    """The exp-fit batch (``torch_ranks.exp_fit_batch``, float64, m = 32)
    through ``vsolve`` with ``linsolve="chol"`` on both routes (the graph
    route on the CPU stand-in); the solver of each."""
    t, y = torch_ranks.exp_fit_batch(B)
    pb = torch_ranks.exp_fit_problem(32)
    out = {}
    for route in ("graph", "eager"):
        s = tc.CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed",
                              pallas_chol_min=pallas_chol_min)
        s.route = route
        x0 = np.tile(pb.x0.numpy(), (B, 1))
        out[route] = (tc.vsolve(pb, x0, data_batch={"t": t, "y": y}, solver=s, max_iter=20).states, s)
    return out


@pytest.fixture(scope="module")
def jax_exp_fit():
    t, y = torch_ranks.exp_fit_batch(4)
    pb = jc.nls_problem(lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) - d["y"], jnp.array([1.0, 0.0]), 32,
                        data={"t": jnp.asarray(t[0]), "y": jnp.asarray(y[0])})
    res = jc.vsolve(pb, jnp.tile(jnp.array([1.0, 0.0]), (4, 1)), data_batch={"t": jnp.asarray(t), "y": jnp.asarray(y)},
                    method="gauss_newton", linsolve="chol", kkt="condensed", max_iter=20)
    return {k: np.asarray(getattr(res.states, k)) for k in ("x",) + KEYS}


@pytest.mark.parametrize("pallas_chol_min", [None, 0], ids=["cholesky", "kernels_plain"])
def test_chol_batch_graph_bank_equals_eager_and_jax(monkeypatch, jax_exp_fit, pallas_chol_min):
    """B = 4, float64: the in-place bank's states equal the eager route's
    bit for bit, with replays of the solve segments; status and counters
    equal JAX's, x within 1e-10 (with ``pallas_chol_min=0`` the n = 2
    block is padded to 128 and factored by the kernels' plain versions)."""
    monkeypatch.setattr(segments, "_capture", lambda bank, name, fn: _Replay(bank, fn))
    out = _exp_fit(4, pallas_chol_min)
    (g, sg), (e, _) = out["graph"], out["eager"]
    assert sg.graph_replays().get("solve0", 0) > 0
    for f in g._fields[:-1]:
        assert torch.equal(getattr(g, f), getattr(e, f)), f
    for k in KEYS:
        assert np.array_equal(getattr(g, k).numpy(), jax_exp_fit[k]), k
    assert set(g.status.tolist()) == {1}
    assert np.abs(g.x.numpy() - jax_exp_fit["x"]).max() <= 1e-10


def _storages(tree):
    return {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes() for x in segments._leaves(tree)}


def test_bank_shares_data_and_hands_out_the_callers(monkeypatch):
    """The large rung's problem at m = 512, n = 64 (float32, chol), three
    solves on one solver: on the graph route (the CPU stand-in) the banks
    hold no copy of the problem's data (``solve()`` adopts it) and three
    J-sized buffers, the state's Jacobian, its copy at the step's start
    and the one before the outer status (the eager route holds these three
    at the end of a step; before, each of ``s``, ``s_pre``, ``s_in`` and
    the data entry also held the data, 11 J with the two data matrices);
    ``last_state`` carries the problem's data, not a copy; ``run()``
    returns the caller's data batch.  Both routes give the same bits."""
    monkeypatch.setattr(segments, "_capture", lambda bank, name, fn: _Replay(bank, fn))
    m, n = 512, 64
    J = m * n * 4
    pb, _, _ = large_rung_problem(m, n, dtype=torch.float32, device="cpu")
    own = _storages(pb.data)
    states = {}
    for route in ("graph", "eager"):
        s = tc.CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", dtype=torch.float32)
        s.route = route
        sts = [s.solve(max_iter=30, max_time=600.0).status for _ in range(3)]
        assert sts == ["first_order"] * 3
        states[route] = s.last_state
        assert set(_storages(s.last_state.data)) <= set(own), route
        if route == "graph":
            held = {}
            for bank in s._banks.values():
                for k, v in vars(bank).items():
                    if not k.startswith("_"):
                        held.update(_storages(v))
            big = [p for p, nb in held.items() if nb >= J and p not in own]
            assert len(s._banks) == 1 and len(big) == 3, (len(s._banks), len(big))
            assert set(_storages(bank.data)) <= set(own)
        x0 = torch.zeros(2, n)
        data = {k: v.expand((2,) + tuple(v.shape)) for k, v in pb.data.items()}
        got = s.run(x0, torch.zeros(2, 0), s.make_config(max_iter=5), data)
        assert got.data is data, route
    a, b = states["graph"], states["eager"]
    for f in a._fields[:-1]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
