"""PyTorch port, batched solves against JAX ``vsolve`` in float64: per-lane
status, counters and internal message equal, solutions within 1e-10.  The
JAX side reaches the Pallas kernel in interpret mode through its
``custom_vmap`` rule; the port runs the kernel's plain version on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models.families import bundle_adjustment_batch as jba_batch  # noqa: E402
from cannoles_tpu.parallel.batch import vsolve as jvsolve  # noqa: E402
from cannoles_tpu_torch.core import segments  # noqa: E402
from cannoles_tpu_torch.models.families import (  # noqa: E402
    bundle_adjustment_batch as tba_batch,
    lm_bench_batch,
    lm_bench_family,
)
from cannoles_tpu_torch.parallel.mesh import make_batch_mesh  # noqa: E402

FIELDS = ("status", "iter", "nfact", "nbk", "nlinsolve", "msg", "neval_F", "neval_c")


def jax_bench_family():
    """bench.py's build_problem in float64."""
    return jc.nls_problem(
        lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]]),
        jnp.array([-1.2, 1.0]), 2,
        lambda x, d: jnp.array([x[0] + x[1] - d[2]]), [0.0], [0.0],
        data=jnp.zeros((3,)), name="bench_lm_family",
    )


def assert_lanes_equal(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(b.states, f).numpy(), np.asarray(getattr(a.states, f)),
                                      err_msg=f)
    ok = a.solved_mask()
    np.testing.assert_array_equal(b.solved_mask(), ok)
    np.testing.assert_allclose(b.solution[ok], a.solution[ok], rtol=0, atol=1e-10)
    # λ is pinned down only to the dual tolerance of the first-order exit
    # (ε_tol = √eps·(1 + ‖∇L₀‖) ≈ 1.5e-8·(1 + ‖∇L₀‖) in float64)
    np.testing.assert_allclose(b.multipliers[ok], a.multipliers[ok], rtol=0, atol=1e-8)
    assert b.summary() == a.summary()


def run_bench(x0, d, **kw):
    pj, pt = jax_bench_family(), lm_bench_family(torch.float64, "cpu")
    sj = jc.CaNNOLeSSolver(pj, method="lm", linsolve="pallas", kkt="full")
    st = tc.CaNNOLeSSolver(pt, method="lm", linsolve="pallas", kkt="full")
    a = jvsolve(pj, jnp.asarray(x0), data_batch=jnp.asarray(d), solver=sj, max_iter=50, rescue=True, **kw)
    b = tc.vsolve(pt, x0, data_batch=d, solver=st, max_iter=50, rescue=True, **kw)
    return a, b, st


def test_vsolve_bench_family_matches_jax():
    x0, d = lm_bench_batch(8)
    before = segments.counters()["fused_ldlt"]
    a, b, _ = run_bench(x0, d)
    assert_lanes_equal(a, b)
    assert segments.counters()["fused_ldlt"] == before  # the CPU runs the plain version


def test_vsolve_rescue_budget_stage_matches_jax():
    """max_eval=10 caps every lane, so rescue stage 0 re-solves them all
    with the lifted budgets."""
    x0, d = lm_bench_batch(8)
    a, b, st = run_bench(x0, d, max_eval=10)
    assert_lanes_equal(a, b)
    pre = tc.vsolve(st.problem, x0, data_batch=d, solver=st, max_iter=50, max_eval=10)
    assert (pre.status == int(tc.Status.MAX_EVAL)).any()
    assert b.solved_mask().all()


def test_vsolve_poisoned_lane_matches_jax():
    x0, d = lm_bench_batch(8)
    d[3, 0] = np.nan
    a, b, _ = run_bench(x0, d)
    assert_lanes_equal(a, b)
    assert b.status[3] == int(tc.Status.EXCEPTION)
    assert np.delete(b.solved_mask(), 3).all()


def test_vsolve_bundle_adjustment_matches_jax():
    pj, x0j, dj, _ = jba_batch(4, 2, 5)
    pt, x0t, dt, _ = tba_batch(4, 2, 5, device="cpu")
    sj = jc.CaNNOLeSSolver(pj, method="gauss_newton", kkt="condensed", linsolve="pallas")
    st = tc.CaNNOLeSSolver(pt, method="gauss_newton", kkt="condensed", linsolve="pallas")
    assert st.quality_gate and sj.quality_gate  # N = 34 ≥ 16
    a = jvsolve(pj, x0j, data_batch=dj, solver=sj, max_iter=40)
    b = tc.vsolve(pt, x0t, data_batch=dt, solver=st, max_iter=40)
    assert_lanes_equal(a, b)


def test_vsolve_chunks_and_auto_routing():
    """Sequential chunks give the lanes of one flat batch; 'auto' routes a
    small KKT to the fused kernel; a one-rank batch mesh (no process group)
    gives the flat batch too (many ranks: tests/test_torch_multihost.py)."""
    x0, d = lm_bench_batch(8, seed=2)
    pt = lm_bench_family(torch.float64, "cpu")
    flat = tc.vsolve(pt, x0, data_batch=d, method="lm", max_iter=50)
    chunked = tc.vsolve(pt, x0, data_batch=d, method="lm", max_iter=50, chunk_size=4)
    assert flat.solver.linsolve == "pallas" and flat.solver.kkt == "full"
    for f in FIELDS + ("x", "lam"):
        assert torch.equal(getattr(flat.states, f), getattr(chunked.states, f)), f
    with pytest.warns(UserWarning, match="chunk_size=3 ignored"):
        tc.vsolve(pt, x0, data_batch=d, method="lm", max_iter=50, chunk_size=3)
    mesh = make_batch_mesh(device="cpu")
    assert mesh.size == 1
    meshed = tc.vsolve(pt, x0, data_batch=d, method="lm", max_iter=50, mesh=mesh)
    for f in FIELDS + ("x", "lam"):
        assert torch.equal(getattr(flat.states, f), getattr(meshed.states, f)), f


def _family_pair():
    """``_family`` of tests/test_batch.py in both packages."""
    pj = jc.nls_problem(
        lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]), jnp.array([-1.2, 1.0]), 2,
        lambda x, d: jnp.array([x[0] + x[1] - d[1]]), [0.0], [0.0], data=jnp.zeros((2,)), name="family",
    )
    pt = tc.nls_problem(
        lambda x, d: torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
        lambda x, d: torch.stack([x[0] + x[1] - d[1]]), [0.0], [0.0],
        data=torch.zeros(2, dtype=torch.float64), name="family", device="cpu",
    )
    return pj, pt


def test_vsolve_max_time_budget():
    """The wall-clock budget of tests/test_batch.py: with max_time=0 the
    first chunk is dispatched and every later lane is stamped max_time
    after one batched init; with a budget that never binds every lane
    solves.  Lane for lane equal to the JAX package in both cases (the last
    chunk is short: B = 14 in chunks of 4)."""
    pj, pt = _family_pair()
    B, chunk = 14, 4
    rng = np.random.default_rng(2)
    x0s = rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0])
    datas = np.ones((B, 2))
    for budget in (0.0, 600.0):
        a = jvsolve(pj, jnp.asarray(x0s), data_batch=jnp.asarray(datas), max_iter=100,
                    max_time=budget, chunk_size=chunk)
        b = tc.vsolve(pt, x0s, data_batch=datas, max_iter=100, max_time=budget, chunk_size=chunk)
        assert_lanes_equal(a, b)
        if budget == 0.0:
            assert b.solved_mask()[:chunk].all()
            assert (b.status[chunk:] == int(tc.Status.MAX_TIME)).all(), b.status
        else:
            assert b.solved_mask().all(), b.summary()


def test_vsolve_max_time_keeps_lanes_init_ended():
    """A lane that its init already ends (a poisoned lane: exception) keeps
    that status when its chunk is never dispatched."""
    x0, d = lm_bench_batch(8)
    d[6, 0] = np.nan
    pt = lm_bench_family(torch.float64, "cpu")
    b = tc.vsolve(pt, x0, data_batch=d, method="lm", max_iter=50, max_time=0.0, chunk_size=4)
    st = b.status
    assert st[6] == int(tc.Status.EXCEPTION)
    assert (np.delete(st[4:], 2) == int(tc.Status.MAX_TIME)).all(), st
    assert (b.states.iter[4:] == 0).all()


def _tall_pair():
    """``_tall_family`` of tests/test_round5.py (m = 62, n = 2) in both packages."""
    A = np.random.default_rng(0).normal(size=(62, 2))
    y = A @ np.array([1.0, -2.0])
    Aj, Ja = jnp.asarray(A), torch.as_tensor(A)
    pj = jc.nls_problem(lambda x, d: Aj @ x - jnp.asarray(y), jnp.zeros(2), 62, name="tall")
    pt = tc.nls_problem(lambda x, d: Ja @ x - torch.as_tensor(y), np.zeros(2), 62, name="tall",
                        device="cpu")
    return pj, pt


def test_vsolve_rescue_honored_under_deadline(monkeypatch):
    """rescue=True is not dropped under deadline dispatch: with budget left
    the rescue runs, restricted to the dispatched lanes (the case of
    tests/test_round5.py)."""
    from cannoles_tpu_torch.parallel import batch as batch_mod

    pj, pt = _tall_pair()
    calls = {}
    orig = batch_mod._rescue_unsolved

    def spy(solver, result, x0, lam0, data, cfg, **kw):
        calls["kw"] = kw
        return orig(solver, result, x0, lam0, data, cfg, **kw)

    monkeypatch.setattr(batch_mod, "_rescue_unsolved", spy)
    b = tc.vsolve(pt, np.zeros((4, 2)), method="gauss_newton", max_time=600.0, rescue=True, max_iter=50)
    assert "kw" in calls, "rescue pass never invoked under deadline dispatch"
    assert calls["kw"].get("eligible") is not None
    assert b.solved_mask().all()
    a = jvsolve(pj, jnp.zeros((4, 2)), method="gauss_newton", max_time=600.0, rescue=True, max_iter=50)
    assert_lanes_equal(a, b)
