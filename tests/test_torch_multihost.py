"""The port's batch mesh and multi-process layer (``vsolve(mesh=...)``,
``parallel/multihost.py``) against the JAX package on its 8 virtual CPU
devices.

The port runs as 4 spawned gloo ranks on the CPU (``parallel.launch``; the
ranks' program is ``tests/torch_ranks.py``'s ``batch_cases``).  The batch of
``tests/test_batch.py::test_vsolve_sharded_over_mesh`` (B = 16, float64):
every lane's state equal bit for bit to the port's ``mesh=None`` run, and
status, counters and message equal to JAX's sharded run with solutions
within 1e-10 (as ``tests/test_torch_vsolve.py`` holds every batch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402

import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch.core.solver import TENSOR_FIELDS  # noqa: E402
from cannoles_tpu_torch.parallel.launch import launch  # noqa: E402
from cannoles_tpu_torch.parallel.multihost import init_distributed  # noqa: E402

RANKS = 4
FIELDS = ("status", "iter", "nfact", "nbk", "nlinsolve", "msg", "neval_F", "neval_c")


@pytest.fixture(scope="module")
def ranks():
    return launch(torch_ranks.batch_cases, RANKS)


@pytest.fixture(scope="module")
def jax_mesh_run():
    import jax.numpy as jnp

    from cannoles_tpu import nls_problem
    from cannoles_tpu.parallel.batch import make_batch_mesh, vsolve

    pb = nls_problem(
        lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]), jnp.array([-1.2, 1.0]), 2,
        lambda x, d: jnp.array([x[0] + x[1] - d[1]]), [0.0], [0.0], data=jnp.zeros((2,)), name="family",
    )
    x0, d = torch_ranks.family_batch()
    mesh = make_batch_mesh()
    return pb, mesh, vsolve(pb, jnp.asarray(x0), data_batch=jnp.asarray(d), mesh=mesh, max_iter=100)


def test_vsolve_mesh_equals_unsharded_lane_by_lane(ranks):
    """Every rank returns the whole batch, bit for bit the one-process run."""
    x0, d = torch_ranks.family_batch()
    ref = tc.vsolve(torch_ranks.family_problem(), x0, data_batch=d, max_iter=100)
    for r in ranks:
        for f in TENSOR_FIELDS:
            np.testing.assert_array_equal(r["states"][f], getattr(ref.states, f).numpy(), err_msg=f)


def test_vsolve_mesh_matches_jax(ranks, jax_mesh_run):
    """``tests/test_batch.py::test_vsolve_sharded_over_mesh`` in both packages."""
    _, _, a = jax_mesh_run
    got = ranks[0]["states"]
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(a.states, f)), err_msg=f)
    solved = (got["status"] == 1) | (got["status"] == 2)
    assert solved.all()
    np.testing.assert_allclose(got["x"], a.solution, rtol=0, atol=1e-10)
    assert np.allclose(got["x"].sum(axis=1), 1.0, atol=1e-6)


def test_vsolve_mesh_rescue_equals_unsharded(ranks):
    """rescue=True under a mesh: each rank rescues its own lanes."""
    x0, d = torch_ranks.family_batch()
    ref = tc.vsolve(torch_ranks.family_problem(), x0, data_batch=d, max_iter=3, rescue=True)
    for r in ranks:
        np.testing.assert_array_equal(r["rescued"], ref.status)


def test_batch_convergence_stats_matches_jax(ranks, jax_mesh_run):
    from cannoles_tpu.parallel.multihost import batch_convergence_stats

    _, mesh, a = jax_mesh_run
    want = batch_convergence_stats(a.states, mesh)
    for r in ranks:
        got = r["stats"]
        assert {k: got[k] for k in ("solved", "n", "total_iters")} == \
            {k: want[k] for k in ("solved", "n", "total_iters")}
        assert got["max_dual_feas"] == pytest.approx(want["max_dual_feas"], rel=0, abs=1e-10)
        st = r["states"]
        assert got["solved"] == int(((st["status"] == 1) | (st["status"] == 2)).sum())
        assert got["total_iters"] == int(st["iter"].sum())
        assert got["max_dual_feas"] == float(st["normdual"].max())


def test_vsolve_mesh_refusals(ranks, jax_mesh_run):
    """B not divisible by the ranks raises, as JAX's device_put does; a
    max_time budget requires mesh=None, as in JAX."""
    import jax.numpy as jnp

    from cannoles_tpu.parallel.batch import vsolve

    pb, mesh, _ = jax_mesh_run
    x0, d = torch_ranks.family_batch()
    with pytest.raises(ValueError, match="should be divisible by 8"):
        vsolve(pb, jnp.asarray(x0[:-1]), data_batch=jnp.asarray(d[:-1]), mesh=mesh, max_iter=100)
    with pytest.raises(ValueError, match="requires mesh=None"):
        vsolve(pb, jnp.asarray(x0), data_batch=jnp.asarray(d), mesh=mesh, max_time=1.0)
    for r in ranks:
        assert f"should be divisible by {RANKS}" in r["uneven"]
        assert "requires mesh=None" in r["max_time"]


def test_scaling_bench_inserts_single_device_baseline(ranks):
    """``tests/test_batch.py::test_scaling_bench_inserts_single_device_baseline``
    over the 4 ranks: the rows of 1, 2 and 4 ranks, the same on every rank."""
    rows = ranks[0]["scaling"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(r["baseline_devices"] == 1 for r in rows)
    assert rows[0]["efficiency"] == pytest.approx(1.0)
    assert all(r["scaling"] == rows for r in ranks)


def test_global_mesh_and_init_distributed_in_the_group(ranks):
    """Inside the ranks: init_distributed is a no-op on a group that is up,
    and the global batch mesh spans every rank."""
    assert [r["global_mesh"] for r in ranks] == [(RANKS, RANKS, i) for i in range(RANKS)]


def test_init_distributed_alone_is_a_noop(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    init_distributed()
    assert not dist.is_initialized()
