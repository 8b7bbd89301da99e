"""The port's row-sharded solve (``parallel/schur.py``) against the JAX
package's on its 8 virtual CPU devices.

The port runs as 4 spawned gloo ranks on the CPU, and as 2 of them over a
subgroup (``parallel.launch``; the ranks' programs are in
``tests/torch_ranks.py``, which never imports JAX).
Every problem of ``tests/test_schur.py``, the row-sharded BA scene of
``tests/test_families.py`` and a fit whose residual is not row-local
(y − mean(y): JAX's GSPMD sums over every row) go through both packages
from the same numpy inputs: status, iter, nfact, nlinsolve and nbk equal to JAX's sharded run
on its 8 devices.  x and λ are held to 1e-10, or, where that is larger, to
four times JAX's own spread: the largest gap between JAX's sharded runs on
1, 2, 4 and 8 devices (the same program, its row sums added in other
orders).  The curve fit needs the latter: its Gauss–Newton stops where x is
fixed only to ~1e-9 by the order of those sums.  Readings on this
container's CPU: JAX's spread 4.3e-10, the port's own over 1, 2, 4 and 8
ranks 1.9e-9, port vs JAX at most 1.6e-9; the other problems agree to
1e-10.  Every rank returns the same bits, also where one rank alone
spends its time budget, stops from its callback or logs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402

import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch.parallel.launch import launch  # noqa: E402
from cannoles_tpu_torch.parallel.mesh import make_row_mesh  # noqa: E402
from cannoles_tpu_torch.parallel.schur import solve_row_sharded  # noqa: E402

RANKS = 4
KEYS = ("status", "iter", "nfact", "nlinsolve", "nbk")


@pytest.fixture(scope="module")
def ranks():
    """Every case of ``torch_ranks.schur_cases`` on 4 ranks, and on 2 of
    them, in one launch: {k: [rank 0's cases, ...]}."""
    runs = launch(torch_ranks.schur_by_size, RANKS, (RANKS, 2))
    return {k: [r[k] for r in runs[:k]] for k in (RANKS, 2)}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded runs of each case on 8, 4, 2 and 1 devices."""
    import jax
    import jax.numpy as jnp

    from cannoles_tpu import nls_problem
    from cannoles_tpu.models.families import bundle_adjustment
    from cannoles_tpu.parallel.schur import make_row_mesh as jmesh
    from cannoles_tpu.parallel.schur import solve_row_sharded as jsolve

    t, y = torch_ranks.curvefit_data(8192)
    fit = nls_problem(
        lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) + x[2] * jnp.exp(-x[3] * d["t"]) + x[4] - d["y"],
        jnp.array([1.0, 1.0, 0.5, 0.1, 0.0]), 8192, data={"t": jnp.asarray(t), "y": jnp.asarray(y)},
        name="curvefit",
    )
    t, y = torch_ranks.constrained_data(4096)
    con = nls_problem(
        lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) - d["y"], jnp.array([1.0, 0.0]), 4096,
        lambda x, d: jnp.array([x[0] - 2 * x[1]]), [-0.1], [-0.1],
        data={"t": jnp.asarray(t), "y": jnp.asarray(y)},
    )
    ba, _ = bundle_adjustment(n_cams=4, n_pts=16, noise=0.0)
    t, y = torch_ranks.constrained_data(4096)
    centered = nls_problem(
        lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) + x[2] - (d["y"] - d["y"].mean()),
        jnp.array([1.0, 0.0, 0.0]), 4096, data={"t": jnp.asarray(t), "y": jnp.asarray(y)},
    )
    out = {}
    for name, pb, kw in (("curvefit", fit, dict(method="gauss_newton")), ("constrained", con, {}),
                         ("ba", ba, dict(method="gauss_newton")), ("centered", centered, dict(method="gauss_newton", **torch_ranks.CENTERED_TOL))):
        out[name] = [torch_ranks._stats(jsolve(pb, jmesh(jax.devices()[:n]), **kw)) for n in (8, 4, 2, 1)]
    return out


def _gap(a, b):
    return float(np.abs(a - b).max(initial=0.0))


def _x_bar(jax_runs):
    spread = max(_gap(a[key], b[key]) for a in jax_runs for b in jax_runs for key in ("x", "lam"))
    return max(1e-10, 4 * spread)


@pytest.mark.parametrize("case", ["curvefit", "constrained", "ba", "centered"])
@pytest.mark.parametrize("k", [RANKS, 2])
def test_row_sharded_matches_jax(case, k, ranks, jax_runs):
    jx = jax_runs[case][0]
    got = ranks[k][0][case]
    assert [got[key] for key in KEYS] == [jx[key] for key in KEYS], (got, jx)
    assert _gap(got["x"], jx["x"]) <= _x_bar(jax_runs[case])
    assert _gap(got["lam"], jx["lam"]) <= _x_bar(jax_runs[case])


def test_row_sharded_matches_unsharded(ranks):
    """``tests/test_schur.py::test_row_sharded_matches_unsharded``: the
    sharded fit equals the port's own one-process condensed solve."""
    got = ranks[RANKS][0]["curvefit"]
    assert got["status"] in ("first_order", "small_residual")
    assert np.allclose(got["x"], torch_ranks.CURVE_TRUE, atol=1e-5)
    ref = tc.CaNNOLeSSolver(torch_ranks.curvefit_problem(8192), method="gauss_newton",
                            kkt="condensed").solve()
    assert np.allclose(got["x"], ref.solution, atol=1e-8)
    assert got["iter"] == ref.iter


def test_row_sharded_constrained(ranks):
    got = ranks[RANKS][0]["constrained"]
    assert got["status"] == "first_order"
    assert abs(got["x"][0] - 2 * got["x"][1] + 0.1) < 1e-8
    assert np.allclose(got["x"], [2.5, 1.3], atol=1e-2)


def test_bundle_adjustment_row_sharded(ranks):
    """``tests/test_families.py::test_bundle_adjustment_row_sharded``: the
    projection reads every point, so each rank evaluates the whole residual
    and keeps its rows (``parallel.mesh.row_block``)."""
    _, x_true = tc.models.families.bundle_adjustment(n_cams=4, n_pts=16, noise=0.0, device="cpu")
    got = ranks[RANKS][0]["ba"]
    assert got["status"] == "first_order"
    assert np.abs(got["x"] - x_true).max() < 1e-3


def test_row_sharded_requires_data():
    pb = tc.nls_problem(lambda x: x - 1.0, np.zeros(3), 3, device="cpu")
    with pytest.raises(ValueError, match="per-residual"):
        solve_row_sharded(pb, make_row_mesh(device="cpu"))


def test_row_sharded_uneven_rows_raise(ranks):
    """m = 8191 over 4 ranks raises on every rank, as JAX's device_put does
    for 4095 rows over its 8 devices."""
    import jax
    import jax.numpy as jnp

    from cannoles_tpu import nls_problem
    from cannoles_tpu.parallel.schur import make_row_mesh as jmesh
    from cannoles_tpu.parallel.schur import solve_row_sharded as jsolve

    t, y = torch_ranks.constrained_data(4095)
    pb = nls_problem(lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) - d["y"], jnp.array([1.0, 0.0]), 4095,
                     data={"t": jnp.asarray(t), "y": jnp.asarray(y)})
    with pytest.raises(ValueError, match="should be divisible by 8"):
        jsolve(pb, jmesh())
    assert len(jax.devices()) == 8
    for k in (RANKS, 2):
        for r in ranks[k]:
            assert r["uneven"] is not None and f"should be divisible by {k}" in r["uneven"]


@pytest.mark.parametrize("k", [RANKS, 2])
def test_every_rank_returns_the_same_bits(k, ranks):
    first = ranks[k][0]
    for other in ranks[k][1:]:
        for case in ("curvefit", "constrained", "ba", "centered"):
            a, b = first[case], other[case]
            assert [a[key] for key in KEYS] == [b[key] for key in KEYS]
            assert np.array_equal(a["x"], b["x"]) and np.array_equal(a["lam"], b["lam"])


def test_one_rank_mesh_is_the_unsharded_solve():
    """Without a process group the mesh has one rank, every collective is
    the identity, and the solve is bit for bit the condensed solve."""
    pb = torch_ranks.constrained_problem(512)
    mesh = make_row_mesh(device="cpu")
    assert mesh.size == 1
    got = solve_row_sharded(pb, mesh, max_iter=50)
    s = tc.CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed")
    st = s.run(pb.x0[None], pb.y0[None], s.make_config(max_iter=50),
               {k: v[None] for k, v in pb.data.items()})
    assert np.array_equal(got.solution, st.x[0].numpy()) and got.iter == int(st.iter[0])
    with pytest.raises(ValueError, match="condensed"):
        tc.CaNNOLeSSolver(pb, method="gauss_newton", kkt="full", mesh=mesh)
    with pytest.raises(ValueError, match="condensed"):
        solve_row_sharded(pb, mesh, solver=tc.CaNNOLeSSolver(pb, method="gauss_newton"))


def test_residual_error_on_the_whole_data_is_raised():
    """The row-locality trial evaluates the residual on the whole data too;
    an error there is the residual's own and reaches the caller."""

    def residual(x, d):
        if d["t"].shape[0] == 512:
            raise RuntimeError("residual fails on the whole data")
        return x[0] * d["t"] - d["y"]

    t, y = torch_ranks.constrained_data(512)
    pb = tc.nls_problem(residual, [1.0], 512, data={"t": torch.as_tensor(t), "y": torch.as_tensor(y)},
                        device="cpu")
    with pytest.raises(RuntimeError, match="whole data"):
        solve_row_sharded(pb, make_row_mesh(device="cpu"))


@pytest.fixture(scope="module")
def stops():
    return launch(torch_ranks.stop_cases, RANKS)


@pytest.mark.parametrize("engine", ["dense", "matfree"])
@pytest.mark.parametrize("case,status,it", [("budget", "max_time", 1), ("budget_in_step", "max_time", 1),
                                            ("user", "user", 1), ("verbose", "max_iter", 5)])
def test_one_rank_stop_stops_every_rank(engine, case, status, it, stops):
    """``torch_ranks.stop_cases``: a budget, a callback's stop or a log row
    asked for by one rank only.  Every rank returns (none waits in an
    all-reduce that the others skipped), with the same status, step and
    bits; a budget spent inside step 2 drops that step on every rank."""
    first = stops[0][engine, case]
    assert (first["status"], first["iter"]) == (status, it), first
    for other in stops[1:]:
        got = other[engine, case]
        assert [got[key] for key in KEYS] == [first[key] for key in KEYS]
        assert np.array_equal(got["x"], first["x"]) and np.array_equal(got["lam"], first["lam"])
