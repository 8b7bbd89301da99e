"""The port's 2-D (batch × rows) mesh against the JAX package's on its 8
virtual CPU devices, and the port's dry run of the three mesh axes.

JAX lays the exp-fit batch of its dry run out over a (batch, rows) mesh
with ``NamedSharding(P("batch", "rows"))`` and lets GSPMD insert the row
sums; the port runs 2 × 4 spawned gloo ranks (``parallel.make_mesh_2d``),
``vsolve`` splitting the lanes over ``batch`` and each lane's solver
(``CaNNOLeSSolver(mesh=rows)``) all-reducing over ``rows``.  From the same
numpy batch in float64: status, iter, nfact and nlinsolve equal per
instance, and x within the row-sharded bar of ``test_torch_schur.py``:
max(1e-10, 4 × JAX's own spread over its 2×4, 2×2 and 2×1 meshes).  Every
rank returns the same bits.  A residual that is not row-local (y −
mean(y)) must give the port's one-process answer (``row_block`` keeps the
whole data for it, and the data batch is not cut), and so must a
constraint that reads its lane's whole data and a batch that goes through
the rescue (its siblings on the same row mesh).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402

from cannoles_tpu_torch.dryrun import dryrun_multichip  # noqa: E402
from cannoles_tpu_torch.parallel.launch import launch  # noqa: E402
from cannoles_tpu_torch.parallel.mesh import make_mesh_2d  # noqa: E402

NB, NR = 2, 4
KEYS = ("status", "iter", "nfact", "nlinsolve")


@pytest.fixture(scope="module")
def ranks():
    return launch(torch_ranks.mesh2d_cases, NB * NR, NB, NR)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's 2-D run of the batch on (2, 4), (2, 2) and (2, 1) meshes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from cannoles_tpu import CaNNOLeSSolver, nls_problem

    t, y = torch_ranks.exp_fit_batch()
    B, m = t.shape
    pb = nls_problem(lambda x, d: x[0] * jnp.exp(-x[1] * d["t"]) - d["y"], jnp.array([1.0, 0.0]), m,
                     data={"t": jnp.asarray(t[0]), "y": jnp.asarray(y[0])})
    solver = CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed")
    cfg = solver.make_config(max_iter=20)
    step = jax.jit(lambda x0s, lam0s, data: jax.vmap(solver._run_compiled, in_axes=(0, 0, None, 0))(
        x0s, lam0s, cfg, data))
    out = []
    for nr in (4, 2, 1):
        mesh = Mesh(np.asarray(jax.devices()[:NB * nr]).reshape(NB, nr), axis_names=("batch", "rows"))
        br, bonly = NamedSharding(mesh, P("batch", "rows")), NamedSharding(mesh, P("batch"))
        st = step(jax.device_put(jnp.tile(jnp.array([1.0, 0.0]), (B, 1)), bonly),
                  jax.device_put(jnp.zeros((B, 0)), bonly),
                  {"t": jax.device_put(jnp.asarray(t), br), "y": jax.device_put(jnp.asarray(y), br)})
        out.append({k: np.asarray(getattr(st, k)) for k in ("x",) + KEYS})
    return out


def test_mesh2d_matches_jax(ranks, jax_runs):
    jx = jax_runs[0]
    got = ranks[0]["fit"]
    for k in KEYS:
        assert np.array_equal(got[k], jx[k]), (k, got[k], jx[k])
    assert set(got["status"].tolist()) == {1}
    spread = max(float(np.abs(a["x"] - b["x"]).max()) for a in jax_runs for b in jax_runs)
    assert float(np.abs(got["x"] - jx["x"]).max()) <= max(1e-10, 4 * spread)


def test_mesh2d_layout_and_same_bits(ranks):
    """Rank r sits at (r // nr, r % nr), as JAX's devs.reshape(nb, nr), and
    every rank returns the whole batch with the same bits."""
    assert [r["coords"] for r in ranks] == [(r // NR, r % NR, (NB, NR)) for r in range(NB * NR)]
    for case in torch_ranks.MESH2D_CASES:
        for other in ranks[1:]:
            for k, v in ranks[0][case].items():
                assert np.array_equal(v, other[case][k]), (case, k)


@pytest.mark.parametrize("case", ["centered", "constrained", "rescued"])
def test_mesh2d_equals_one_process(case, ranks):
    """y − mean(y) is not row-local: every rank runs it on its lanes' whole
    data and keeps its rows, so the answer is the unsharded one; a
    constraint that reads its lane's whole y gets it while the residual
    runs on its rows; the rescue's siblings run on the same row mesh."""
    one = torch_ranks.mesh2d_solve(None, case)
    got = ranks[0][case]
    for k in KEYS:
        assert np.array_equal(got[k], one[k]), (k, got[k], one[k])
    assert float(np.abs(got["x"] - one["x"]).max()) <= 1e-10
    if case != "rescued":
        assert set(got["status"].tolist()) <= {1, 2}


@pytest.mark.parametrize("key, what", [("uneven_B", "vsolve(mesh=...)"), ("uneven_m", "row-sharded solve")])
def test_mesh2d_uneven_raises(key, what, ranks):
    div = NB if key == "uneven_B" else NR
    for r in ranks:
        assert r[key] is not None and what in r[key] and f"should be divisible by {div}" in r[key]


def test_mesh2d_without_a_group():
    """Without a process group the 2-D mesh is 1 × 1 and the solve is the
    one-process solve bit for bit; a larger grid refuses."""
    mesh = make_mesh_2d(device="cpu")
    assert mesh.shape == (1, 1)
    got, one = torch_ranks.mesh2d_solve(mesh, "fit"), torch_ranks.mesh2d_solve(None, "fit")
    for k, v in one.items():
        assert np.array_equal(got[k], v), k
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_mesh_2d(2, 4, device="cpu")


def test_dryrun_multichip_passes_jax_asserts(capsys):
    """The port's dry run over 8 CPU ranks (nb = 2, nr = 4 on its 2-D axis)
    passes the JAX script's asserts and prints the three lines JAX's
    ``dryrun_multichip(8)`` prints on its 8 virtual CPU devices."""
    out = dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["dryrun_multichip(8): dp ok, solved 16/16, sharded == single-device",
                     "dryrun_multichip(8): rows ok, status=first_order",
                     "dryrun_multichip(8): 2-D mesh (2x4) ok, solved 4/4"]
    assert (out["2d"]["nb"], out["2d"]["nr"]) == (2, 4)
