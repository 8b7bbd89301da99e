"""The port's benchmark entry points at small sizes on the CPU:
``bench_large`` against the JAX package's ``CaNNOLeSSolver`` on the same
data, its ``--shard`` run on spawned CPU ranks against one process,
``scaling`` on 2 CPU ranks, ``bench_chol``'s plain versions, and every
entry point's refusal to run without a card unless asked for the CPU.

The JAX side of ``bench_large`` is ``benchmarks/bench_large.py``'s
problem and settings (float32 data from ``default_rng(0)``, Gauss–Newton,
condensed, ``chol``, ``block_size=128``, ``max_iter=30``).  Both packages
compute y = B1 x_true + 0.1 sin(B2 x_true) in float32 in their own order,
and sum JᵀJ in their own order: x within 1e-5 (the solution's |x| ≲ 3, so
about 80 float32 ulps), status, iter and nfact equal.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cannoles_tpu_torch import bench_chol, bench_large, scaling  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, N = 512, 64
MODULES = ("bench_large", "scaling", "bench_chol", "perf_profile", "mgh_battery", "dryrun")


@pytest.fixture(scope="module")
def one_process():
    return bench_large.run(M, N, device="cpu")


def test_bench_large_matches_jax(one_process):
    import jax
    import jax.numpy as jnp

    from cannoles_tpu import CaNNOLeSSolver, nls_problem

    rng = np.random.default_rng(0)
    B1 = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32) / np.sqrt(N), jnp.float32)
    B2 = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32) / np.sqrt(N), jnp.float32)
    xtrue = jnp.asarray(rng.normal(size=N).astype(np.float32))

    def model(x, t):
        return t["B1"] @ x + 0.1 * jnp.sin(t["B2"] @ x)

    data = {"B1": B1, "B2": B2}
    data["y"] = model(xtrue, data)
    pb = nls_problem(lambda x, d: model(x, d) - d["y"], jnp.zeros(N, jnp.float32), M, data=data)
    s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", block_size=128,
                       dtype=jnp.float32)
    st = s._run_fn(pb.x0, pb.y0.astype(jnp.float32), s.make_config(max_iter=30), pb.data)
    jax.block_until_ready(st.x)
    got = one_process
    assert got["status"] == "first_order" and int(st.status) == 1
    assert (got["iter"], got["nfact"]) == (int(st.iter), int(st.nfact))
    assert np.abs(got["x"] - np.asarray(st.x)).max() <= 1e-5
    assert got["err"] <= 1e-3 and got["cold_s"] > 0 and got["warm_s"] > 0


def test_bench_large_sharded_equals_one_process(one_process):
    """--shard 2 on CPU ranks: the counters of the one-process run, x to
    float32 rounding of the reordered row sums."""
    got = bench_large.run_sharded(2, M, N, device="cpu")
    assert got["ranks"] == 2 and not got["ranks_share_card"]
    for k in ("status", "iter", "nfact", "nlinsolve"):
        assert got[k] == one_process[k], k
    assert np.abs(got["x"] - one_process["x"]).max() <= 1e-5


def test_scaling_rows_on_cpu_ranks():
    rows = scaling.run(64, 2, device="cpu", reps=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["mesh"] == "virtual_cpu_shared_core" for r in rows)
    assert rows[0]["speedup"] == 1.0 and rows[0]["efficiency"] == 1.0
    assert all(r["throughput"] > 0 and r["time"] > 0 for r in rows)
    assert scaling.mesh_kind(2, "cpu") == "virtual_cpu_shared_core"


def test_bench_chol_plain_rows():
    rows = bench_chol.run((64, 200), device="cpu", log=None)
    assert [r["N"] for r in rows] == [64, 200]
    for r in rows:
        assert r["ok"] and r["rel_err"] <= 1e-4
        assert r["timed"] == "plain versions (CPU)" and r["kernel_ms"] is None and r["plain_ms"] > 0
        assert (r["launches_fused"], r["launches_block"]) == (0, 0)  # the CPU takes the plain versions
        assert r["route"] == "fused" and r["bound_by"] == "bytes"


def test_bench_chol_route_and_bound():
    """The JAX route rule: the fused kernel through N = 1280 in float32,
    the blocked route above; the bound turns to the operations at large N."""
    from cannoles_tpu_torch.ops import block_chol as bc

    assert [bc.uses_fused(N, torch.float32) for N in bench_chol.SIZES] == [True, True, True, False, False]
    assert bench_chol.bound_ms(4096)[1] == "operations"
    ms, _ = bench_chol.bound_ms(1024)
    assert ms == pytest.approx(1e3 * (1024 ** 3 / 3 + 8 * 128 ** 3 / 3) / 67e12)


@pytest.mark.parametrize("module", MODULES)
def test_entry_points_refuse_without_a_card(module):
    """Without --device cpu every entry point runs on the card, and here,
    without one, it exits 2 instead of going on on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert importlib.import_module(f"cannoles_tpu_torch.{module}").main([]) == 2


def test_entry_points_raise_without_a_card():
    from cannoles_tpu_torch import dryrun, mgh_battery, perf_profile

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: bench_large.run(M, N), lambda: bench_large.run_sharded(2, M, N),
                 lambda: scaling.run(64, 2), lambda: bench_chol.run((64,)),
                 lambda: perf_profile.run({"rosenbrock"}), lambda: mgh_battery.run({"rosenbrock"}),
                 lambda: dryrun.dryrun_multichip(2), lambda: dryrun.entry()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_entry_modules_never_import_jax():
    code = ("import sys\n"
            + "".join(f"import cannoles_tpu_torch.{m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cannoles_tpu.'))"
              " or m == 'cannoles_tpu']\nassert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(ROOT), timeout=300)
