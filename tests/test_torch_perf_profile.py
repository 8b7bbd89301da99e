"""The port's performance-profile runner against the JAX package's record.

``performance_profile`` equals ``benchmarks/perf_profile.py``'s on random
costs with failures.  Six problems of the battery go through the runner
(``cannoles_tpu_torch.perf_profile.run``, float64, the CPU), chosen
because they hold both kinds of disagreement in
``benchmarks/results_perf_profile_cpu.json``: ``rosenbrock`` (every column
solves), ``jennrich_sampson`` (Gauss–Newton and LM fail), ``gulf_10``
(scipy's LM fails), ``hs27`` (newton/full fails), ``hs61`` (SLSQP fails)
and ``beale+linear``.  Per problem and column, solved must equal the
record, and for the four solver columns ``neval_residual`` must equal its
``eval_costs``.  scipy's evaluation counts follow its own rounding and are
not compared.

Named rows (``NAMED_STATUS``): where the JAX package ends ``max_eval``
within 0.1 s on a CPU (100,027 or 50,003 residual evaluations), the port's B = 1 host loop reaches the runner's 30 s budget first
and ends ``max_time``: unsolved in both, so the profile is the same.  The
problems run in three spawned processes, so the three 30 s budgets
overlap.
"""

import functools
import importlib.util
import json
import multiprocessing
import pathlib
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cannoles_tpu_torch import perf_profile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = json.loads((ROOT / "benchmarks" / "results_perf_profile_cpu.json").read_text())
SIX = ("rosenbrock", "jennrich_sampson", "gulf_10", "hs27", "hs61", "beale+linear")
GROUPS = ({"jennrich_sampson"}, {"hs27", "rosenbrock"}, {"gulf_10", "hs61", "beale+linear"})
CONFIGS = [c for c, _ in perf_profile.CONFIGS]
# (problem, configuration) -> why the port's status differs from JAX's (both unsolved)
NAMED_STATUS = {
    ("jennrich_sampson", "gauss_newton/condensed"): "JAX: max_eval at iteration 7 in 0.08 s (100,027 evaluations)",
    ("jennrich_sampson", "lm/condensed"): "JAX: max_eval at iteration 7 in 0.06 s (100,027 evaluations)",
    ("hs27", "newton/full"): "JAX: max_eval at iteration 15 in 0.10 s (50,003 evaluations)",
}


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("perf_profile_jax", ROOT / "benchmarks" / "perf_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    """{problem: (part, the run's part dict, the problem's row in it, its
    four statuses and walls, the run's errors)}."""
    with ProcessPoolExecutor(len(GROUPS), mp_context=multiprocessing.get_context("spawn")) as ex:
        runs = list(ex.map(functools.partial(perf_profile.run, dtype=torch.float64, device="cpu", log=None),
                           GROUPS))
    out = {}
    for run in runs:
        for part in ("unconstrained", "constrained"):
            for i, name in enumerate(run[part]["problems"]):
                k = run["problems"].index(name)
                out[name] = (part, run[part], i, run["statuses"][k], run["walls"][k], run["errors"])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_performance_profile_equals_jax(seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.5, 50.0, size=(40, 6))
    costs[rng.random(costs.shape) < 0.25] = np.inf
    costs[3] = np.inf  # a problem no solver solves
    taus = perf_profile.TAUS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the all-failed row's nanmin
        want = _load_jax_script().performance_profile(costs, taus)
        got = perf_profile.performance_profile(costs, taus)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SIX)
def test_six_problems_match_the_record(name, port):
    part, run, i, statuses, walls, errors = port[name]
    rec = RECORD[part]
    k = rec["problems"].index(name)
    assert run["configs"] == rec["configs"]
    got_solved = np.isfinite(run["time_costs"][i]).tolist()
    want_solved = np.isfinite(rec["time_costs"][k]).tolist()
    assert got_solved == want_solved, (name, got_solved, want_solved)
    assert run["eval_costs"][i][:4] == rec["eval_costs"][k][:4], (name, run["eval_costs"][i], rec["eval_costs"][k])
    assert not [e for e in errors if e.startswith(name + " ")]
    for j, cname in enumerate(CONFIGS):
        if (name, cname) in NAMED_STATUS:
            # the runner keeps the status and the wall of a run that failed
            assert statuses[j] in ("max_time", "max_eval"), (name, cname, statuses[j])
            assert walls[j] <= 2 * perf_profile.MAX_TIME
        else:
            assert (statuses[j] in ("first_order", "small_residual")) == got_solved[j], (name, cname, statuses[j])
