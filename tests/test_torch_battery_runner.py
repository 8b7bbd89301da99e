"""PyTorch port, the battery runner (``cannoles_tpu_torch.battery``) against
``benchmarks/full_battery.py`` in float64: the same 90 problems in the
same order, rows rescued by multistart through the same escalation, and
``run`` giving ``solve_index``'s rows in that order.  Counters are held equal
and solutions within 1e-8 relative to their scale."""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
from cannoles_tpu.parallel.multistart import multistart as jms  # noqa: E402
from cannoles_tpu_torch import battery  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_runner():
    spec = importlib.util.spec_from_file_location("full_battery_ref", ROOT / "benchmarks" / "full_battery.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_ITEMS = _jax_runner().collect()
ITEMS = battery.collect()


def test_collect_is_the_jax_runners_list():
    assert len(ITEMS) == len(JAX_ITEMS) == 90
    assert [(f, n, s) for f, n, _, s in ITEMS] == [(f, n, s) for f, n, _, s in JAX_ITEMS]


@pytest.mark.parametrize("family", ["mgh", "mgh_ext", "mgh_con", "hs", "lvcon"])
def test_collect_builds_the_same_problems(family):
    """Every item of a family builds with the JAX item's dimensions, name
    and x0, in the dtype and on the device it is given."""
    rows = [(j, t) for j, t in zip(JAX_ITEMS, ITEMS) if t[0] == family]
    assert rows
    for (_, name, jmake, _), (_, _, tmake, _) in rows:
        pj, pt = jmake(), tmake(dtype=torch.float64, device="cpu")
        assert (pt.nvar, pt.nequ, pt.ncon) == (pj.nvar, pj.nequ, pj.ncon), name
        np.testing.assert_array_equal(pt.x0.numpy(), np.asarray(pj.x0, dtype=float), err_msg=name)
        assert tmake(dtype=torch.float32, device="cpu").x0.dtype == torch.float32


def _jax_row(name):
    """``full_battery.py``'s escalation for one problem (without the
    ``matmul_precision`` knob, which does nothing on the CPU)."""
    fam, _, make, fstar = next(it for it in JAX_ITEMS if it[1] == name)
    ok = ("first_order", "small_residual")
    pb = make()
    stats = jc.CaNNOLeSSolver(pb, linsolve="ldlt").solve(atol=0.0, rtol=1e-5, max_time=600.0)
    if stats.status == "exception":
        stats = jc.CaNNOLeSSolver(pb, linsolve="eigh").solve(atol=0.0, rtol=1e-5, max_time=600.0)
    rescue = None
    if stats.status not in ok:
        st2 = jc.CaNNOLeSSolver(pb, linsolve="ldlt", delta_min=1e-4).solve(atol=0.0, rtol=1e-5, max_time=600.0)
        if st2.status in ok:
            stats, rescue = st2, "delta_min"
    if stats.status not in ok:
        st2b = jc.CaNNOLeSSolver(pb, kkt="condensed", multiplier_refit=True).solve(
            atol=0.0, rtol=1e-5, max_time=600.0)
        if st2b.status in ok:
            stats, rescue = st2b, "condensed_refit"
    local_min = stats.status in ok and fstar is not None and 2 * stats.objective > fstar + 1e-4 * (1 + abs(fstar))
    if stats.status not in ok or local_min:
        st3 = jms(pb, n_starts=64, atol=0.0, rtol=1e-5, max_inner=100, max_eval=5000)
        if st3.status in ok and (stats.status not in ok or st3.objective < stats.objective):
            stats, rescue = st3, "multistart"
    return stats, rescue


@pytest.mark.parametrize("name", ["freudenstein_roth", "penalty1"])
def test_multistart_rescue_row_matches_jax(name):
    """Rows the uniform pass leaves at a local minimum: the port's row takes
    the multistart rescue as the JAX runner does, to the same point."""
    item = next(it for it in ITEMS if it[1] == name)
    row = battery.solve_row(*item, dtype=torch.float64, device="cpu", max_time=600.0)
    a, rescue = _jax_row(name)
    assert rescue == "multistart"
    assert (row["status"], row["rescue"], row["iter"]) == (a.status, rescue, a.iter)
    assert row["solved"] and not (row["solved_uniform"] and row["rescue"] is None)
    assert row["multistart_host_syncs"] > 0 and row["host_syncs"] > row["multistart_host_syncs"]
    xa = np.asarray(a.solution)
    np.testing.assert_allclose(row["solution"], xa, rtol=0, atol=1e-8 * max(1.0, np.abs(xa).max()))
    np.testing.assert_allclose(row["fsumsq"], 2 * a.objective, rtol=1e-8, atol=1e-12)


def test_run_gives_the_rows_of_solve_index_in_collect_order():
    names = {"hs28", "beale", "rosenbrock"}
    kw = dict(dtype=torch.float64, device="cpu", max_time=600.0, rescue=False)
    rows, summ = battery.run(names, log=None, **kw)
    assert [r["name"] for r in rows] == ["rosenbrock", "beale", "hs28"]
    index = {it[1]: i for i, it in enumerate(ITEMS)}
    for r in rows:
        one = battery.solve_index(index[r["name"]], **kw)
        for key in ("status", "iter", "nfact", "nlinsolve", "solution", "host_syncs", "solved"):
            assert one[key] == r[key], (r["name"], key)
    assert summ["solved"] == summ["solved_uniform"] == 3 and summ["by_family"] == {"mgh": "2/2", "hs": "1/1"}


def test_a_problem_that_raises_gets_an_error_row(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(battery, "solve_row", boom)
    rows, summ = battery.run({"rosenbrock"}, device="cpu", log=None)
    assert rows[0]["status"] == "error:boom" and not rows[0]["solved"]
    assert summ["n"] == 1 and summ["solved"] == 0 and summ["by_rescue"] == {}


def test_main_without_a_card_asks_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert battery.main(["--device", "cuda"]) == 2
    assert "--device cpu" in capsys.readouterr().err
