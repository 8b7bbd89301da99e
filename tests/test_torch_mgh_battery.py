"""The port's MGH battery runner against the JAX package's runner and its
three records (``benchmarks/results_mgh_cpu_newton.json``,
``results_mgh_extended.json``, ``results_mgh_constrained.json``; float64
on the CPU, newton, full KKT).

The suites are the JAX runner's: ``--extended`` is 55 problems named as
JAX's ``mgh_suite(extended=True)``, ``--constrained`` the curated 14 with
sum(x) = 1 in the record's order.  A handful of rows of each record, and
the whole constrained record through ``main`` (``--linsolve auto``), equal
their status and iteration count; the summary has the JAX runner's keys
and values.  ``--linsolve auto`` escalates an ``exception`` to ``eigh``.
"""

import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from cannoles_tpu_torch import mgh_battery  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _record(name):
    return json.loads((ROOT / "benchmarks" / f"results_mgh_{name}.json").read_text())


def test_suites_are_jax_suites():
    from cannoles_tpu.models.mgh import mgh_suite

    ext = [s.name for s in mgh_suite(extended=True)]
    assert [s.name for s in mgh_battery.suite(extended=True)] == ext and len(ext) == 55
    assert [s.name for s in mgh_battery.suite()] == [s.name for s in mgh_suite()]
    con = [s.name for s in mgh_battery.suite(constrained=True)]
    assert con == [r["name"] for r in _record("constrained")["rows"]] and len(con) == 14
    assert all(s.fmin is None for s in mgh_battery.suite(constrained=True))


@pytest.mark.parametrize("record, extended, names", [
    ("cpu_newton", False, ("rosenbrock", "beale", "jennrich_sampson", "box3d", "chebyquad")),
    ("extended", True, ("watson_9", "chebyquad_8", "trigonometric_20", "gulf_10")),
])
def test_rows_equal_the_records(record, extended, names):
    rows, summary = mgh_battery.run(set(names), extended=extended, device="cpu", log=None)
    want = {r["name"]: r for r in _record(record)["rows"]}
    assert [r["name"] for r in rows] == [n for n in want if n in names]
    for r in rows:
        w = want[r["name"]]
        assert set(r) == set(w)
        assert (r["status"], r["iter"], r["nvar"], r["nequ"]) == (w["status"], w["iter"], w["nvar"], w["nequ"])
        assert r["fsumsq"] == pytest.approx(w["fsumsq"], rel=1e-6, abs=1e-12)
    assert set(summary) == set(_record(record)["summary"])
    assert summary["solved"] == len(names)


def test_constrained_main_equals_the_record(tmp_path):
    out = tmp_path / "mgh.json"
    assert mgh_battery.main(["--device", "cpu", "--constrained", "--linsolve", "auto", "--json", str(out)]) == 0
    got = json.loads(out.read_text())
    want = _record("constrained")
    assert [(r["name"], r["status"], r["iter"]) for r in got["rows"]] == \
        [(r["name"], r["status"], r["iter"]) for r in want["rows"]]
    for k, v in want["summary"].items():
        assert got["summary"][k] == v, k
    assert got["summary"]["device"] == "cpu" and got["summary"]["dtype"] == "float64"


def test_auto_escalates_an_exception_to_eigh(monkeypatch):
    """A residual that is NaN at x0 ends ``exception`` on ldlt; ``auto``
    then solves once more with eigh (which ends ``exception`` too)."""
    import cannoles_tpu_torch.core.solver as core
    from cannoles_tpu_torch import nls_problem
    from cannoles_tpu_torch.models.mgh import MGHSpec

    used = []
    real = core.CaNNOLeSSolver

    class Spy(real):
        def __init__(self, problem, **kw):
            used.append(kw["linsolve"])
            super().__init__(problem, **kw)

    monkeypatch.setattr(core, "CaNNOLeSSolver", Spy)
    spec = MGHSpec("nan_at_x0", lambda dtype=None, device=None: nls_problem(
        lambda x: torch.stack([torch.sqrt(x[0]) - 1, x[1]]), [-1.0, 1.0], 2, device=device), None)
    row = mgh_battery.solve_spec(spec, linsolve="auto", device="cpu")
    assert used == ["ldlt", "eigh"] and row["status"] == "exception" and not row["solved"]
    used.clear()
    assert mgh_battery.solve_spec(spec, linsolve="ldlt", device="cpu")["status"] == "exception"
    assert used == ["ldlt"]
