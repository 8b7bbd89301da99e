"""The problem battery: every registered problem under the reference
benchmark protocol (``atol = 0, rtol = 1e-5``; solved ⇔ status ∈
{first_order, small_residual}).

Port of ``benchmarks/full_battery.py``.  ``collect()`` is the same list in
the same order, 90 problems at their published sizes:

* MGH 1–35 (unconstrained NLS), ``models/mgh.py``;
* the 20 extended dimensional MGH variants, ``models/mgh.py``;
* 14 constrained MGH problems (``sum(x) = 1`` attached);
* the Hock–Schittkowski sums of squares, ``models/hs.py``;
* the Lukšan–Vlček-style chained constrained problems, ``models/lvcon.py``.

Each problem runs with the reference default configuration (newton, full
KKT), first with ``linsolve='ldlt'`` and, on an ``exception`` status, once
more with ``linsolve='eigh'``: the uniform pass.  Three generic rescues
then apply to every problem, in order (``rescue=False`` skips them):

* still unsolved: one retry with ``delta_min=1e-4``;
* still unsolved: one retry with ``kkt='condensed', multiplier_refit=True,
  matmul_precision='highest'`` (IEEE float32 in every matmul, as in the JAX
  package: a rescue buys robustness, not speed);
* unsolved, or first order at an objective measurably above the known
  optimum (a local minimum): one batched multistart sweep of 64 starts.

Usage::

    python -m cannoles_tpu_torch.battery [--device {cuda,cpu}]
        [--dtype {float32,float64}] [--max-time S] [--json OUT]

The JSON summary records the uniform-pass count (``solved_uniform``), the
count with the rescues (``solved``) and which rescue fired on each row.
Each row also carries the solver's counters, its solution and the host
syncs (``CaNNOLeSSolver.host_syncs``) of every solver the row used.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback

import numpy as np
import torch

from .core.solver import CaNNOLeSSolver
from .models.basic import constrained
from .models.hs import hs_suite
from .models.lvcon import LVCON_NAMES, lvcon_problem, lvcon_suite
from .models.mgh import mgh_suite
from .parallel.multistart import multistart

__all__ = ["collect", "solve_row", "solve_index", "run", "summarize", "main"]

# the 14 MGH problems that also run with sum(x) = 1 attached
CURATED = {
    "rosenbrock", "beale", "helical_valley", "powell_singular", "wood",
    "ext_rosenbrock", "ext_powell", "broyden_tridiagonal",
    "broyden_banded", "brown_almost_linear", "variably_dimensioned",
    "trigonometric", "discrete_boundary_value", "chebyquad",
}


def _constrained_make(make, dtype=None, device=None):
    return constrained(make(dtype=dtype, device=device), "linear")


def collect():
    """``(family, name, make, fstar)`` for each problem, in the JAX
    runner's order; ``make(dtype=None, device=None)`` builds the problem."""
    items = []
    base = mgh_suite()
    for s in base:
        items.append(("mgh", s.name, s.make, s.fmin))
    seen = {s.name for s in base}
    for s in mgh_suite(extended=True):
        if s.name not in seen:
            items.append(("mgh_ext", s.name, s.make, s.fmin))
    for s in mgh_suite(extended=True):
        if s.name in CURATED:
            items.append(("mgh_con", s.name + "+linear", functools.partial(_constrained_make, s.make), None))
    for s in hs_suite():
        items.append(("hs", s.name, s.make, s.fstar))
    # rows are named as the JAX runner names them, by the built problem
    for name, pb in zip(LVCON_NAMES, lvcon_suite(device="cpu")):
        items.append(("lvcon", pb.name, functools.partial(lvcon_problem, name), None))
    return items


def _ok(st):
    return st.status in ("first_order", "small_residual")


def solve_row(family, name, make, fstar, *, dtype=torch.float64, device=None, max_time=60.0,
              rescue=True) -> dict:
    """One problem through the uniform pass and, with ``rescue``, the
    three generic rescues; returns its row."""
    t0 = time.perf_counter()
    pb = make(dtype=dtype, device=device)
    solvers = []

    def solve(**kw):
        s = CaNNOLeSSolver(pb, **kw)
        solvers.append(s)
        return s.solve(atol=0.0, rtol=1e-5, max_time=max_time)

    stats = solve(linsolve="ldlt")
    if stats.status == "exception":
        stats = solve(linsolve="eigh")
    solved_uniform = _ok(stats)
    kind = None
    ms_syncs = None
    if rescue:
        if not _ok(stats):
            st2 = solve(linsolve="ldlt", delta_min=1e-4)
            if _ok(st2):
                stats, kind = st2, "delta_min"
        if not _ok(stats):
            st2b = solve(kkt="condensed", multiplier_refit=True, matmul_precision="highest")
            if _ok(st2b):
                stats, kind = st2b, "condensed_refit"
        local_min = (
            _ok(stats) and fstar is not None and 2 * stats.objective > fstar + 1e-4 * (1 + abs(fstar))
        )
        if not _ok(stats) or local_min:
            ms_solver = CaNNOLeSSolver(pb)
            solvers.append(ms_solver)
            st3 = multistart(pb, n_starts=64, atol=0.0, rtol=1e-5, max_inner=100, max_eval=5000,
                             solver=ms_solver)
            ms_syncs = ms_solver.host_syncs
            if _ok(st3) and (not _ok(stats) or st3.objective < stats.objective):
                stats, kind = st3, "multistart"
    ss = stats.solver_specific
    return dict(
        family=family, name=name, nvar=pb.nvar, nequ=pb.nequ, ncon=pb.ncon,
        status=stats.status, solved=_ok(stats), solved_uniform=solved_uniform, rescue=kind,
        iter=stats.iter, nfact=ss.get("nfact"), nlinsolve=ss.get("nlinsolve"),
        fsumsq=2 * stats.objective, fstar=fstar,
        dual_feas=stats.dual_feas, primal_feas=stats.primal_feas,
        solution=np.asarray(stats.solution, dtype=float).tolist(),
        host_syncs=sum(s.host_syncs for s in solvers), multistart_host_syncs=ms_syncs,
        time=time.perf_counter() - t0,
    )


def _error_row(family, name, fstar, e, seconds) -> dict:
    return dict(
        family=family, name=name, nvar=-1, nequ=-1, ncon=-1,
        status=f"error:{e}", solved=False, solved_uniform=False, rescue=None,
        iter=-1, nfact=None, nlinsolve=None, fsumsq=float("nan"), fstar=fstar,
        dual_feas=float("nan"), primal_feas=float("nan"), solution=None,
        host_syncs=None, multistart_host_syncs=None, time=seconds,
    )


def solve_index(index, dtype=torch.float64, device=None, max_time=60.0, rescue=True) -> dict:
    """The row of ``collect()[index]``; a problem that raises gets an
    ``error:`` row.  A module-level function of plain arguments, so that a
    process pool can run it."""
    family, name, make, fstar = collect()[index]
    t0 = time.perf_counter()
    try:
        return solve_row(family, name, make, fstar, dtype=dtype, device=device,
                         max_time=max_time, rescue=rescue)
    except Exception as e:  # noqa: BLE001 (the battery survives one bad problem)
        traceback.print_exc(file=sys.stderr)
        return _error_row(family, name, fstar, e, time.perf_counter() - t0)


def _log_row(log, row):
    if log is not None:
        log(f"{row['family']:8s} {row['name']:30s} {row['status']:<16s} "
            f"iter={row['iter']:<4} Σf²={row['fsumsq']:<12.5g} t={row['time']:.2f}s")


def run(names=None, *, dtype=torch.float64, device=None, max_time=60.0, rescue=True, log=print):
    """Every problem of ``collect()`` (or those named in ``names``) through
    :func:`solve_row`, in ``collect()``'s order; a problem that raises gets
    an ``error:`` row and the battery goes on.  Returns ``(rows, summary)``."""
    t0 = time.perf_counter()
    rows = []
    for i, it in enumerate(collect()):
        if names is None or it[1] in names:
            rows.append(solve_index(i, dtype=dtype, device=device, max_time=max_time, rescue=rescue))
            _log_row(log, rows[-1])
    return rows, summarize(rows, wall_s=time.perf_counter() - t0)


def summarize(rows, wall_s=None) -> dict:
    """The JAX runner's summary (counts, rates, solved per family), plus
    the uniform pass per family, the rows each rescue solved and the
    battery's wall."""
    solved = sum(r["solved"] for r in rows)
    solved_uniform = sum(r["solved_uniform"] for r in rows)
    by_family, by_family_uniform, by_rescue = {}, {}, {}
    for r in rows:
        n, s = by_family.get(r["family"], (0, 0))
        by_family[r["family"]] = (n + 1, s + r["solved"])
        n, s = by_family_uniform.get(r["family"], (0, 0))
        by_family_uniform[r["family"]] = (n + 1, s + r["solved_uniform"])
        if r["rescue"]:
            by_rescue[r["rescue"]] = by_rescue.get(r["rescue"], 0) + 1
    return dict(
        n=len(rows), solved=solved, solved_uniform=solved_uniform,
        solve_rate=round(solved / len(rows), 4),
        solve_rate_uniform=round(solved_uniform / len(rows), 4),
        by_family={k: f"{s}/{n}" for k, (n, s) in by_family.items()},
        by_family_uniform={k: f"{s}/{n}" for k, (n, s) in by_family_uniform.items()},
        by_rescue=by_rescue,
        wall_s=wall_s,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float64")
    ap.add_argument("--max-time", type=float, default=60.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("battery: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    rows, summary = run(dtype=getattr(torch, args.dtype), device=args.device,
                        max_time=args.max_time)
    summary.update(device=args.device, dtype=args.dtype)
    if args.device == "cuda":
        summary["device_name"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
