"""MGH battery runner under the reference benchmark protocol: every problem
with ``atol = 0, rtol = 1e-5``, solved ⇔ status ∈ {first_order,
small_residual}; per-problem status, iterations, evaluations and time, and
the overall solve rate.

Port of ``benchmarks/mgh_battery.py``.  The suite is ``models.mgh.mgh_suite``
(35 problems; ``--extended`` appends the 20 dimensional variants, 55), or
with ``--constrained`` the curated 14 with sum(x) = 1 attached
(``+linear``, ``battery.CURATED``).  Each problem is one ``solve()`` with
``--method``, ``--kkt`` and ``--linsolve``; ``--linsolve auto`` takes
``ldlt`` and, on an ``exception`` status, once more ``eigh`` (the
reference's two-backend seam).  A problem that raises gets an ``error:``
row and the battery goes on.  The summary counts the problems at their
certified optimum (Σf² ≤ fmin + max(1e-5, 1e-4·max(1, |fmin|))) among the
solved ones with a known fmin.

    python -m cannoles_tpu_torch.mgh_battery [--device cpu] [--method newton] [--kkt full]
        [--linsolve ldlt] [--max-time 60] [--extended] [--constrained] [--json F]

The problems run in float64, the dtype of the JAX records (its ``--cpu``);
``run(dtype=...)`` takes another.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback

import torch

__all__ = ["suite", "solve_spec", "run", "summarize", "main"]


def suite(extended: bool = False, constrained: bool = False) -> list:
    """The runner's specs: ``MGHSpec(name, make, fmin)``, in MGH order."""
    from .battery import CURATED, _constrained_make
    from .models.mgh import MGHSpec, mgh_suite

    specs = mgh_suite(extended=extended)
    if constrained:
        specs = [MGHSpec(s.name + "+linear", functools.partial(_constrained_make, s.make), None)
                 for s in specs if s.name in CURATED]
    return specs


def solve_spec(spec, *, method="newton", kkt="full", linsolve="ldlt", max_time=60.0, dtype=torch.float64,
               device=None) -> dict:
    """One problem's row (the JAX runner's keys)."""
    from .core.solver import CaNNOLeSSolver

    pb = spec.make(dtype=dtype, device=device)
    t0 = time.time()
    try:
        first = "ldlt" if linsolve == "auto" else linsolve
        stats = CaNNOLeSSolver(pb, method=method, linsolve=first, kkt=kkt).solve(
            atol=0.0, rtol=1e-5, max_time=max_time)
        if linsolve == "auto" and stats.status == "exception":
            # the robust-backend escalation (the reference's two-backend seam)
            stats = CaNNOLeSSolver(pb, method=method, linsolve="eigh", kkt=kkt).solve(
                atol=0.0, rtol=1e-5, max_time=max_time)
        return dict(
            name=spec.name, nvar=pb.nvar, nequ=pb.nequ, status=stats.status,
            solved=stats.status in ("first_order", "small_residual"), iter=stats.iter,
            fsumsq=2 * stats.objective, fmin=spec.fmin, dual_feas=stats.dual_feas,
            neval=stats.solver_specific.get("neval_residual", -1),
            nfact=stats.solver_specific.get("nfact", -1), time=time.time() - t0,
        )
    except Exception as e:  # noqa: BLE001 (the battery survives one bad problem, recorded)
        traceback.print_exc(file=sys.stderr)
        return dict(name=spec.name, nvar=pb.nvar, nequ=pb.nequ, status=f"error:{e}", solved=False, iter=-1,
                    fsumsq=float("nan"), fmin=spec.fmin, dual_feas=float("nan"), neval=-1, nfact=-1,
                    time=time.time() - t0)


def summarize(rows, *, method="newton", kkt="full", linsolve="ldlt") -> dict:
    """The JAX runner's summary."""
    solved = sum(r["solved"] for r in rows)
    certified = [r for r in rows if r["fmin"] is not None]
    at_opt = sum(
        r["fsumsq"] <= r["fmin"] + max(1e-5, 1e-4 * max(1.0, abs(r["fmin"])))
        for r in certified if r["solved"]
    )
    return dict(n=len(rows), solved=solved, solve_rate=solved / len(rows), certified=len(certified),
                at_certified_optimum=at_opt, method=method, kkt=kkt, linsolve=linsolve)


def run(names=None, *, extended=False, constrained=False, method="newton", kkt="full", linsolve="ldlt",
        max_time=60.0, dtype=torch.float64, device=None, log=print):
    """Every spec of the suite (or those in ``names``); ``(rows, summary)``.
    ``device`` None is the card."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: mgh_battery runs on the card by default; pass device=\"cpu\"")
    rows = []
    for spec in suite(extended, constrained):
        if names is not None and spec.name not in names:
            continue
        row = solve_spec(spec, method=method, kkt=kkt, linsolve=linsolve, max_time=max_time, dtype=dtype,
                         device=device)
        rows.append(row)
        if log:
            log(f"{row['name']:28s} {row['status']:<16s} iter={row['iter']:<4} "
                f"Σf²={row['fsumsq']:<12.5g} t={row['time']:.2f}s")
    return rows, summarize(rows, method=method, kkt=kkt, linsolve=linsolve)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--method", default="newton")
    ap.add_argument("--kkt", default="full")
    ap.add_argument("--linsolve", default="ldlt")
    ap.add_argument("--max-time", type=float, default=60.0)
    ap.add_argument("--extended", action="store_true", help="append the 20 dimensional variants of the MGH paper")
    ap.add_argument("--constrained", action="store_true",
                    help="the curated 14 MGH problems with sum(x) = 1 attached")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mgh_battery: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    rows, summary = run(extended=args.extended, constrained=args.constrained, method=args.method, kkt=args.kkt,
                        linsolve=args.linsolve, max_time=args.max_time, device=args.device,
                        log=lambda s: print(s, flush=True))
    summary.update(device=torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu", dtype="float64")
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(summary=summary, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
