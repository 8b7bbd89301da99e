"""Dolan–Moré performance profiles of the solver's configurations, with
scipy as the external comparator.

Port of ``benchmarks/perf_profile.py``.  The battery's 90 problems
(``battery.collect()``, in its order) through four configurations
(newton/full, newton/condensed, gauss_newton/condensed, lm/condensed):
each solve is preceded by a warm call (``max_time=0.1``), then timed with
``atol=0``, ``rtol=1e-5``, ``max_time=30``; solved ⇔ ``first_order`` or
``small_residual``, and a solved run's costs are its wall and its
``neval_residual``.  The external comparators, as the JAX script's:

* the 55 unconstrained problems: ``scipy.optimize.least_squares`` (TRF
  and LM; LM only where m ≥ n), solved where ‖JᵀF‖∞ at its answer is at
  most ``1e-5·‖JᵀF(x0)‖∞`` or 2√(½‖F‖²) ≤ √eps;
* the 35 constrained ones: ``scipy.optimize.minimize`` (SLSQP and
  trust-constr) on min ½‖F‖² s.t. c(x) = 0, solved where the port's KKT
  oracle (``utils.kkt.kkt_residuals``) with the least-squares multiplier at
  its answer gives scaled stationarity ≤ ``1e-5·‖∇L(x0)‖∞`` and
  feasibility ≤ the square root of that.

scipy's residual, Jacobian, gradient and constraint Jacobian are the
port's own evaluators on the same problem (``torch.func``: the problem's
``F``/``Jt``/``c_shifted``/``Jc`` and ``grad`` of ½‖F‖²), called once each
at x0 before timing.  scipy is a host library that calls back once per
evaluation, so its problem is built on the CPU whatever ``device`` the
solver's runs take (on the card each callback would be a round trip).  A solve or comparator that raises counts as not
solved and is listed under ``errors``.  Each solve's status and wall are
kept (``statuses``, ``walls``) beside the costs, so that a run that ends
``max_time`` shows what it spent.

    python -m cannoles_tpu_torch.perf_profile [--device cpu] [--dtype float64] [--json F]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["CONFIGS", "TAUS", "performance_profile", "run", "main"]

CONFIGS = [
    ("newton/full", dict(method="newton", kkt="full")),
    ("newton/condensed", dict(method="newton", kkt="condensed")),
    ("gauss_newton/condensed", dict(method="gauss_newton", kkt="condensed")),
    ("lm/condensed", dict(method="lm", kkt="condensed")),
]
SCIPY_UNCON = ["scipy-trf", "scipy-lm"]
SCIPY_CON = ["scipy-slsqp", "scipy-trustconstr"]
TAUS = np.array([1.0, 2.0, 5.0, 10.0, 100.0])
TOL = dict(atol=0.0, rtol=1e-5)
MAX_TIME = 30.0


def performance_profile(costs: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """costs: (n_problems, n_solvers), np.inf = failed.  Returns rho(tau):
    (n_taus, n_solvers), the fraction of problems solved within tau × the
    best cost."""
    best = np.nanmin(np.where(np.isfinite(costs), costs, np.nan), axis=1)
    ratios = costs / best[:, None]
    return np.stack([(ratios <= t).mean(axis=0) for t in taus])


class _Fns:
    """numpy views of one problem's evaluators for scipy: x (n,) float64
    numpy → numpy, through the problem's dtype and device."""

    def __init__(self, pb):
        from torch.func import grad

        from .core.solver import _add_batch_axis

        self.pb = pb
        self.dt, self.dev = pb.x0.dtype, pb.x0.device
        self.data = _add_batch_axis(pb.data, self.dev)
        self._grad = grad(lambda z: 0.5 * (pb.residual(z, pb.data) ** 2).sum())

    def t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dt, device=self.dev)

    def F(self, x):
        return self.pb.F(self.t(x)[None], self.data)[0].cpu().double().numpy()

    def J(self, x):
        return self.pb.Jt(self.t(x)[None], self.data)[0].T.cpu().double().numpy()

    def f(self, x):
        return 0.5 * float(np.sum(self.F(x) ** 2))

    def g(self, x):
        return self._grad(self.t(x)).cpu().double().numpy()

    def c(self, x):
        return self.pb.c_shifted(self.t(x)[None], self.data)[0].cpu().double().numpy()

    def Jc(self, x):
        return self.pb.Jc(self.t(x)[None], self.data)[0].cpu().double().numpy()


def _err(errors, where, e):
    errors.append(f"{where}: {type(e).__name__}: {e}")


def _cannoles(make, kw, dtype, device, max_time, errors, where):
    """(status, wall, neval_residual) of one timed solve after a warm call."""
    from .core.solver import CaNNOLeSSolver

    try:
        pb = make(dtype=dtype, device=device)
        solver = CaNNOLeSSolver(pb, **kw)
        solver.solve(max_time=0.1, **TOL)  # the warm call (one-time costs)
        t0 = time.perf_counter()
        stats = solver.solve(max_time=max_time, **TOL)
        if pb.x0.device.type == "cuda":
            torch.cuda.synchronize(pb.x0.device)
        return stats.status, time.perf_counter() - t0, stats.solver_specific["neval_residual"]
    except Exception as e:  # noqa: BLE001 (a failed solve, recorded)
        _err(errors, where, e)
        return f"error:{type(e).__name__}", float("nan"), None


def _scipy_uncon(fn, errors, name):
    """least_squares TRF and LM: ((time, nfev) or None) each."""
    from scipy.optimize import least_squares

    pb = fn.pb
    x0 = pb.x0.cpu().double().numpy()
    g0 = np.abs(fn.J(x0).T @ fn.F(x0)).max()
    epstol = 0.0 + 1e-5 * g0  # the protocol's ϵtol = atol + rtol·‖∇L⁰‖
    out = []
    for smethod in ("trf", "lm"):
        if smethod == "lm" and pb.nequ < pb.nvar:
            out.append(None)  # scipy 'lm' requires m >= n
            continue
        try:
            t0 = time.perf_counter()
            r = least_squares(fn.F, x0, jac=fn.J, method=smethod, xtol=1e-12, ftol=1e-12, gtol=1e-12,
                              max_nfev=100000)
            dt = time.perf_counter() - t0
            gend = np.abs(fn.J(r.x).T @ fn.F(r.x)).max()
            # small-residual exit, the reference default Fatol = √eps
            small = 2 * np.sqrt(float(r.cost)) <= np.sqrt(float(np.finfo(np.float64).eps))
            out.append((dt, r.nfev) if (gend <= epstol or small) else None)
        except Exception as e:  # noqa: BLE001 (a failed comparator, recorded)
            _err(errors, f"{name} scipy-{smethod}", e)
            out.append(None)
    return out


def _scipy_con(fn, errors, name):
    """minimize SLSQP and trust-constr: ((time, nfev) or None) each, judged
    by the KKT oracle with the least-squares multiplier."""
    from scipy.optimize import NonlinearConstraint, minimize

    from .utils.kkt import kkt_residuals

    pb = fn.pb
    x0 = pb.x0.cpu().double().numpy()

    def lam_ls(x):
        lam, *_ = np.linalg.lstsq(fn.Jc(x).T, fn.g(x), rcond=None)
        return lam

    g0v = fn.g(x0) - fn.Jc(x0).T @ lam_ls(x0)
    epstol = 1e-5 * max(np.abs(g0v).max(), 1e-300)

    def solved(x):
        r = kkt_residuals(pb, fn.t(x), fn.t(lam_ls(x)))
        return float(r.scaled_stationarity) <= epstol and float(r.feasibility) <= np.sqrt(epstol)

    out = []
    for smethod in ("slsqp", "trust-constr"):
        try:
            t0 = time.perf_counter()
            if smethod == "slsqp":
                r = minimize(fn.f, x0, jac=fn.g, method="SLSQP",
                             constraints=[{"type": "eq", "fun": fn.c, "jac": fn.Jc}],
                             options=dict(maxiter=2000, ftol=1e-14))
            else:
                r = minimize(fn.f, x0, jac=fn.g, method="trust-constr",
                             constraints=NonlinearConstraint(fn.c, 0.0, 0.0, jac=fn.Jc),
                             options=dict(maxiter=5000, gtol=1e-12, xtol=1e-14))
            dt = time.perf_counter() - t0
            out.append((dt, r.nfev) if solved(r.x) else None)
        except Exception as e:  # noqa: BLE001 (a failed comparator, recorded)
            _err(errors, f"{name} scipy-{smethod}", e)
            out.append(None)
    return out


def _ok(status) -> bool:
    return status in ("first_order", "small_residual")


def _print_profile(title, taus, prof):
    print(title)
    for t, row in zip(taus, prof):
        print(f"  tau={t:<6g}" + "  ".join(f"{v:.2f}" for v in row))


def run(names=None, *, dtype=torch.float64, device=None, max_time=MAX_TIME, log=print) -> dict:
    """The profiles over the battery's problems (or those in ``names``, in
    the battery's order); returns the JAX script's JSON layout with the
    statuses, walls and errors beside it.  ``device`` None is the card."""
    from .battery import collect

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: perf_profile runs on the card by default; pass device=\"cpu\"")
    problems = [(name, make) for _fam, name, make, _f in collect() if names is None or name in names]
    P, C = len(problems), len(CONFIGS)
    time_costs = np.full((P, C), np.inf)
    eval_costs = np.full_like(time_costs, np.inf)
    statuses = [[None] * C for _ in range(P)]
    walls = np.full((P, C), np.nan)
    errors: list = []
    for i, (pname, make) in enumerate(problems):
        for j, (cname, kw) in enumerate(CONFIGS):
            st, wall, nev = _cannoles(make, kw, dtype, device, max_time, errors, f"{pname} {cname}")
            statuses[i][j], walls[i, j] = st, wall
            if _ok(st):
                time_costs[i, j], eval_costs[i, j] = wall, nev
        if log:
            log(f"{pname:28s} " + " ".join(
                f"{CONFIGS[j][0]}:{'ok' if np.isfinite(time_costs[i, j]) else '--'}" for j in range(C)))

    uncon_idx, con_idx = [], []
    scipy_time = np.full((P, 2), np.inf)
    scipy_eval = np.full((P, 2), np.inf)
    scipy_con_time = np.full((P, 2), np.inf)
    scipy_con_eval = np.full((P, 2), np.inf)
    for i, (pname, make) in enumerate(problems):
        pb = make(dtype=dtype, device="cpu")
        fn = _Fns(pb)
        # warm the evaluators (the solver's timings exclude one-time costs too)
        x0 = pb.x0.cpu().double().numpy()
        if pb.ncon == 0:
            uncon_idx.append(i)
            fn.F(x0), fn.J(x0)
            res, t_into, e_into, labels = _scipy_uncon(fn, errors, pname), scipy_time, scipy_eval, ("trf", "lm")
        else:
            con_idx.append(i)
            fn.f(x0), fn.g(x0), fn.c(x0), fn.Jc(x0)
            res, t_into, e_into, labels = _scipy_con(fn, errors, pname), scipy_con_time, scipy_con_eval, \
                ("slsqp", "trust-constr")
        for k, got in enumerate(res):
            if got is not None:
                t_into[i, k], e_into[i, k] = got
        if log:
            log(f"{pname:28s} scipy {labels[0]}:{'ok' if np.isfinite(t_into[i, 0]) else '--'} "
                f"{labels[1]}:{'ok' if np.isfinite(t_into[i, 1]) else '--'}")

    prof_t = performance_profile(time_costs, TAUS)
    prof_e = performance_profile(eval_costs, TAUS)
    names_c = [c[0] for c in CONFIGS]
    ui, ci = np.asarray(uncon_idx, int), np.asarray(con_idx, int)

    def part(idx, t_s, e_s, scipy_names):
        cols_t = np.concatenate([time_costs[idx], t_s[idx]], axis=1)
        cols_e = np.concatenate([eval_costs[idx], e_s[idx]], axis=1)
        return dict(configs=names_c + scipy_names, problems=[problems[i][0] for i in idx],
                    profile_time=performance_profile(cols_t, TAUS).tolist() if len(idx) else [],
                    profile_evals=performance_profile(cols_e, TAUS).tolist() if len(idx) else [],
                    solved_per_config=np.isfinite(cols_t).sum(axis=0).tolist(),
                    time_costs=cols_t.tolist(), eval_costs=cols_e.tolist())

    out = dict(
        configs=names_c, problems=[p[0] for p in problems], taus=TAUS.tolist(),
        profile_time=prof_t.tolist(), profile_evals=prof_e.tolist(),
        solved_per_config=np.isfinite(time_costs).sum(axis=0).tolist(),
        unconstrained=part(ui, scipy_time, scipy_eval, SCIPY_UNCON),
        constrained=part(ci, scipy_con_time, scipy_con_eval, SCIPY_CON),
        statuses=statuses, walls=walls.tolist(), errors=errors,
        dtype=str(dtype).replace("torch.", ""), max_time=max_time,
    )
    return out


def _report(out):
    names = out["configs"]
    taus = out["taus"]
    print("\nperformance profile (elapsed time):  tau :", names)
    for t, row in zip(taus, out["profile_time"]):
        print(f"  tau={t:<6g}" + "  ".join(f"{v:.2f}" for v in row))
    print("performance profile (neval_residual):")
    for t, row in zip(taus, out["profile_evals"]):
        print(f"  tau={t:<6g}" + "  ".join(f"{v:.2f}" for v in row))
    for key, what in (("unconstrained", "unconstrained"), ("constrained", "constrained")):
        p = out[key]
        print(f"\n{what} battery ({len(p['problems'])} problems) vs scipy:", p["configs"])
        _print_profile(" time profile:", taus, p["profile_time"])
        _print_profile(" nfev profile:", taus, p["profile_evals"])
    print(json.dumps({
        "solved_per_config": out["solved_per_config"], "n": len(out["problems"]),
        "unconstrained_solved": out["unconstrained"]["solved_per_config"],
        "n_unconstrained": len(out["unconstrained"]["problems"]),
        "constrained_solved": out["constrained"]["solved_per_config"],
        "n_constrained": len(out["constrained"]["problems"]),
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float64")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("perf_profile: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    out = run(dtype=getattr(torch, args.dtype), device=args.device, log=lambda s: print(s, flush=True))
    if args.device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    else:
        out["device"] = "cpu"
    _report(out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
