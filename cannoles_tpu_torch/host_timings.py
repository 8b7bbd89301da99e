"""Host-path timings of a B = 1 solve: the evaluators per call, the weighted
Hessian's routes, and two whole solves with their host checks.

* ``evaluators``: ms per call of ``F``, ``Jt``, ``Jc``, ``hess_res`` and
  ``hess_cons`` at B = 1 and B = 64, for ``biggs_exp6_24`` and example 01's
  constrained problem (``examples/torch_01_basics.py``); and for the
  weighted Hessians Σ wᵢ∇²Fᵢ three routes: forward over reverse
  (``torch.func.hessian``, the JAX package's ``jax.hessian`` and the
  port's), reverse over reverse (``jacrev`` of the vector–Jacobian
  product) and ``jacfwd`` of it, each with its largest difference from the
  first;
* ``solves``: ``biggs_exp6_24`` in float64 with the battery's uniform
  protocol (``linsolve="ldlt"``, ``atol=0``, ``rtol=1e-5``) under a budget,
  and example 01's last warm start (Gauss–Newton, condensed KKT, from
  (-5, 5), to ``max_eval``): status, iterations, host checks, the solve's
  clock and ms per check;
* ``trace`` (the CPU only): for each B = 1 evaluator of the battery's 90
  problems in float64 (``F``, ``F_and_Jt``, ``c_shifted``, ``Jc``,
  ``hess_res``, ``hess_cons``), ms per eager call, seconds to record its
  trace, ms per traced call, and the eager calls that the recording costs
  (``problem.TRACE_CALLS`` is read from these; the port traces only the
  derivatives, the values are timed to show why).

On a card the times end in ``torch.cuda.synchronize()``; the evaluators
then run eagerly (outside any graph).  Like the port's other entry points
it runs on the card unless ``--device cpu`` is given.  One intra-op thread:

    OMP_NUM_THREADS=1 python -m cannoles_tpu_torch.host_timings [--device {cuda,cpu}]
        [--what {evaluators,solves,trace,all}] [--max-time 60] [--json OUT]

Run as a file with ``--root DIR`` it times the ``cannoles_tpu_torch`` under
DIR instead (for example a ``git archive`` of another commit), with the
same code: ``python cannoles_tpu_torch/host_timings.py --root DIR``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
from torch.func import hessian, jacfwd, jacrev, vjp, vmap

__all__ = ["evaluator_times", "solve_times", "trace_costs", "main"]


def _example01(device):
    from cannoles_tpu_torch import nls_problem

    return nls_problem(
        lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
        cons=lambda x: (x[0] + x[1]).reshape(1), lcon=[1.0], ucon=[1.0], device=device,
        name="example01",
    )


def _biggs(device):
    from cannoles_tpu_torch.battery import collect

    make = next(it[2] for it in collect() if it[1] == "biggs_exp6_24")
    return make(dtype=torch.float64, device=device)


def _ms(fn, dev, reps=50):
    for _ in range(3):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _routes(fn):
    """The weighted-Hessian routes on one instance: z, w ↦ Σ wᵢ∇²fnᵢ(z)."""

    def jtw(z, w):
        return vjp(lambda zz: fn(zz, None), z)[1](w)[0]

    return {
        "forward_over_reverse": hessian(lambda z, w: (fn(z, None) * w).sum()),
        "reverse_over_reverse": jacrev(jtw),
        "jacfwd_of_vjp": jacfwd(jtw),
    }


def evaluator_times(device) -> dict:
    dev = torch.device(device)
    out = {}
    for label, pb in (("biggs_exp6_24", _biggs(dev)), ("example01", _example01(dev))):
        rng = np.random.default_rng(0)
        row = {}
        for B in (1, 64):
            x = pb.x0[None] + 0.05 * torch.as_tensor(rng.normal(size=(B, pb.nvar)), device=dev)
            r = torch.as_tensor(rng.normal(size=(B, pb.nequ)), device=dev)
            y = torch.as_tensor(rng.normal(size=(B, pb.ncon)), device=dev)
            calls = {"F": lambda: pb.F(x), "Jt": lambda: pb.Jt(x), "hess_res": lambda: pb.hess_res(x, r)}
            if pb.ncon:
                calls.update(Jc=lambda: pb.Jc(x), hess_cons=lambda: pb.hess_cons(x, y))
            row[f"B={B}"] = {k: _ms(f, dev) for k, f in calls.items()}
            for kind, fn, w in (("res", pb.residual, r), ("cons", pb.cons, y)):
                if fn is None:
                    continue
                routes = _routes(fn)
                ref = vmap(routes["forward_over_reverse"])(x, w)
                for name, h in routes.items():
                    if B == 1:
                        call = lambda h=h: h(x[0], w[0])[None]  # noqa: E731
                    else:
                        call = lambda h=h: vmap(h)(x, w)  # noqa: E731
                    diff = float((call() - ref).abs().max() / ref.abs().max().clamp_min(1e-300))
                    row[f"B={B}"][f"hess_{kind}:{name}"] = dict(ms=_ms(call, dev), rel_diff=diff)
        out[label] = row
    return out


def solve_times(device, max_time=60.0) -> dict:
    from cannoles_tpu_torch import CaNNOLeSSolver

    dev = torch.device(device)
    out = {}
    s = CaNNOLeSSolver(_biggs(dev), linsolve="ldlt")
    st = s.solve(atol=0.0, rtol=1e-5, max_time=max_time)
    out["biggs_exp6_24"] = dict(status=st.status, iter=st.iter, host_checks=s.host_syncs,
                                solve_s=st.elapsed_time, ms_per_check=1e3 * st.elapsed_time / s.host_syncs,
                                route=getattr(s, "route", "eager"), **st.solver_specific)
    s = CaNNOLeSSolver(_example01(dev), method="gauss_newton", kkt="condensed")
    s.solve(x0=torch.tensor([0.0, 0.0], dtype=torch.float64, device=dev))  # the example's first start
    h0 = s.host_syncs
    st = s.solve(x0=torch.tensor([-5.0, 5.0], dtype=torch.float64, device=dev), max_time=max(max_time, 600.0))
    n = s.host_syncs - h0
    out["example01_last_start"] = dict(status=st.status, iter=st.iter, host_checks=n, solve_s=st.elapsed_time,
                                       ms_per_check=1e3 * st.elapsed_time / n,
                                       route=getattr(s, "route", "eager"),
                                       **st.solver_specific)
    return out


def trace_costs(reps=20) -> dict:
    """The B = 1 evaluators of the battery's problems on the CPU, float64,
    at x0: eager and traced ms per call, seconds to record the trace, and
    the eager calls that the recording costs; the derivatives' deciles of
    the last.  The values (``F``, ``c_shifted``), which the port does not
    trace, are traced here to show why."""
    from cannoles_tpu_torch import problem as P
    from cannoles_tpu_torch.battery import collect

    dev = torch.device("cpu")
    rows, ratios = {}, []
    for _, name, make, _ in collect():
        pb = make(dtype=torch.float64, device=dev)
        rng = np.random.default_rng(0)
        x = pb.x0[None].clone()
        r = torch.as_tensor(rng.normal(size=(1, pb.nequ)), device=dev)
        y = torch.as_tensor(rng.normal(size=(1, pb.ncon)), device=dev)
        # (evaluator, its one-instance callable's key, a call that builds it, its arguments)
        todo = [("F", None, None, (x[0], None)), ("F_and_Jt", "FJfwd", lambda: pb.F_and_Jt(x), (x[0], None))]
        if pb.has_residual_hessian:
            todo.append(("hess_res", "Hres_ad", lambda: pb.hess_res(x, r), (x[0], r[0], None)))
        if pb.ncon:
            todo += [("c_shifted", None, None, (x[0], None)), ("Jc", "Jcfwd", lambda: pb.Jc(x), (x[0], None)),
                     ("hess_cons", "Hcon_ad", lambda: pb.hess_cons(x, y), (x[0], y[0], None))]
        row = {}
        for k, key, build, args in todo:
            if key is None:
                one = pb.residual if k == "F" else pb.cons
            else:
                build()
                one = pb._fns[key]
            eager = _ms(lambda: one(*args), dev, reps)
            t0 = time.perf_counter()
            try:
                tr = P._Trace(one, args)
            except Exception as e:  # noqa: BLE001 - recorded
                row[k] = dict(untraced=f"{type(e).__name__}: {e}")
                continue
            record = time.perf_counter() - t0
            leaves = P._tensors(args, [])
            traced = _ms(lambda: tr(leaves), dev, reps)
            calls_per_trace = 1e3 * record / eager
            if key is not None:
                ratios.append(calls_per_trace)
            row[k] = dict(eager_ms=eager, traced_ms=traced, record_s=record, eager_calls=calls_per_trace)
        rows[name] = row
    q = np.quantile(ratios, [0.1, 0.25, 0.5, 0.75, 0.9]).tolist() if ratios else []
    return dict(rows=rows, derivatives=len(ratios), derivative_eager_calls_deciles_10_25_50_75_90=q)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--what", choices=("evaluators", "solves", "trace", "all"), default="all")
    ap.add_argument("--max-time", type=float, default=60.0, help="biggs_exp6_24's budget")
    ap.add_argument("--json", default=None)
    ap.add_argument("--root", default=None, help="time the package under this directory")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("host_timings: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    if args.what == "trace" and args.device != "cpu":
        ap.error("--what trace times the CPU's traces: pass --device cpu")
    import cannoles_tpu_torch

    out = dict(device=args.device, threads=torch.get_num_threads(), package=cannoles_tpu_torch.__file__)
    if args.device == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    if args.what in ("evaluators", "all"):
        out["evaluators_ms"] = evaluator_times(args.device)
    if args.what in ("solves", "all"):
        out["solves"] = solve_times(args.device, args.max_time)
    if args.what in ("trace", "all") and args.device == "cpu":
        out["trace"] = trace_costs()
    text = json.dumps(out, indent=1)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
