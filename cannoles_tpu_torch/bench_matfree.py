"""The matrix-free engine on one huge fit whose Jacobian cannot be formed.

The counterpart of ``benchmarks/bench_matfree.py``: the separable model

    residual(w) = sin(t fᵀ) @ w − y,    t ∈ [0, 1]^m,  f ∈ [1, 50]^n,

at m = 2²¹ residuals and n = 4,096 parameters, whose float32 Jacobian
would take m·n·4 B = 32 GiB.  XLA fuses the (m, n) feature tile into the
matmul; PyTorch evaluates ``torch.sin(t[:, None] * f[None, :]) @ w`` op by
op, so it would build that matrix (twice) and keep it for the backward
pass.  :class:`SinFeatureMatvec` computes the product one block of
``TILE_ROWS`` rows at a time instead, and rebuilds each block for the
forward-mode and reverse-mode products, so no more than one block is ever
live.

The solve is the JAX script's: ``MatrixFreeSolver(cg_maxiter=100)``,
``solve(max_time=600, max_iter=30)``.  Besides the script's line it
reports, on a card:

* ``device_solve_s``: the solve's span between two CUDA events;
* ``products``: the tiled products the solve ran (forward, jvp, backward);
* ``host_syncs``: the solver's host reads;
* ``peak_mem_gb``: ``torch.cuda.max_memory_allocated`` over the solve;
* ``busy_share``: the device's busy time (the union of the CUDA events
  ``torch.profiler`` records) over the wall of a profiled window, the
  first outer iteration solved again.

On the CPU these device numbers are ``None`` (not measured).

    python -m cannoles_tpu_torch.bench_matfree [--m 2097152 --n 4096]
        [--cg-maxiter 100] [--device {cuda,cpu}] [--dtype {float32,float64}]

``--device cpu`` takes float64 unless ``--dtype`` says otherwise, as the
JAX script's ``--cpu`` does.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .core.matfree import MatrixFreeSolver
from .problem import NLSProblem, default_device, nls_problem
from .utils.profiling import busy_s

__all__ = ["SinFeatureMatvec", "separable_fit_problem", "run_fit", "parser", "main", "TILE_ROWS"]

# rows of one feature block: 65,536 × 4,096 float32 = 1 GiB
TILE_ROWS = 65_536
# the JAX script's solve
MAX_TIME = 600.0
MAX_ITER = 30
# the tiled products run so far (forward, jvp and backward each count one)
PRODUCTS = 0


def _block(t, f, lo):
    """sin(t[lo:lo+TILE_ROWS] fᵀ) in one allocation."""
    return torch.mul(t[lo:lo + TILE_ROWS, None], f[None, :]).sin_()


def _matvec(t, f, w):
    """sin(t fᵀ) @ w, block by block."""
    global PRODUCTS
    PRODUCTS += 1
    return torch.cat([_block(t, f, lo) @ w for lo in range(0, t.shape[0], TILE_ROWS)])


def _rmatvec(t, f, u):
    """sin(t fᵀ)ᵀ @ u, summed over the blocks."""
    global PRODUCTS
    PRODUCTS += 1
    out = None
    for lo in range(0, t.shape[0], TILE_ROWS):
        part = u[lo:lo + TILE_ROWS] @ _block(t, f, lo)
        out = part if out is None else out + part
    return out


class SinFeatureMatvec(torch.autograd.Function):
    """``SinFeatureMatvec.apply(t, f, w)`` = sin(t fᵀ) @ w for t (m,),
    f (n,), w (n,), with derivatives in ``w`` only: ``jvp`` is Φ·dw and
    ``backward`` Φᵀ·u, each rebuilding the blocks of Φ = sin(t fᵀ).  The
    vmap rule is generated, so ``torch.func.vmap`` over ``jvp`` and
    ``vjp`` batches it (the problem's data carry a batch axis there).  A
    tangent or cotangent asked for ``t`` or ``f`` raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t, f, w):
        return _matvec(t, f, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        t, f, _ = inputs
        # no tangent is made up for t or f: jvp sees None unless one is asked for
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(t, f)
        ctx.save_for_forward(t, f)

    @staticmethod
    def jvp(ctx, dt, df, dw):
        if dt is not None or df is not None:
            raise NotImplementedError("SinFeatureMatvec: derivatives in w only, not in t or f")
        t, f = ctx.saved_tensors
        return _matvec(t, f, dw)

    @staticmethod
    def backward(ctx, u):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError("SinFeatureMatvec: derivatives in w only, not in t or f")
        t, f = ctx.saved_tensors
        return None, None, _rmatvec(t, f, u)


def separable_fit_problem(m: int = 2**21, n: int = 4096, *, dtype: torch.dtype = torch.float32,
                          device=None, seed: int = 0):
    """The JAX script's problem: t = linspace(0, 1, m), then from
    ``default_rng(seed)`` the frequencies uniform(1, 50, n) and w_true =
    normal(n)/√n, all made in numpy and cast to ``dtype``; y = sin(t fᵀ) @
    w_true in ``dtype`` on ``device``.  Returns (problem, w_true as a numpy
    array in ``dtype``); x0 = 0.  ``device`` defaults to the card."""
    device = default_device(device)
    rng = np.random.default_rng(seed)

    def put(a):
        return torch.as_tensor(a).to(dtype=dtype, device=device)

    t = put(np.linspace(0, 1, m))
    f = put(rng.uniform(1, 50, size=n))
    w_true = put(rng.normal(size=n) / np.sqrt(n))
    with torch.no_grad():
        y = SinFeatureMatvec.apply(t, f, w_true)
    pb = nls_problem(lambda w, d: SinFeatureMatvec.apply(d["t"], d["f"], w) - d["y"],
                     torch.zeros(n, dtype=dtype, device=device), m, data={"t": t, "f": f, "y": y},
                     name="huge_separable_fit", device=device)
    return pb, w_true.cpu().numpy()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profiled_window(pb: NLSProblem, cg_maxiter: int, dev):
    """(busy seconds, wall seconds, device events) of the first outer
    iteration of a fresh solve under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver = MatrixFreeSolver(pb, cg_maxiter=cg_maxiter)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        solver.solve(max_time=MAX_TIME, max_iter=0)  # stops after iteration 1 (iter > max_iter)
        _sync(dev)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return busy_s([(e.time_range.start, e.time_range.end) for e in events]), wall, len(events)


def run_fit(m: int = 2**21, n: int = 4096, cg_maxiter: int = 100, *, device="cuda",
            dtype: torch.dtype = torch.float32, verbose: int = 0) -> dict:
    """Build the problem and solve it with the JAX script's recipe;
    returns one row of the script's numbers and the device's (the
    solution under ``"solution"``)."""
    dev = torch.device(device)
    pb, w_true = separable_fit_problem(m, n, dtype=dtype, device=dev)
    y = pb.data["y"]
    out = {"m": m, "n": n, "cg_maxiter": cg_maxiter, "device": dev.type,
           "dtype": str(dtype).replace("torch.", ""),
           "jac_gb": m * n * torch.finfo(dtype).bits / 8 / 2**30,
           "objective0": float(0.5 * (y * y).sum())}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    solver = MatrixFreeSolver(pb, cg_maxiter=cg_maxiter, dtype=dtype)
    products0 = PRODUCTS
    _sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        ev0.record()
    st = solver.solve(max_time=MAX_TIME, verbose=verbose, max_iter=MAX_ITER)
    if dev.type == "cuda":
        ev1.record()
    _sync(dev)
    wall = time.perf_counter() - t0
    sp = st.solver_specific
    out.update(status=st.status, iter=st.iter, nfact=sp["nfact"], ncg=sp["ncg"],
               nlinsolve=sp["nlinsolve"], neval_residual=sp["neval_residual"],
               objective=st.objective, param_err=float(np.max(np.abs(st.solution - w_true))),
               wall_s=wall, products=PRODUCTS - products0, host_syncs=solver.host_syncs,
               solution=st.solution)
    if dev.type == "cuda":
        out["device_solve_s"] = ev0.elapsed_time(ev1) / 1e3
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        busy, win, nev = _profiled_window(pb, cg_maxiter, dev)
        out.update(device_busy_s=busy, window_wall_s=win, device_events=nev, busy_share=busy / win)
    else:
        out.update(device_solve_s=None, peak_mem_gb=None, busy_share=None)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2**21)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--cg-maxiter", type=int, default=100)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float32 on the card, float64 on the CPU")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_matfree: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype or ("float32" if args.device == "cuda" else "float64"))
    r = run_fit(args.m, args.n, args.cg_maxiter, device=args.device, dtype=dtype, verbose=1)
    print(f"m={r['m']} n={r['n']} (J would be {r['jac_gb']:.1f} GB, never formed): "
          f"status={r['status']} iters={r['iter']} cg_total={r['ncg']} "
          f"wall={r['wall_s']:.2f}s param_err={r['param_err']:.2e}")
    r.pop("solution")
    print({k: v for k, v in r.items() if k not in ("m", "n")}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
