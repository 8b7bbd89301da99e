"""Tracing and per-stage timing.

Port of ``cannoles_tpu/utils/profiling.py``.

* :func:`stage_timings`: seconds per stage of one dense solve (B = 1)
  after a warm-up call: ``init`` (evaluations and the CGLS multiplier
  estimate), ``outer_step`` (one outer iteration) and ``newton_system``
  (assembly and the inertia-corrected factorize-and-solve).  On a card the
  stages are timed with CUDA events, on the CPU with ``time.perf_counter``.
* :func:`trace`: a ``torch.profiler`` capture (CPU and, with a card, CUDA
  activity) written as a Chrome trace, ``trace.json`` under ``log_dir``.

The counters (nfact, nlinsolve, nbk, ncg, evaluations) ride the state.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Dict

import torch

from ..core.solver import _add_batch_axis

__all__ = ["stage_timings", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing).  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _timer(device: torch.device, reps: int):
    """Seconds per call of ``fn`` over ``reps`` calls, after one warm-up."""

    def bench(fn):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize(device)
            return a.elapsed_time(b) / 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps

    return bench


def stage_timings(solver, x0=None, lam0=None, reps: int = 10, **numeric) -> Dict[str, float]:
    """Seconds per stage (``init``, ``outer_step``, ``newton_system``) of a
    ``CaNNOLeSSolver`` at x0 (default ``problem.x0``), averaged over
    ``reps`` calls, under the solver's ``matmul_precision``."""
    pb = solver.problem
    dev = solver.device
    x0 = torch.as_tensor(pb.x0 if x0 is None else x0, dtype=solver.dtype, device=dev).reshape(1, -1)
    lam0 = torch.as_tensor(pb.y0 if lam0 is None else lam0, dtype=solver.dtype, device=dev).reshape(1, -1)
    cfg = solver.make_config(**numeric)
    data = _add_batch_axis(pb.data, dev)
    active = torch.ones((1,), dtype=torch.bool, device=dev)
    bench = _timer(dev, reps)

    out: Dict[str, float] = {}
    with solver._matmul_scope():
        out["init"] = bench(lambda: solver._init_state(x0, lam0, cfg, data))
        state = solver._init_state(x0, lam0, cfg, data)
        out["outer_step"] = bench(lambda: solver._outer_step(state, cfg, active))

    m = pb.nequ

    def newton_only():
        s = state
        H = solver._H_block(s.x, s.lam, s.r, s.Fx, s.JxT, s.damp, s.data)
        if solver.kkt == "condensed":
            K0 = solver._assemble_condensed(H, s.JxT, s.Jcx, s.delta)
            b = torch.cat([s.dual + (s.JxT @ s.primal[:, :m, None])[..., 0], s.primal[:, m:]], -1)
            return solver._newton_system(K0, b, s.rho_old, active)[0]
        W0 = solver._assemble_kkt(H, s.JxT, s.Jcx, s.delta)
        return solver._newton_system(W0, torch.cat([s.dual, s.primal], -1), s.rho_old, active)[0]

    with solver._matmul_scope():
        out["newton_system"] = bench(newton_only)
    return out
