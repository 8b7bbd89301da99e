"""Tracing and per-stage timing.

Port of ``cannoles_tpu/utils/profiling.py``.

* :func:`stage_timings`: seconds per stage of one dense solve (B = 1)
  after a warm-up call: ``init`` (evaluations and the CGLS multiplier
  estimate), ``outer_step`` (one outer iteration) and ``newton_system``
  (assembly and the inertia-corrected factorize-and-solve).  On a card the
  stages are timed with CUDA events, on the CPU with ``time.perf_counter``.
* :func:`trace`: a ``torch.profiler`` capture (CPU and, with a card, CUDA
  activity) written as a Chrome trace, ``trace.json`` under ``log_dir``.
* :func:`profile_device` and :func:`busy_s`: the card's operations of one
  call under ``torch.profiler``, and the device's busy time, the length of
  the union of their intervals (each operation counted once).  The card's
  readings of the port's runners (``bench``, ``chip_smoke.py``) go through
  them.

The counters (nfact, nlinsolve, nbk, ncg, evaluations) ride the state.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys
import time
from typing import Dict

import torch

from ..core.solver import _add_batch_axis

__all__ = ["stage_timings", "trace", "busy_s", "profile_device"]


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


def busy_s(intervals) -> float:
    """Length of the union of [start, end) intervals given in µs, in s."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


# torch.profiler on the card goes through CUPTI, which lost device
# operations on an H100 in two ways.  (1) Started early (before the
# kernels' libraries were loaded, or just after), it recorded only part of
# the card's operations in every later session (5 to 7 of the 11 of one
# Cholesky factorization); started first at the first reading, after a
# warm call of what it reads, it recorded all 11.  So the profiler starts
# at the first reading (``_profiler_works``, called from
# ``profile_device``), once the kernels are loaded.  (2) A session that
# starts after the card has idled for seconds may lose its first device
# operations; a spin kernel of about 100 ms launched just before the
# session keeps the card busy across the profiler's start, and the
# session's work queues behind it (``_session``; launched before
# the session, the spin is in no reading).  A session that records no
# device operation is repeated, up to PROFILE_TRIES sessions.  Where the
# first sessions around a plain kernel record nothing, the profiler does
# not trace this card at all, and its readings are not measured (None).
PROFILE_TRIES = 3
PROFILE_LEAD_CYCLES = 200_000_000  # ~100 ms at the H100's SM clock (≤ 1.98 GHz)
_PROFILER_WORKS = None


def _stderr(*a):
    print(*a, file=sys.stderr, flush=True)


def _session(fn):
    """``fn()`` and a synchronize under ``torch.profiler``, behind a spin
    kernel launched just before the session: ``fn``'s value and the
    session's events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(PROFILE_LEAD_CYCLES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof.events()


def _profiler_works(dev, log=_stderr) -> bool:
    """Whether ``torch.profiler`` records the card's operations in this
    process: up to ``PROFILE_TRIES`` sessions around a plain kernel, the
    first time a reading is profiled (they also start CUPTI, before the
    first session that is read)."""
    global _PROFILER_WORKS
    if _PROFILER_WORKS is None:
        from torch.autograd import DeviceType

        x = torch.ones(1 << 20, device=dev)
        seen = []
        for _ in range(PROFILE_TRIES):
            _, events = _session(lambda: x.mul_(1.0))
            seen.append(sum(1 for e in events if e.device_type == DeviceType.CUDA))
            if seen[-1]:
                break
        _PROFILER_WORKS = bool(seen[-1])
        log(f"  torch.profiler: device operations recorded per session {seen}"
            + ("" if _PROFILER_WORKS else ": it does not trace this card; its readings are not measured"))
    return _PROFILER_WORKS


def profile_device(fn, what: str, log=_stderr):
    """``fn()`` in a profiler session (``_session``): ``fn``'s
    value, the session's events and those whose device is the card.  A
    session that records no device operation is repeated (``fn`` runs
    again), and after ``PROFILE_TRIES`` sessions the call raises.  Where the
    profiler does not trace the card (``_profiler_works``), ``fn`` runs once,
    unprofiled, and both lists are None."""
    from torch.autograd import DeviceType

    if not _profiler_works(torch.device("cuda", torch.cuda.current_device()), log):
        out = fn()
        torch.cuda.synchronize()
        return out, None, None
    for k in range(PROFILE_TRIES):
        out, events = _session(fn)
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        if device:
            return out, events, device
        log(f"  torch.profiler recorded no device operation in {what} (session {k + 1} of {PROFILE_TRIES})")
    raise AssertionError(f"torch.profiler recorded no device operation in {what} in {PROFILE_TRIES} sessions")


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
