"""The card's operations under ``torch.profiler``, and the device's busy time.

Frozen copy of the recipe of ``cannoles_tpu_torch/utils/profiling.py`` at
commit 1ca66b23abd7dda613dfa1e36f885e66d5322e60 (``busy_s``, ``_session``,
``_profiler_works``, ``profile_device``), kept here so that a change to the
program cannot move the benchmark's yardstick.  Three things differ: the
log function; the events a session returns: every event of the session
(host spans included, for the idle gaps) as plain ``Event`` tuples read
from the profiler's raw results, which costs seconds where building
``prof.events()`` took minutes for the 1.8 million device operations of one
65,536-instance sweep call; and the ranks' agreement (``agree``) of a run
on several cards.

torch.profiler on the card goes through CUPTI, which lost device operations
on an H100 in two ways.  (1) Started early (before the kernels' libraries
were loaded, or just after), it recorded only part of the card's operations
in every later session; started first at the first reading, after a warm
call of what it reads, it recorded all.  So the profiler starts at the
first reading (``_profiler_works``), once the kernels are loaded.  (2) A
session that starts after the card has idled for seconds may lose its first
device operations; a spin kernel of about 100 ms launched just before the
session keeps the card busy across the profiler's start, and the session's
work queues behind it (``_session``; launched before the session, the spin
is in no reading).  A session that records no device operation is
repeated, up to ``PROFILE_TRIES`` sessions; in a run on several cards,
every rank profiles its own slice and repeats a session where any rank's
recorded none.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

__all__ = ["busy_s", "profile_device", "Event", "PROFILE_TRIES"]

PROFILE_TRIES = 3
PROFILE_LEAD_CYCLES = 200_000_000  # ~100 ms at the H100's SM clock (<= 1.98 GHz)
_PROFILER_WORKS = [None]


class Event(NamedTuple):
    name: str
    cuda: bool  # an operation on the card (else the host)
    start: float  # us
    end: float  # us


def _events(prof) -> list:
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3,
                  (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def _stderr(*a):
    print(*a, file=sys.stderr, flush=True)


def busy_s(intervals) -> float:
    """Length of the union of [start, end) intervals given in us, in s."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def _session(fn):
    """``fn()`` and a synchronize under ``torch.profiler``, behind a spin
    kernel launched just before the session: ``fn``'s value and the
    session's events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(PROFILE_LEAD_CYCLES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, _events(prof)


def _every(flag: bool) -> bool:
    return flag


def _profiler_works(log=_stderr, agree=_every) -> bool:
    """Whether ``torch.profiler`` records the card's operations in this
    process: up to ``PROFILE_TRIES`` sessions around a plain kernel, the
    first time a reading is profiled.  ``agree(flag)``: whether the flag is
    set in every rank of a run on several cards (each its own process)."""
    if _PROFILER_WORKS[0] is None:
        x = torch.ones(1 << 20, device="cuda")
        seen = []
        for _ in range(PROFILE_TRIES):
            _, events = _session(lambda: x.mul_(1.0))
            seen.append(sum(1 for e in events if e.cuda))
            if seen[-1]:
                break
        _PROFILER_WORKS[0] = agree(bool(seen[-1]))
        log(f"# torch.profiler: device operations recorded per session {seen}")
    return _PROFILER_WORKS[0]


def profile_device(fn, what: str, log=_stderr, agree=None):
    """``fn()`` in a profiler session: ``fn``'s value, the session's
    ``Event``s and those whose device is the card.  A session that records no device
    operation is repeated (``fn`` runs again); after ``PROFILE_TRIES``
    sessions the call raises.  Where the profiler does not trace the card,
    ``fn`` runs once, unprofiled, and both lists are None.  ``agree``: as
    for ``_profiler_works``; then every rank repeats a session where one
    recorded no device operation, so that every rank runs ``fn`` as often."""
    agree = _every if agree is None else agree
    if not _profiler_works(log, agree):
        out = fn()
        torch.cuda.synchronize()
        return out, None, None
    for k in range(PROFILE_TRIES):
        out, events = _session(fn)
        device = [e for e in events if e.cuda]
        if agree(bool(device)):
            return out, events, device
        log(f"# torch.profiler recorded no device operation in {what} (session {k + 1} of {PROFILE_TRIES})")
    raise RuntimeError(f"torch.profiler recorded no device operation in {what} in {PROFILE_TRIES} sessions")
