"""The reduction of a profiled slice to busy time, device operations and
idle gaps.

The slice is the benchmark's own host span ``portbench.slice`` around
whole calls of the mix; inside it the benchmark's spans ``portbench.draw``,
``portbench.<entry>`` (the call into the program) and
``portbench.synchronize`` say what the host was doing.  Device operations
are the profiler's events whose device is the card, clipped to the slice,
but for the device-side copies of the benchmark's own spans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .profiling import busy_s

__all__ = ["Slice", "reduce_events", "SPAN_PREFIX"]

SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Slice:
    window_s: float  # the length of the slice span
    busy_s: float  # the union of the device operations inside it
    device_ops: List[Tuple[str, float, float]]  # (name, start us, end us), clipped
    host_spans: List[Tuple[str, float, float]]  # the benchmark's spans inside it
    outputs: list  # the calls' outputs
    calls: int

    def op_seconds(self) -> List[Tuple[str, float]]:
        """Device seconds by operation name, the largest first."""
        acc: dict = {}
        for name, s, e in self.device_ops:
            acc[name] = acc.get(name, 0.0) + (e - s) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def idle_gaps(self, window: Tuple[float, float]) -> List[Tuple[str, float]]:
        """The device's idle gaps inside ``window`` (us), each named by the
        innermost benchmark span open on the host where it starts, the
        longest first."""
        lo, hi = window
        merged = []
        for s, e in sorted((s, e) for _, s, e in self.device_ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps, t = [], lo
        for s, e in merged:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        out = []
        for s, e in gaps:
            open_ = [(hs, name) for name, hs, he in self.host_spans if hs <= s < he and name != "slice"]
            label = max(open_)[1] if open_ else "between calls"
            out.append((label, (e - s) / 1e6))
        return sorted(out, key=lambda kv: -kv[1])


def reduce_events(events, outputs, calls: int) -> Tuple[Slice, Tuple[float, float]]:
    """A :class:`Slice` from a profiler session's events (``profiling.Event``)
    and the slice span's (start, end) in us."""
    spans = [(e.name[len(SPAN_PREFIX):], e.start, e.end)
             for e in events if not e.cuda and e.name.startswith(SPAN_PREFIX)]
    window = next(((s, e) for name, s, e in spans if name == "slice"), None)
    if window is None:
        raise RuntimeError("the profiled session has no portbench.slice span")
    lo, hi = window
    ops = []
    for e in events:
        # the benchmark's spans also come back as device-side annotations
        if e.cuda and not e.name.startswith(SPAN_PREFIX):
            s, t = max(e.start, lo), min(e.end, hi)
            if t > s:
                ops.append((e.name, s, t))
    sl = Slice(window_s=(hi - lo) / 1e6, busy_s=busy_s([(s, t) for _, s, t in ops]), device_ops=ops,
               host_spans=spans, outputs=outputs, calls=calls)
    return sl, window
