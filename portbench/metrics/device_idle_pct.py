"""device_idle_pct: the share of the traced slice in which no operation ran
on the card, in percent.

100 - 100 * busy / wall: busy is the union of the profiler's device
operations inside the benchmark's span around the slice (each operation
counted once, ``common/profiling.busy_s``), wall that span's length.  The
slice is the mix's ``slice_calls`` calls on its first inputs as drawn.
``BENCHMARK.json`` splits it by the end-to-end metric it moves:
``device_idle_pct.sweep`` (``instances_per_s``) and
``device_idle_pct.solve`` (``solve_ms``).
"""

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
