"""launches_per_call (``launches_per_call.sweep`` in the sweep cells):
launches of the fused LDL^T kernel per vsolve call over the traced run's
window, graph replays included.

Reads the program's counter ``cannoles_tpu_torch.ops.fused_ldlt.LAUNCHES``
(through ``core.segments.counters()``; a replayed graph adds what its capture
launched) before and after the window.  A rescue that re-solves fewer lanes
in fewer trips, or chunks that end sooner, lower it.
"""

UNIT = "launches/call"
SOURCE = "program_counter"
LAYER = "vsolve and its rescue (parallel/batch.py)"


def read(ctx):
    launches = ctx.counters.get("fused_ldlt", 0)
    if ctx.calls == 0 or launches == 0:
        return None
    return launches / ctx.calls
