"""host_syncs_per_solve (``host_syncs_per_solve.solve`` in the cells of one
solve at a time): host checks per solve over the traced run's window.

Reads the program's counter ``CaNNOLeSSolver.host_syncs`` (one per read of
a segment's flags, each a wait for the card) before and after the window.
Fewer checks per solve, or cheaper ones, lower solve_ms.
"""

UNIT = "syncs/solve"
SOURCE = "program_counter"
LAYER = "run loop and segments (core/solver.py, core/segments.py)"


def read(ctx):
    if ctx.solves == 0 or ctx.host_syncs == 0:
        return None
    return ctx.host_syncs / ctx.solves
