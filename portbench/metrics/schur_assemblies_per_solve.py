"""schur_assemblies_per_solve (``schur_assemblies_per_solve.bal``): camera
systems assembled per solve in the traced slice.

Reads the program's counter ``("schur", "assemble")`` (one a rho attempt of
the Schur engine, ``core.segments.counters()``) through the deltas that the
``schur_ba`` entry returns with each call, summed over the slice's solves
and divided by them.  Fewer attempts a solve (a rho ladder that fails less, an
inner loop that ends sooner) lower solve_ms.  It reads nothing where the
program has no such counter.
"""

UNIT = "assemblies/solve"
SOURCE = "program_counter"
LAYER = "rho ladder of the Schur engine (core/ba.py, core/matfree.py)"


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.outputs:
        return None
    counts = [out.get("assemble") for out in sl.outputs]
    if any(c is None for c in counts) or sum(counts) == 0:
        return None
    return sum(counts) / len(counts)
