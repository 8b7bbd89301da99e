"""collective_pct (``collective_pct.mesh`` in the cells on several cards):
the share of rank 0's traced slice in which a collective kernel ran on its
card, in percent.

The union of the slice's device operations whose names are NCCL's
(``nccl`` in the name: its kernels and their annotations), over the slice's
wall.  A collective kernel spins until its peers have arrived, so the share
holds the wait for the slowest rank as well as the transfer.  Ranks that
share a card reduce over gloo through the host, with no such operation:
then, and where the slice was not traced, it reads nothing.
"""

from portbench.common.profiling import busy_s

UNIT = "%"
SOURCE = "device_trace"
LAYER = "mesh gather and stats (parallel/batch.py _gather_lanes, parallel/multihost.py)"


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0:
        return None
    spans = [(s, e) for name, s, e in sl.device_ops if "nccl" in name.lower()]
    if not spans:
        return None
    return 100.0 * busy_s(spans) / sl.window_s
