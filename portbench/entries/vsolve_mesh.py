"""vsolve_mesh: BASELINE.json config 5, a batch split over every rank's card.

Each call, on every rank of the run (``common/ranks.py``), is one ``vsolve``
of the whole batch over the program's batch mesh of every rank
(``make_batch_mesh``): each rank solves its B/k lanes unchunked (a mesh
takes no chunks) with the configuration's ``max_iter``, its straggler cap
(``max_eval`` from ``straggler_from_batch`` lanes of the whole batch on)
and its own rescue, and gets every lane back (``_gather_lanes``, one
all-reduce).  Then ``batch_convergence_stats`` sums the batch's solved
lanes, lanes and iterations over the ranks and takes the worst dual
residual (one all-reduce SUM, one MAX): config 5's "psum convergence
stats".  The call is the ``vsolve`` entry's (``entries/vsolve.py``) with
``mesh=``.  One operation is one instance.  Without a process group the mesh
has one rank and its collectives return their input.

``judge``: ``stats_gap``, the lanes by which the statistics' ``solved`` and
``n`` differ from the count of the gathered statuses that say solved and
from the batch, summed over the calls; an exact comparison, limit 0.
"""

from __future__ import annotations

from portbench.entries.vsolve import Entry as VSolve

LIMITS = {"stats_gap": 0}
SOLVED = (1, 2)  # first_order, small_residual


class Entry(VSolve):
    def __init__(self, mix, options):
        from cannoles_tpu_torch.parallel.mesh import make_batch_mesh

        super().__init__(mix, options)
        self.mesh = make_batch_mesh(device=mix.device)

    def call(self, item) -> dict:
        from cannoles_tpu_torch.parallel.multihost import batch_convergence_stats

        st = self.states(item, mesh=self.mesh)
        stats = batch_convergence_stats(st, self.mesh)
        return dict(x=st.x, r=st.r, lam=st.lam, status=st.status, nfact=st.nfact, stats=stats)


def judge(pairs) -> dict:
    gap = 0
    for _, out in pairs:
        status = out["status"]
        solved = int(((status == SOLVED[0]) | (status == SOLVED[1])).sum())
        stats = out.get("stats")
        if stats is None:
            return {"stats_gap": None}
        gap += abs(stats["solved"] - solved) + abs(stats["n"] - status.shape[0])
    return {"stats_gap": gap}
