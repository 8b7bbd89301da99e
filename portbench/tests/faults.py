"""Faults planted in the program under test, to see ``correct`` come out
false (``test_portbench_runs.py``).  Each patches the program in the
process that runs the harness; none is ever planted by a benchmark run.

* ``state_unchanged``: the solver's outer step returns without changing
  the state, and the run ends there.
* ``half_batch``: ``vsolve`` solves the first half of the lanes and returns
  their results for the second half too.
* ``answer_altered``: ``CaNNOLeSSolver.run`` returns lane 0's x moved by 5%
  of its size.
* ``rescue_skipped``: ``vsolve`` runs without its rescue, so the lanes that
  the straggler cap stopped come back unsolved.

Faults of a cell on several ranks (planted in every rank's process; each
acts on the rank it names):

* ``rank_answer_altered``: rank 1 moves its first lane's x by 5% of its size
  before the gather, so every rank holds the altered lane.
* ``exchange_skipped``: the gather is left out: each rank keeps its own
  lanes and zeros for the others'.
* ``rank_copy_altered``: rank 2 moves lane 0's x in its own copy of the
  gathered batch, so its outputs differ from rank 0's.
* ``stats_off``: ``batch_convergence_stats`` counts one solved lane too
  many.
* ``rank_raises``: rank 1 raises in its third ``vsolve`` call.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch


def state_unchanged():
    from cannoles_tpu_torch.core.solver import CaNNOLeSSolver

    CaNNOLeSSolver._outer = lambda self, t, rows=True: False


def half_batch():
    import cannoles_tpu_torch
    from cannoles_tpu_torch.core.solver import TENSOR_FIELDS
    from cannoles_tpu_torch.parallel import batch

    orig = batch.vsolve

    def vsolve(problem, x0_batch, lam0_batch=None, data_batch=None, **kw):
        h = x0_batch.shape[0] // 2
        if kw.get("chunk_size") and h % kw["chunk_size"]:
            kw["chunk_size"] = None
        res = orig(problem, x0_batch[:h], None if lam0_batch is None else lam0_batch[:h],
                   None if data_batch is None else data_batch[:h], **kw)
        st = res.states
        st = st._replace(**{f: torch.cat([getattr(st, f)] * 2) for f in TENSOR_FIELDS})
        return batch.BatchResult(states=st, solver=res.solver)

    batch.vsolve = vsolve
    cannoles_tpu_torch.vsolve = vsolve


def answer_altered():
    from cannoles_tpu_torch.core.solver import CaNNOLeSSolver

    orig = CaNNOLeSSolver.run

    def run(self, x0, lam0, cfg, data=None):
        st = orig(self, x0, lam0, cfg, data)
        x = st.x.clone()
        x[0] += 5e-2 * (1 + x[0].abs())
        return st._replace(x=x)

    CaNNOLeSSolver.run = run


def rescue_skipped():
    import cannoles_tpu_torch
    from cannoles_tpu_torch.parallel import batch

    orig = batch.vsolve

    def vsolve(*args, **kw):
        kw["rescue"] = False
        return orig(*args, **kw)

    batch.vsolve = vsolve
    cannoles_tpu_torch.vsolve = vsolve


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _moved(st):
    x = st.x.clone()
    x[0] += 5e-2 * (1 + x[0].abs())
    return st._replace(x=x)


def rank_answer_altered():
    from cannoles_tpu_torch.parallel import batch

    orig = batch._gather_lanes

    def gather(part, mesh, B, lanes, data):
        return orig(_moved(part) if _rank() == 1 else part, mesh, B, lanes, data)

    batch._gather_lanes = gather


def exchange_skipped():
    from cannoles_tpu_torch.parallel import batch

    orig = batch._gather_lanes

    def gather(part, mesh, B, lanes, data):
        alone = dataclasses.replace(mesh, ranks=(mesh.ranks[mesh.rank],), rank=0)
        return orig(part, alone, B, lanes, data)

    batch._gather_lanes = gather


def rank_copy_altered():
    from cannoles_tpu_torch.parallel import batch

    orig = batch._gather_lanes

    def gather(part, mesh, B, lanes, data):
        st = orig(part, mesh, B, lanes, data)
        return _moved(st) if _rank() == 2 else st

    batch._gather_lanes = gather


def stats_off():
    from cannoles_tpu_torch.parallel import multihost

    orig = multihost.batch_convergence_stats

    def stats(states, mesh):
        out = orig(states, mesh)
        return dict(out, solved=out["solved"] + 1)

    multihost.batch_convergence_stats = stats


def rank_raises():
    import cannoles_tpu_torch
    from cannoles_tpu_torch.parallel import batch

    orig, calls = batch.vsolve, itertools.count()

    def vsolve(*args, **kw):
        if _rank() == 1 and next(calls) == 2:
            raise RuntimeError("planted: rank 1 raises in its third vsolve call")
        return orig(*args, **kw)

    batch.vsolve = vsolve
    cannoles_tpu_torch.vsolve = vsolve
