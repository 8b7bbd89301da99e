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

The exchange between chips has no fault here: every cell runs on one card.
"""

from __future__ import annotations

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
