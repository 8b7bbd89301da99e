"""schur_ba: each call is one ``SchurBASolver.solve`` of one BA problem
(B = 1) on its observation list, with the configuration's ``max_iter`` and
its solver options, the input's observations in place of the problem's
(``solve(data=)``) and its own start.  One operation is one solve.

Besides x, r, lam, status and nfact (each with a lane axis) a call returns
the deltas of the program's counters ``("schur", "assemble")`` (camera
systems assembled) and ``("schur", "pairs")`` (pair blocks summed) over the
call, None where the program has no such counter, and ``scene``, the
observation structure's counts that the roofline's reader counts the work
from (``metrics/schur_pairs_roofline.py``).
"""

from __future__ import annotations

import torch


def _counts():
    from cannoles_tpu_torch.core import segments

    c = segments.counters()
    return c.get(("schur", "assemble")), c.get(("schur", "pairs"))


class Entry:
    def __init__(self, mix, options):
        from cannoles_tpu_torch.core.ba import SchurBASolver

        from portbench.metrics.schur_pairs_roofline import structure

        if mix.batch != 1:
            raise ValueError(f"traffic {mix.traffic_name!r}: the schur_ba entry solves one problem per call")
        cfg = mix.cfg
        self.problem = mix.family.problem(cfg, mix.device, mix.shared)
        self.solver = SchurBASolver(self.problem, cfg["n_cams"], cfg["n_pts"], dtype=getattr(torch, cfg["dtype"]),
                                    device=mix.device, **options)
        self.max_iter = int(cfg["max_iter"])
        self.scene = structure(mix.shared["cam_idx"], mix.shared["pt_idx"], cfg["n_cams"], cfg["cam_params"])

    def call(self, item) -> dict:
        before = _counts()
        data = dict(self.problem.data, **{k: v[0] for k, v in item["data"].items()})
        self.solver.solve(item["x0"][0], data=data, max_iter=self.max_iter)
        after = _counts()
        s = self.solver.last_state
        assemble, pairs = (None if a is None else a - (b or 0) for a, b in zip(after, before))
        return dict(x=s.x, r=s.r, lam=s.lam, status=s.status, nfact=s.nfact, assemble=assemble, pairs=pairs,
                    scene=self.scene)
