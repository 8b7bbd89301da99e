"""run: each call is one ``CaNNOLeSSolver.run`` of one instance (B = 1), as
``cannoles_tpu_torch.bench._large_solve`` calls it.  One operation is one
solve."""

from __future__ import annotations

import torch


class Entry:
    def __init__(self, mix, options):
        from cannoles_tpu_torch import CaNNOLeSSolver

        if mix.batch != 1:
            raise ValueError(f"traffic {mix.traffic_name!r}: the run entry solves one instance per call")
        cfg = mix.cfg
        dtype = getattr(torch, cfg["dtype"])
        self.problem = mix.family.problem(cfg, mix.device, mix.shared)
        self.solver = CaNNOLeSSolver(self.problem, dtype=dtype, device=mix.device, **options)
        self.run_cfg = self.solver.make_config(max_iter=int(cfg["max_iter"]))
        self.lam0 = self.problem.y0.to(dtype=dtype, device=mix.device).expand(1, self.problem.ncon)

    def call(self, item) -> dict:
        st = self.solver.run(item["x0"], self.lam0, self.run_cfg, item["data"])
        return dict(x=st.x, r=st.r, lam=st.lam, status=st.status, nfact=st.nfact)
