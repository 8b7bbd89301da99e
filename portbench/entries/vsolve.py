"""vsolve: each call is one ``vsolve`` of the mix's ``batch`` instances (in
chunks of ``chunk`` lanes where the mix gives one), with the configuration's
``max_iter``, its straggler cap (``max_eval`` from ``straggler_from_batch``
lanes on) and its rescue.  One operation is one instance."""

from __future__ import annotations

import torch


class Entry:
    def __init__(self, mix, options):
        from cannoles_tpu_torch import CaNNOLeSSolver

        cfg = mix.cfg
        self.mix = mix
        self.problem = mix.family.problem(cfg, mix.device, mix.shared)
        self.solver = CaNNOLeSSolver(self.problem, dtype=getattr(torch, cfg["dtype"]), device=mix.device, **options)
        self.cap = {}
        if cfg.get("straggler_from_batch") is not None and mix.batch >= cfg["straggler_from_batch"]:
            self.cap = {"max_eval": int(cfg["straggler_max_eval"])}

    def states(self, item, **kw):
        """The program's states of one ``vsolve`` of ``item`` (``kw``: more
        of its arguments)."""
        from cannoles_tpu_torch import vsolve

        cfg = self.mix.cfg
        return vsolve(self.problem, item["x0"], data_batch=item["data"], solver=self.solver,
                      max_iter=int(cfg["max_iter"]), rescue=bool(cfg["rescue"]), **self.cap, **kw).states

    def call(self, item) -> dict:
        st = self.states(item, chunk_size=self.mix.traffic.get("chunk"))
        return dict(x=st.x, r=st.r, lam=st.lam, status=st.status, nfact=st.nfact)
