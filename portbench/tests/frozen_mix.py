"""A frozen copy of ``portbench/common/mix.py``'s ``Mix`` and of
``portbench/common/draws.py``'s ``order`` before entries were kept in files
of their own (commit 1663216f4c2820b3532791bab787e17db179f912),
for ``test_the_built_in_entries_make_the_same_calls``: the ``vsolve`` and
``run`` entries (``entries/``) and the bank of one card must give the same
bits as the calls the generator made then.
"""

from __future__ import annotations

import torch

__all__ = ["FrozenMix", "order"]


def order(bank: list, seed: int) -> list:
    """The inputs of ``bank`` in an order drawn from ``seed``, and the lanes
    of each (the leading axis of every tensor of an input) too; drawn on the
    host, so that a seed gives one order on every device."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    out = []
    for k in torch.randperm(len(bank), generator=g).tolist():
        item = bank[k]
        lanes = torch.randperm(item["x0"].shape[0], generator=g).to(item["x0"].device)
        out.append(_take(item, lanes))
    return out


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree[idx]


class FrozenMix:
    """The system under test for one cell: the program's problem and solver
    built from the configuration, the bank of inputs and the call of the
    mix.  ``control``: the name of one of the configuration's ``controls``
    (``configs/<config>.json``), run in the sound program's place: one that
    gives ``solver`` options is the program with its own lower-precision
    path switched on; one that gives ``reference`` is ``reference.control``
    at that precision."""

    def __init__(self, cell, device, seed: int, control: str = None, reference=None):
        from portbench.common.draws import generator

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.traffic = cfg, tr
        self.kind = tr["entry"]
        if self.kind not in ("vsolve", "run"):
            raise ValueError(f"traffic {cell.traffic_name!r}: unknown entry {self.kind!r}")
        self.batch = int(tr.get("batch", 1))
        if self.kind == "run" and self.batch != 1:
            raise ValueError(f"traffic {cell.traffic_name!r}: the run entry solves one instance per call")
        family = cell.family()
        g = generator(seed, device)
        self.shared = family.shared_inputs(cfg, g, device)
        pool = tr.get("pool_seed")
        self.drawn = family.draw(cfg, g if pool is None else generator(pool, device), int(tr["bank"]),
                                 self.batch, device, self.shared)
        self.bank = self.drawn if pool is None else order(self.drawn, seed)
        # the traced slice: the first inputs as drawn, the same for every seed of a pool
        self.slice = [self.drawn[k % len(self.drawn)] for k in range(int(tr["slice_calls"]))]
        self.control = None
        options = dict(cfg["solver"])
        if control is not None:
            spec = cfg["controls"][control]
            options.update(spec.get("solver", {}))
            if "reference" in spec:
                self.control = lambda item: reference.control(item, self.shared, spec["reference"])

        from cannoles_tpu_torch import CaNNOLeSSolver

        self.problem = family.problem(cfg, device, self.shared)
        dtype = getattr(torch, cfg["dtype"])
        self.solver = CaNNOLeSSolver(self.problem, dtype=dtype, device=device, **options)
        self.cap = {}
        if cfg.get("straggler_from_batch") is not None and self.batch >= cfg["straggler_from_batch"]:
            self.cap = {"max_eval": int(cfg["straggler_max_eval"])}
        if self.kind == "run":
            self.run_cfg = self.solver.make_config(max_iter=int(cfg["max_iter"]))
            self.lam0 = self.problem.y0.to(dtype=dtype, device=device).expand(1, self.problem.ncon)

    def call(self, item) -> dict:
        """One call of the mix on ``item``: the returned x, r (the method's
        residual variable), lam, status and nfact, each with a leading lane
        axis."""
        if self.control is not None:
            out = self.control(item)
            return dict(out, nfact=torch.zeros_like(out["status"]))
        if self.kind == "vsolve":
            from cannoles_tpu_torch import vsolve

            st = vsolve(self.problem, item["x0"], data_batch=item["data"], solver=self.solver,
                        max_iter=int(self.cfg["max_iter"]), chunk_size=self.traffic.get("chunk"),
                        rescue=bool(self.cfg["rescue"]), **self.cap).states
        else:
            st = self.solver.run(item["x0"], self.lam0, self.run_cfg, item["data"])
        return dict(x=st.x, r=st.r, lam=st.lam, status=st.status, nfact=st.nfact)

    def free(self):
        """Drop the program's problem and solver (its graphs and banks)."""
        self.solver = self.problem = None
