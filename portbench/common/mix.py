"""The one generator of the benchmark's traffic: a closed loop over a bank
of inputs made from the seed in set-up.

A mix (``traffic/<mix>.json``) names the entry it calls and its parameters:

* ``"entry": "vsolve"``: each call is one ``vsolve`` of ``batch`` instances
  (in chunks of ``chunk`` lanes when given), with the configuration's
  ``max_iter``, its straggler cap (``max_eval`` from ``straggler_from_batch``
  lanes on) and its rescue.  One operation is one instance.
* ``"entry": "run"``: each call is one ``CaNNOLeSSolver.run`` of one
  instance (B = 1), as ``cannoles_tpu_torch.bench._large_solve`` calls it.
  One operation is one solve.

``bank`` inputs are drawn in set-up (``configs/<config>.py`` ``draw``) from
the run's seed, or, where the mix gives a ``pool_seed``, from that fixed
seed, with the run's seed choosing the order of the inputs and of the lanes
inside each: then every seed does the same work in another order.  (A
sweep call runs to its slowest lane, and the slowest lanes of fresh draws
moved a call's time by up to 30x: the seed was changing the work.)  The
window takes the inputs in turn in whole passes (``harness.Run.window``);
set-up runs each once, so that every shape and every graph the window
replays is built before it.  ``slice_calls``: the calls of the traced
slice, on the inputs in the order they were drawn.
"""

from __future__ import annotations

import torch

__all__ = ["Mix"]


class Mix:
    """The system under test for one cell: the program's problem and solver
    built from the configuration, the bank of inputs and the call of the
    mix.  ``control``: the name of one of the configuration's ``controls``
    (``configs/<config>.json``), run in the sound program's place: one that
    gives ``solver`` options is the program with its own lower-precision
    path switched on; one that gives ``reference`` is ``reference.control``
    at that precision."""

    def __init__(self, cell, device, seed: int, control: str = None, reference=None):
        from .draws import generator, order

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
