"""The one generator of the benchmark's traffic: a closed loop over a bank
of inputs made from the seed in set-up.

A mix (``traffic/<mix>.json``) names the entry it calls and its
parameters.  The entry is ``entries/<entry>.py``, found by name as
configurations and metric readers are: ``vsolve`` (one ``vsolve`` of
``batch`` instances a call, in chunks of ``chunk`` lanes where given),
``run`` (one ``CaNNOLeSSolver.run`` of one instance), ``vsolve_mesh`` (one
``vsolve`` of the whole batch over every rank's card).  Its ``Entry(mix,
options)`` builds the program's problem and solver (``problem``, and
``solver``, which counts ``host_syncs``) from the configuration, and its
``call(item)`` makes one call on one input and returns x, r, lam and status
with a leading lane axis, and nfact where the engine counts it.  A module
may also give ``judge(pairs)``, numbers of its own that the run compares
with the module's ``LIMITS`` beside the configuration's checks.  A later
entry is a new file.

``bank`` inputs are drawn in set-up (``configs/<config>.py`` ``draw``) from
the run's seed, or, where the mix gives a ``pool_seed``, from that fixed
seed, with the run's seed choosing the order of the inputs and of the lanes
inside each: then every seed does the same work in another order.  (A
sweep call runs to its slowest lane, and the slowest lanes of fresh draws
moved a call's time by up to 30x: the seed was changing the work.)  On k
cards the lanes move only inside each rank's block of B/k (the program's
``Mesh.block``): every rank solves the same lanes of each input on every
seed, and a call waits for the same slowest rank.  The window takes the
inputs in turn in whole passes (``harness.Run.window``); set-up runs each
once, so that every shape and every graph the window replays is built
before it.  ``slice_calls``: the calls of the traced slice, on the inputs
in the order they were drawn.  Each rank's lanes of such an input are
those of its place in the bank, so the slice replays the rescue's sizes
that set-up ran (the harness checks that it captures no graph).
"""

from __future__ import annotations

import torch

__all__ = ["Mix"]


class Mix:
    """The system under test for one cell: the program's problem and solver
    built from the configuration by the mix's entry, the bank of inputs and
    the call of the mix.  ``control``: the name of one of the
    configuration's ``controls`` (``configs/<config>.json``), run in the
    sound program's place: one that gives ``solver`` options is the program
    with its own lower-precision path switched on; one that gives
    ``reference`` is ``reference.control`` at that precision."""

    def __init__(self, cell, device, seed: int, control: str = None, reference=None):
        from .draws import generator, order

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.traffic, self.traffic_name, self.device = cfg, tr, cell.traffic_name, device
        self.kind = tr["entry"]
        self.module = cell.entry()  # before any draw: an unknown entry fails at once
        self.batch = int(tr.get("batch", 1))
        self.family = cell.family()
        g = generator(seed, device)
        self.shared = self.family.shared_inputs(cfg, g, device)
        pool = tr.get("pool_seed")
        self.drawn = self.family.draw(cfg, g if pool is None else generator(pool, device), int(tr["bank"]),
                                      self.batch, device, self.shared)
        self.bank = self.drawn if pool is None else order(self.drawn, seed, blocks=cell.chips)
        # the traced slice: the first inputs as drawn, the same for every seed of a pool
        self.slice = [self.drawn[k % len(self.drawn)] for k in range(int(tr["slice_calls"]))]
        self.control = None
        options = dict(cfg["solver"])
        if control is not None:
            spec = cfg["controls"][control]
            options.update(spec.get("solver", {}))
            if "reference" in spec:
                self.control = lambda item: reference.control(item, self.shared, spec["reference"])

        self.entry = self.module.Entry(self, options)
        self.problem, self.solver = self.entry.problem, self.entry.solver

    def call(self, item) -> dict:
        """One call of the mix on ``item``: the returned x, r (the method's
        residual variable), lam, status and nfact, each with a leading lane
        axis, and what the entry adds."""
        if self.control is not None:
            out = self.control(item)
            return dict(out, nfact=torch.zeros_like(out["status"]))
        return self.entry.call(item)

    def _own_checks(self) -> bool:
        return self.control is None and hasattr(self.module, "judge")

    def judge(self, pairs) -> dict:
        """The entry's own numbers over ``pairs`` of (input, output): none
        where it has no ``judge``, or where a control stands in the
        program's place."""
        return self.module.judge(pairs) if self._own_checks() else {}

    def limits(self) -> dict:
        """The limits of the numbers of ``judge``."""
        return dict(self.module.LIMITS) if self._own_checks() else {}

    def free(self):
        """Drop the program's problem and solver (its graphs and banks)."""
        self.solver = self.problem = self.entry = None
