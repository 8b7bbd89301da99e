"""dense_fit: the large dense curve fit for the program under test.

F(x) = B1 x + 0.1 sin(B2 x) - y, unconstrained, x0 = 0 (``dense_fit.json``).
The residual is frozen here (the same as ``large_rung_problem``'s at commit
1ca66b2) and handed to the program's ``nls_problem``.  B1 and B2 are made
once per run from the seed and shared by every solve; each solve takes the
next target y_k of a bank made in set-up.
"""

from __future__ import annotations

import torch

from portbench.common import draws


def shared_inputs(cfg: dict, g: torch.Generator, device):
    """B1 and B2, made on the device from the seed."""
    dtype = getattr(torch, cfg["dtype"])
    B1, B2 = draws.dense_matrices(g, cfg["nequ"], cfg["nvar"], dtype, device)
    return {"B1": B1, "B2": B2}


def problem(cfg: dict, device, shared):
    from cannoles_tpu_torch import nls_problem

    dtype = getattr(torch, cfg["dtype"])

    def residual(x, d):
        return d["B1"] @ x + 0.1 * torch.sin(d["B2"] @ x) - d["y"]

    data = {"B1": shared["B1"], "B2": shared["B2"],
            "y": torch.zeros(cfg["nequ"], dtype=dtype, device=device)}
    return nls_problem(
        residual,
        torch.zeros(cfg["nvar"], dtype=dtype, device=device),
        cfg["nequ"],
        data=data,
        name="portbench_dense_fit",
        device=device,
    )


def draw(cfg: dict, g: torch.Generator, count: int, batch: int, device, shared=None):
    """``count`` inputs of one solve each (``batch`` must be 1): dicts with
    x0 (1, n) = 0 and data {B1 (1, m, n), B2 (1, m, n), y (1, m)}, the
    matrices shared (views), one target each."""
    if batch != 1:
        raise ValueError("dense_fit solves one problem at a time (batch 1)")
    Y, _ = draws.dense_targets(g, shared["B1"], shared["B2"], count)
    x0 = torch.zeros((1, cfg["nvar"]), dtype=Y.dtype, device=device)
    return [dict(x0=x0, data={"B1": shared["B1"][None], "B2": shared["B2"][None], "y": Y[k][None]})
            for k in range(count)]
