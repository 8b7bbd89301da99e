"""rosen_con: the constrained Rosenbrock family for the program under test.

F = (x0 - d0, 10 (x1 - x0^2) - d1), c = x0 + x1 - d2 = 0, one data vector d
per instance (``rosen_con.json``).  The residual and constraint are frozen
here (the same as ``lm_bench_family``'s at commit 1ca66b2), and handed to
the program's ``nls_problem`` as a user of the package would.
"""

from __future__ import annotations

import torch

from portbench.common import draws


def problem(cfg: dict, device, shared=None):
    from cannoles_tpu_torch import nls_problem

    dtype = getattr(torch, cfg["dtype"])

    def residual(x, d):
        return torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return torch.stack([x[0] + x[1] - d[2]])

    return nls_problem(
        residual,
        torch.tensor([-1.2, 1.0], dtype=dtype, device=device),
        cfg["nequ"],
        cons,
        [0.0],
        [0.0],
        data=torch.zeros((3,), dtype=dtype, device=device),
        name="portbench_rosen_con",
        device=device,
    )


def draw(cfg: dict, g: torch.Generator, count: int, batch: int, device, shared=None):
    """``count`` inputs of ``batch`` instances each: dicts with x0 (batch, 2)
    and data (batch, 3)."""
    dtype = getattr(torch, cfg["dtype"])
    x0, d = draws.rosen_batch(g, count * batch, dtype, device)
    return [dict(x0=x0[k * batch:(k + 1) * batch], data=d[k * batch:(k + 1) * batch])
            for k in range(count)]


def shared_inputs(cfg: dict, g: torch.Generator, device):
    """The inputs that every solve of a run shares: none in this family."""
    return None
