"""Plain reference of dense_fit, in float64: a Gauss-Newton solve and the
first-order measure that judge a returned x.

Imports torch and the benchmark's own IEEE scope: nothing of the program
and nothing of JAX.  From the family's definition
(``configs/dense_fit.json``):

    F(x) = B1 x + 0.1 sin(B2 x) - y,   J(x) = B1 + 0.1 diag(cos(B2 x)) B2.

The method carries the residual as a variable r beside x; its first-order
measure (the configuration's statement of "solved") is
max(|J(x)^T r|_inf, |F(x) - r|_inf).

The reference takes the inputs the benchmark made (B1, B2, the targets y)
and works out everything else again: its own Gauss-Newton solution from
x0 = 0 (normal equations, Cholesky, float64 on the run's device) and the
stated tolerance at x0.  It reads the program's x and status only to judge
them (x, r and status).
"""

from __future__ import annotations

import torch

from portbench.common.draws import ieee

__all__ = ["judge", "solve", "control", "grad"]

F64 = torch.float64
SOLVED = (1, 2)  # first_order, small_residual


def _mats(shared):
    """B1 and B2 in float64 (converted once per run, kept in ``shared``)."""
    if "B1_f64" not in shared:
        shared["B1_f64"] = shared["B1"].to(F64)
        shared["B2_f64"] = shared["B2"].to(F64)
    return shared["B1_f64"], shared["B2_f64"]


def residual(x, B1, B2, y):
    return B1 @ x + 0.1 * torch.sin(B2 @ x) - y


def grad(x, B1, B2, r):
    """J(x)^T r at x (n,)."""
    return B1.T @ r + 0.1 * (B2.T @ (torch.cos(B2 @ x) * r))


def solve(y, B1, B2, iters: int = 30):
    """The float64 Gauss-Newton solution from x0 = 0: steps until one is
    below 1e-13 of |x|_inf (or ``iters`` steps)."""
    x = torch.zeros(B1.shape[1], dtype=F64, device=B1.device)
    for _ in range(iters):
        z = B2 @ x
        r = B1 @ x + 0.1 * torch.sin(z) - y
        J = B1 + 0.1 * torch.cos(z)[:, None] * B2
        L = torch.linalg.cholesky(J.T @ J)
        step = torch.cholesky_solve((J.T @ r)[:, None], L)[:, 0]
        x = x - step
        if float(step.abs().max()) <= 1e-13 * max(float(x.abs().max()), 1.0):
            break
    return x


def judge(pairs, cfg: dict, shared: dict) -> dict:
    """The numbers compared, over ``pairs`` of (inputs, outputs), each one
    solve: inputs x0 (1, n) and data {B1, B2, y (1, m)}; outputs x (1, n),
    r (1, m) and status (1,).  ``kkt_ratio``: the worst first-order measure
    at (x, r) over atol + rtol |J^T F(x0)|_inf (atol = rtol = sqrt(eps)); ``x_err``: the
    worst |x - x_ref|_inf / |x_ref|_inf; both over the solves that say
    solved (None when none does); ``unsolved_pct``: the solves that do not,
    in percent."""
    sq = torch.finfo(getattr(torch, cfg["dtype"])).eps ** 0.5
    B1, B2 = _mats(shared)
    refs = shared.setdefault("x_ref", {})
    kkt, err, unsolved = None, None, 0
    for inp, out in pairs:
        if int(out["status"][0]) not in SOLVED:
            unsolved += 1
            continue
        y = inp["data"]["y"][0].to(F64)
        key = inp["data"]["y"].data_ptr()
        if key not in refs:
            refs[key] = solve(y, B1, B2)
        x_ref = refs[key]
        x, r = out["x"][0].to(F64), out["r"][0].to(F64)
        x0 = inp["x0"][0].to(F64)
        tol = sq + sq * float(grad(x0, B1, B2, residual(x0, B1, B2, y)).abs().max())
        k = max(float(grad(x, B1, B2, r).abs().max()), float((residual(x, B1, B2, y) - r).abs().max())) / tol
        e = float((x - x_ref).abs().max()) / float(x_ref.abs().max())
        k, e = (float("inf") if v != v else v for v in (k, e))  # NaN reads worst
        kkt = k if kkt is None else max(kkt, k)
        err = e if err is None else max(err, e)
    return {"kkt_ratio": kkt, "x_err": err, "unsolved_pct": 100.0 * unsolved / max(len(pairs), 1)}


def tf32(a):
    """float32 ``a`` rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), as the tensor cores take their operands."""
    i = a.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def control(inp: dict, shared: dict, precision: str, iters: int = 8) -> dict:
    """The control: the reference's Gauss-Newton in float32 with every
    product in TF32 arithmetic (operands rounded to TF32, products and sums
    in float32), the residual's included, in the program's place: x, r =
    F(x) and status first_order, as a solver that believes its arithmetic
    would report it."""
    if precision != "tf32":
        raise ValueError(f"dense_fit's control is TF32, not {precision!r}")
    key = "B_tf32"
    if key not in shared:
        shared[key] = (tf32(shared["B1"]), tf32(shared["B2"]))
    B1, B2 = shared[key]
    y = inp["data"]["y"][0]
    x = torch.zeros(B1.shape[1], dtype=torch.float32, device=B1.device)

    def res(x):
        z = B2 @ tf32(x)
        return B1 @ tf32(x) + 0.1 * torch.sin(z) - y, z

    with ieee():
        for _ in range(iters):
            r, z = res(x)
            J = tf32(shared["B1"] + 0.1 * torch.cos(z)[:, None] * shared["B2"])
            L = torch.linalg.cholesky(J.T @ J)
            x = x - torch.cholesky_solve((J.T @ tf32(r))[:, None], L)[:, 0]
        r, _ = res(x)
    return {"x": x[None], "r": r[None], "status": torch.ones(1, dtype=torch.int32, device=x.device)}

