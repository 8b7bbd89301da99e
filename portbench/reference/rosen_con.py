"""Plain reference of rosen_con, in float64: the first-order measure that
judges a returned (x, lambda), and a plain solver.

Imports torch alone: nothing of the program and nothing of JAX.  The
residual, constraint and derivatives are written out by hand from the
family's definition (``configs/rosen_con.json``):

    F = (x0 - d0, 10 (x1 - x0^2) - d1),   J = [[1, 0], [-20 x0, 10]],
    c = x0 + x1 - d2,                      Jc = [1, 1].

The method carries the residual as a variable r beside x and lambda; its
first-order measure (the configuration's statement of "solved") is
max(|J(x)^T r - Jc^T lambda|_inf / s_d, |F(x) - r|_inf, |c(x)|_inf).
``judge`` reads the program's x, r, lambda and status only to judge them.
``solve`` is the plain solver that stands in the program's place for the
control: on the constraint x1 = d2 - x0 the problem is one-dimensional,
min_t phi(t) = 1/2 ((t - d0)^2 + (10 (d2 - t - t^2) - d1)^2), solved by
Newton's method (a Gauss-Newton step where phi'' is not positive), every
operation in the dtype asked for.
"""

from __future__ import annotations

import torch

__all__ = ["judge", "solve", "control", "grad", "measure", "tolerance"]

F64 = torch.float64
SMAX = 100.0  # s_d = max(SMAX, |lambda|_1 / p) / SMAX, the statement of first order
SOLVED = (1, 2)  # first_order, small_residual


def _split(x):
    return x[..., 0], x[..., 1]


def residual(x, d):
    x0, x1 = _split(x)
    return torch.stack([x0 - d[..., 0], 10 * (x1 - x0 ** 2) - d[..., 1]], -1)


def grad(x, d, r=None):
    """J(x)^T r, (B, 2); r defaults to F(x)."""
    F = residual(x, d) if r is None else r
    return torch.stack([F[..., 0] - 20 * x[..., 0] * F[..., 1], 10 * F[..., 1]], -1)


def cons(x, d):
    return x[..., 0] + x[..., 1] - d[..., 2]


def _lambda_ls(g):
    """The least-squares multiplier of Jc^T lambda = g (Jc = [1, 1]); 1
    where it is 0, as the solver's start."""
    lam = 0.5 * (g[..., 0] + g[..., 1])
    return torch.where(lam == 0, torch.ones_like(lam), lam)


def tolerance(x0, d, eps: float):
    """The stated tolerances at the start: (epstol, epsF, epsc) with
    atol = rtol = Fatol = sqrt(eps), Frtol = eps; epsF multiplies
    2 sqrt(f) = sqrt(2) |F|, f = |F|^2 / 2, as the small-residual test."""
    sq = eps ** 0.5
    g0 = grad(x0, d)
    dual0 = g0 - _lambda_ls(g0)[..., None]
    epstol = sq + sq * dual0.abs().amax(-1)
    F0 = residual(x0, d)
    epsF = sq + eps * 2 ** 0.5 * torch.linalg.vector_norm(F0, dim=-1)
    return epstol, epsF, epstol.sqrt()


def measure(x, r, lam, d):
    """max(|J^T r - Jc^T lambda|_inf / s_d, |F - r|_inf, |c|_inf) at
    (x, r, lambda); lambda (B,)."""
    dual = grad(x, d, r) - lam[..., None]
    sd = torch.clamp(lam.abs(), min=SMAX) / SMAX
    primal = torch.maximum((residual(x, d) - r).abs().amax(-1), cons(x, d).abs())
    return torch.maximum(dual.abs().amax(-1) / sd, primal)


def lane_ratios(x0, d, x, r, lam, status, eps: float):
    """Per lane, the first-order measure over its stated tolerance; for a
    lane that says small_residual, the smaller of that and the
    small-residual test's own ratio (sqrt(2) |F| over epsF, |c| over epsc)."""
    epstol, epsF, epsc = tolerance(x0, d, eps)
    fo = measure(x, r, lam, d) / epstol
    sr = torch.maximum(2 ** 0.5 * torch.linalg.vector_norm(residual(x, d), dim=-1) / epsF, cons(x, d).abs() / epsc)
    return torch.where(status == 2, torch.minimum(fo, sr), fo)


def judge(pairs, cfg: dict, shared=None) -> dict:
    """The numbers compared, over ``pairs`` of (inputs, outputs): inputs
    x0 (B, 2) and data (B, 3); outputs x (B, 2), r (B, 2), lam (B, 1),
    status (B,).
    ``kkt_ratio``: the worst ratio over the lanes that say solved (None when
    none does); ``unsolved_pct``: the lanes that do not, in percent."""
    eps = torch.finfo(getattr(torch, cfg["dtype"])).eps
    if not pairs:
        return {"kkt_ratio": None, "unsolved_pct": 100.0}

    def cat(side, key):
        return torch.cat([p[side][key] for p in pairs]).to(F64)

    status = torch.cat([out["status"] for _, out in pairs]).to(torch.int64)
    solved = (status == SOLVED[0]) | (status == SOLVED[1])
    unsolved_pct = 100.0 * int((~solved).sum()) / status.numel()
    if not bool(solved.any()):
        return {"kkt_ratio": None, "unsolved_pct": unsolved_pct}
    ratio = lane_ratios(cat(0, "x0"), cat(0, "data"), cat(1, "x"), cat(1, "r"), cat(1, "lam")[..., 0], status,
                        eps)[solved]
    # a NaN in a lane that says solved is the worst reading of all
    worst = float("inf") if bool(torch.isnan(ratio).any()) else float(ratio.max())
    return {"kkt_ratio": worst, "unsolved_pct": unsolved_pct}


def solve(inp: dict, dtype=F64, iters: int = 60) -> dict:
    """The plain solver in ``dtype``: x (B, 2), r = F(x) (B, 2), lam (B, 1)
    and status (B,),
    status first_order (1) for every lane, as a solver that believes its
    arithmetic would report it."""
    d = inp["data"].to(dtype)
    t = inp["x0"][..., 0].to(dtype)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    one = torch.ones_like(t)
    for _ in range(iters):
        F0 = t - d0
        F1 = 10 * (d2 - t - t * t) - d1
        dF1 = -10 * (one + 2 * t)
        g = F0 + F1 * dF1
        gn = one + dF1 * dF1
        h = gn - 20 * F1
        step = torch.where(h > 0.5 * gn, -g / h, -g / gn)
        t = t + torch.clamp(step, -1.0, 1.0)
    x = torch.stack([t, d2 - t], -1)
    g = grad(x, d)
    lam = 0.5 * (g[..., 0] + g[..., 1])
    return {"x": x, "r": residual(x, d), "lam": lam[..., None],
            "status": torch.ones_like(t, dtype=torch.int32)}


def control(inp: dict, shared, precision: str) -> dict:
    """The control: the plain solver in the program's place, in
    ``precision`` (a torch dtype's name)."""
    return solve(inp, dtype=getattr(torch, precision))
