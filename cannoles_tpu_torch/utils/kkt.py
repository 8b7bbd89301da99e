"""Independent KKT certificates for a claimed solution.

Port of ``cannoles_tpu/utils/kkt.py``.  Given ``(x, λ)`` it recomputes the
stationarity and feasibility residuals of

    min ½‖F(x)‖²  s.t.  c(x) = 0

from the user's residual and constraint functions alone: the gradient of
the objective by ``torch.func.grad`` and Jcᵀλ by ``torch.func.vjp``.  It
shares no code with the solver's Jacobians or KKT assembly, so a bug in the
solver's dual bookkeeping cannot certify itself.

``x`` is one point (nvar,), as in the JAX package, or a batch (B, nvar);
the residuals are then 0-d or (B,) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import grad, vjp, vmap

from ..problem import NLSProblem

__all__ = ["KKTResiduals", "kkt_residuals", "is_kkt_point"]


class KKTResiduals(NamedTuple):
    stationarity: torch.Tensor  # ‖∇(½‖F‖²)(x) − Jc(x)ᵀλ‖∞
    feasibility: torch.Tensor  # ‖c(x)‖∞
    objective: torch.Tensor  # ½‖F(x)‖²
    scaled_stationarity: torch.Tensor  # stationarity / max(1, ‖λ‖₁/p), the reference's sd


def kkt_residuals(problem: NLSProblem, x, lam=None, data=None) -> KKTResiduals:
    """First-order optimality residuals at ``(x, λ)``, from scratch.

    ``data`` defaults to ``problem.data`` (shared by every point of a
    batch); with a batch of points, ``data`` given here carries the same
    leading batch axis."""
    like = problem.x0
    x = torch.as_tensor(x, device=like.device)
    if not x.is_floating_point():
        x = x.to(like.dtype)
    batched = x.dim() == 2
    xb = x if batched else x[None]
    p = problem.ncon
    lam = xb.new_zeros((xb.shape[0], p)) if lam is None else torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    lamb = lam.reshape(xb.shape[0], p)
    data_dim = 0 if (batched and data is not None) else None
    data = problem.data if data is None else data
    lcon = problem.lcon.to(dtype=x.dtype) if p > 0 else None

    def one(z, lz, d):
        def obj(y):
            Fy = problem.residual(y, d)
            return 0.5 * (Fy * Fy).sum()

        g = grad(obj)(z)
        if p > 0:
            cz, vjp_c = vjp(lambda y: problem.cons(y, d) - lcon, z)
            g = g - vjp_c(lz)[0]
            feas = cz.abs().amax()
            sd = torch.clamp(lz.abs().sum() / p, min=1.0)
        else:
            feas = z.new_zeros(())
            sd = z.new_ones(())
        stat = g.abs().amax() if g.numel() else z.new_zeros(())
        return stat, feas, obj(z), stat / sd

    out = vmap(one, in_dims=(0, 0, data_dim))(xb, lamb, data)
    if not batched:
        out = [t[0] for t in out]
    return KKTResiduals(*out)


def is_kkt_point(problem: NLSProblem, x, lam=None, *, tol=1e-5, data=None):
    """True iff ``(x, λ)`` satisfies the first-order conditions to ``tol``
    (scaled stationarity and feasibility, both ∞-norm); for a batch of
    points, a numpy boolean array with one entry per point."""
    r = kkt_residuals(problem, x, lam, data=data)
    ok = ((r.scaled_stationarity <= tol) & (r.feasibility <= tol)).cpu().numpy()
    return bool(ok) if ok.ndim == 0 else ok
