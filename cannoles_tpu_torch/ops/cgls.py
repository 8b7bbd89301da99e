"""Masked batched CGLS least-squares solver.

PyTorch counterpart of ``cannoles_tpu/ops/cgls.py``, used for the
least-squares multiplier estimate λ = argmin ‖Jcᵀ λ − Jᵀ F‖ (Armand 2012).
Each lane stops on its own (Krylov.jl's rule ‖Bᵀr‖ ≤ atol + rtol·‖Bᵀr₀‖, or
``itmax = n + p`` iterations); a stopped lane keeps its iterate unchanged,
as a lane of JAX's batched ``while_loop`` does.  The loop ends when no lane
is active, or (``check=False``) after ``itmax`` iterations.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cgls"]


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def cgls(
    B: torch.Tensor,
    b: torch.Tensor,
    itmax: Optional[int] = None,
    atol: Optional[float] = None,
    rtol: Optional[float] = None,
    check: bool = True,
) -> torch.Tensor:
    """min_y ‖B y − b‖₂ per lane for B (Bt, n, p), b (Bt, n); returns (Bt, p).
    ``check=False`` runs all ``itmax`` iterations without reading the mask
    on the host (a trip with no active lane changes nothing), so that the
    loop can be captured in a CUDA graph; the result is the same."""
    Bt, n, p = B.shape
    if p == 0:
        return B.new_zeros((Bt, 0))
    if itmax is None:
        itmax = n + p
    eps = float(torch.finfo(B.dtype).eps)
    atol = eps**0.5 if atol is None else atol
    rtol = eps**0.5 if rtol is None else rtol

    BT = B.transpose(-2, -1)
    s0 = _mv(BT, b)
    gamma = (s0 * s0).sum(-1)
    tol = atol + rtol * torch.sqrt(gamma)
    tol2 = tol * tol
    y = torch.zeros_like(s0)
    r = b
    pdir = s0
    zero = torch.zeros_like(gamma)
    one = torch.ones_like(gamma)
    for _ in range(itmax):
        act = gamma > tol2
        if check and not bool(act.any()):
            break
        q = _mv(B, pdir)
        delta = (q * q).sum(-1)
        ok = delta > 0
        alpha = torch.where(ok, gamma / torch.where(ok, delta, one), zero)
        y_n = y + alpha[:, None] * pdir
        r_n = r - alpha[:, None] * q
        s = _mv(BT, r_n)
        gamma_new = (s * s).sum(-1)
        okg = gamma > 0
        beta = torch.where(okg, gamma_new / torch.where(okg, gamma, one), zero)
        p_n = s + beta[:, None] * pdir
        gamma_n = torch.where(ok, gamma_new, zero)
        a1 = act[:, None]
        y = torch.where(a1, y_n, y)
        r = torch.where(a1, r_n, r)
        pdir = torch.where(a1, p_n, pdir)
        gamma = torch.where(act, gamma_n, gamma)
    return y
