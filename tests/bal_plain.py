"""Plain float64 reference of the BAL problem (Snavely's 9-parameter camera
on an observation list), for the tests of ``models/bal.py`` and the Schur
engine's list route.

Imports torch alone: nothing of ``cannoles_tpu_torch`` and nothing of JAX.
Written from the BAL page's model (Agarwal et al., ECCV 2010; Ceres'
``SnavelyReprojectionError``): a camera is (w, t, f, k1, k2),

    P = R(w) X + t,  p = -P_xy / P_z,  u = f (1 + k1 |p|^2 + k2 |p|^4) p,

the residual u - obs, and the 7 gauge constraints (camera 0's w and t
pinned, the squared distance of the centres -R(w)^T t of cameras 0 and 1).
Jacobians by autograd; the first-order measure of the solver's statement;
and its own Gauss-Newton/LM with Schur elimination (index sums, dense S,
Cholesky) from a given start.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

F64 = torch.float64
CAM = 9
SMAX = 100.0  # s_d = max(SMAX, |lambda|_1 / p) / SMAX


def _ieee():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rotate(w, X):
    """R(w) X (Rodrigues; X + w x X for tiny angles)."""
    theta2 = (w * w).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    k = w / theta
    kxX = torch.linalg.cross(k, X, dim=-1)
    full = torch.cos(theta) * X + torch.sin(theta) * kxX + (1 - torch.cos(theta)) * (k * X).sum(-1, keepdim=True) * k
    return torch.where(theta2 < 1e-12, X + torch.linalg.cross(w, X, dim=-1), full)


def project(cam, pt):
    P = rotate(cam[..., :3], pt) + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:]
    r2 = (p * p).sum(-1, keepdim=True)
    return cam[..., 6:7] * (1 + cam[..., 7:8] * r2 + cam[..., 8:9] * r2 * r2) * p


def split(x, C):
    return x[: CAM * C].reshape(C, CAM), x[CAM * C:].reshape(-1, 3)


def residual(x, sc):
    cams, pts = split(x, sc["C"])
    return (project(cams[sc["cam_idx"]], pts[sc["pt_idx"]]) - sc["obs"]).reshape(-1)


def cost(x, sc):
    r = residual(x, sc)
    return 0.5 * float((r * r).sum())


def cons(x, sc):
    cams = x[: 2 * CAM].reshape(2, CAM)
    c = -rotate(-cams[:, :3], cams[:, 3:6])
    return torch.cat([x[:6] - sc["pose0"], ((c[1] - c[0]) ** 2).sum().reshape(1) - sc["base2"]])


def cons_jac(x, sc):
    """(7, n) by autograd."""
    return torch.autograd.functional.jacobian(lambda z: cons(z, sc), x)


def blocks(x, sc):
    """Per-observation blocks by autograd: A (n_obs, 2, 9), Bm (n_obs, 2, 3)."""
    cams, pts = split(x, sc["C"])
    A = vmap(jacfwd(project, argnums=0))(cams[sc["cam_idx"]], pts[sc["pt_idx"]])
    Bm = vmap(jacfwd(project, argnums=1))(cams[sc["cam_idx"]], pts[sc["pt_idx"]])
    return A, Bm


def grad(x, r, sc):
    """J(x)^T r by autograd."""
    _, pull = torch.func.vjp(lambda z: residual(z, sc), x)
    return pull(r)[0]


def dense_jacobian(x, sc):
    """J (m, n), for tiny scenes."""
    return torch.autograd.functional.jacobian(lambda z: residual(z, sc), x)


def lambda_ls(x, sc):
    """argmin |J^T F - Jc^T lambda|_2 at x (1 where it is 0)."""
    g = grad(x, residual(x, sc), sc)
    Jc = cons_jac(x, sc)
    lam = torch.linalg.solve(Jc @ Jc.T, Jc @ g)
    return torch.ones_like(lam) if float(lam.norm()) == 0 else lam


def tolerance(x0, sc, eps: float) -> float:
    """atol + rtol |J^T F(x0) - Jc^T lambda_ls(x0)|_inf, atol = rtol = sqrt(eps)."""
    sq = eps ** 0.5
    g = grad(x0, residual(x0, sc), sc) - cons_jac(x0, sc).T @ lambda_ls(x0, sc)
    return sq + sq * float(g.abs().max())


def measure(x, r, lam, sc) -> float:
    """max(|J^T r - Jc^T lambda|_inf / s_d, |F(x) - r|_inf, |c(x)|_inf)."""
    dual = grad(x, r, sc) - cons_jac(x, sc).T @ lam
    sd = max(float(lam.abs().sum()) / lam.numel(), SMAX) / SMAX
    primal = max(float((residual(x, sc) - r).abs().max()), float(cons(x, sc).abs().max()))
    return max(float(dual.abs().max()) / sd, primal)


def schur_system(x, sc, mu: float):
    """The damped Gauss-Newton system reduced to the cameras: (S (9C, 9C),
    rhs_c, Vinv, W, gp), H = J^T J + mu diag(J^T J), g = J^T F, by index
    sums over the observations and a dense S from each point's k x k
    camera blocks."""
    C, P = sc["C"], sc["P"]
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    r = residual(x, sc).reshape(-1, 2)
    A, Bm = blocks(x, sc)
    U = torch.zeros(C, CAM, CAM, dtype=x.dtype, device=x.device).index_add_(0, ci, A.mT @ A)
    V = torch.zeros(P, 3, 3, dtype=x.dtype, device=x.device).index_add_(0, pi, Bm.mT @ Bm)
    W = A.mT @ Bm
    gc = torch.zeros(C, CAM, dtype=x.dtype, device=x.device).index_add_(0, ci, (A.mT @ r[..., None])[..., 0])
    gp = torch.zeros(P, 3, dtype=x.dtype, device=x.device).index_add_(0, pi, (Bm.mT @ r[..., None])[..., 0])
    U = U + mu * torch.diag_embed(torch.diagonal(U, dim1=-2, dim2=-1))
    V = V + mu * torch.diag_embed(torch.diagonal(V, dim1=-2, dim2=-1))
    Vinv = torch.linalg.inv(V)
    X = W @ Vinv[pi]
    S = torch.zeros(C, C, CAM, CAM, dtype=x.dtype, device=x.device)
    S[torch.arange(C), torch.arange(C)] = U
    # each point's k x k camera blocks: - X_a W_b^T for every pair of its observations
    order = torch.argsort(pi, stable=True)
    k = torch.bincount(pi, minlength=P)
    start = torch.cumsum(k, 0) - k
    for kk in torch.unique(k).tolist():
        pts = torch.nonzero(k == kk)[:, 0]
        for s in range(0, pts.numel(), 4096):
            obs = order[start[pts[s:s + 4096]][:, None] + torch.arange(kk, device=x.device)]  # (n, kk)
            blk = torch.einsum("naij,nbkj->nabik", X[obs], W[obs])
            cam = ci[obs]
            S.index_put_((cam[:, :, None].expand(-1, kk, kk), cam[:, None, :].expand(-1, kk, kk)), -blk,
                         accumulate=True)
    S = S.permute(0, 2, 1, 3).reshape(C * CAM, C * CAM)
    rhs = -gc + torch.zeros_like(gc).index_add_(0, ci, (X @ gp[pi][..., None])[..., 0])
    return S, rhs.reshape(-1), Vinv, W, gp


def lm_step(x, sc, mu: float):
    """The LM step d at x: the damped system with the linearized gauge
    constraints Jc d = -c, the cameras' KKT system solved through the
    Cholesky factor of S + gamma Jc^T Jc (SPD where the constraints fix the
    gauge) and the 7 x 7 system of the multipliers."""
    C = sc["C"]
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    S, rhs, Vinv, W, gp = schur_system(x, sc, mu)
    c = cons(x, sc)
    Jc = cons_jac(x, sc)[:, : CAM * C]
    gamma = float(torch.diagonal(S).mean()) / max(float((Jc * Jc).sum(0).mean()), 1e-300)
    Sg = S + gamma * Jc.T @ Jc
    rhs_g = rhs - gamma * Jc.T @ c
    L = torch.linalg.cholesky(Sg)
    Z = torch.cholesky_solve(torch.cat([rhs_g[:, None], Jc.T], 1), L)
    nu = torch.linalg.solve(Jc @ Z[:, 1:], Jc @ Z[:, 0] + c)
    dc = (Z[:, 0] - Z[:, 1:] @ nu).reshape(C, CAM)
    wtd = torch.zeros_like(gp).index_add_(0, pi, (W.mT @ dc[ci][..., None])[..., 0])
    dp = (Vinv @ (-gp - wtd)[..., None])[..., 0]
    return torch.cat([dc.reshape(-1), dp.reshape(-1)])


def solve(x0, sc, iters: int = 60, mu: float = 1e-6):
    """The reference's LM from x0: a step is taken where it lowers the cost
    (mu /= 10), else mu *= 10; it stops when an accepted step lowers the cost
    by less than 1e-14 of it, or mu passes 1e8.  Returns (x, cost)."""
    _ieee()
    x = x0.clone()
    f = cost(x, sc)
    for _ in range(iters):
        xt = x + lm_step(x, sc, mu)
        ft = cost(xt, sc)
        if ft <= f:
            done = f - ft <= 1e-14 * f
            x, f, mu = xt, ft, max(mu / 10, 1e-12)
            if done:
                break
        else:
            mu *= 10
            if mu > 1e8:
                break
    return x, f


def scene(pb, C: int, P: int, device=None):
    """The reference's view of a port problem's data (for the tests)."""
    d = pb.data
    dev = d["obs"].device if device is None else device
    return {"C": C, "P": P, "cam_idx": d["cam_idx"].to(dev), "pt_idx": d["pt_idx"].to(dev),
            "obs": d["obs"].to(F64).to(dev), "pose0": d["pose0"].to(F64).to(dev),
            "base2": d["base2"].to(F64).to(dev)}
