"""Plain reference of bal_dubrovnik356, in float64: the first-order measure
and the optimum that judge a returned (x, r, lambda), and a plain solver.

Imports torch and the benchmark's own IEEE scope: nothing of the program
and nothing of JAX.  From the family's definition (``configs/
bal_dubrovnik356.json``): a camera is (w, t, f, k1, k2),

    P = R(w) X + t,  p = -P_xy / P_z,  u = f (1 + k1 |p|^2 + k2 |p|^4) p,

the residual u - obs (pixels), and the 7 gauge constraints (camera 0's w and
t pinned, the squared distance of the centres -R(w)^T t of cameras 0 and 1).
Jacobians by autograd.  The method carries the residual as a variable r
beside x and lambda; its first-order measure (the configuration's statement
of "solved") is max(|J^T r - Jc^T lambda|_inf / s_d, |F(x) - r|_inf,
|c(x)|_inf), over the tolerance atol + rtol |J^T F(x0) - Jc^T lambda_ls(x0)|_inf.

The reference takes the inputs the benchmark made (the observation list,
each input's observations and start) and works out everything else again:
its own LM from the same x0 (Schur elimination by index sums, a dense S,
the cameras' KKT system through a Cholesky factor; float64 on the run's
device), the optimum's cost f_ref, and the tolerance at x0.  It reads the
program's x, r, lambda and status only to judge them.  The cost is left
unchanged by the similarity that the constraints fix, so it is compared,
and not x, which the stopping test leaves in its own gauge.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from portbench.common.draws import ieee

__all__ = ["judge", "solve", "control", "measure", "tolerance", "cost"]

F64 = torch.float64
CAM = 9
SMAX = 100.0  # s_d = max(SMAX, |lambda|_1 / p) / SMAX
SOLVED = (1, 2)  # first_order, small_residual
PAIR_ITEMS = 1 << 24  # items of one chunk of S's blocks


def _same(a):
    return a


def tf32(a):
    """float32 ``a`` rounded to TF32's 11 significant bits (Veltkamp's split
    at 2^13 + 1): plain arithmetic, so autograd passes through it."""
    t = a * 8193.0
    return t - (t - a)


def _rotate(w, X, q):
    theta2 = (q(w) * q(w)).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-30)
    k = w / theta
    kq, Xq = q(k), q(X)
    kxX = torch.stack([kq[..., 1] * Xq[..., 2] - kq[..., 2] * Xq[..., 1],
                       kq[..., 2] * Xq[..., 0] - kq[..., 0] * Xq[..., 2],
                       kq[..., 0] * Xq[..., 1] - kq[..., 1] * Xq[..., 0]], -1)
    wq = q(w)
    wxX = torch.stack([wq[..., 1] * Xq[..., 2] - wq[..., 2] * Xq[..., 1],
                       wq[..., 2] * Xq[..., 0] - wq[..., 0] * Xq[..., 2],
                       wq[..., 0] * Xq[..., 1] - wq[..., 1] * Xq[..., 0]], -1)
    c, s = torch.cos(theta), torch.sin(theta)
    kX = (kq * Xq).sum(-1, keepdim=True)
    full = q(c) * Xq + q(s) * q(kxX) + q(1 - c) * q(kX) * kq
    return torch.where(theta2 < 1e-12, X + wxX, full)


def project(cam, pt, q=_same):
    """Snavely's projection; ``q`` rounds each product's operands."""
    P = _rotate(cam[..., :3], pt, q) + cam[..., 3:6]
    p = -P[..., :2] / P[..., 2:]
    pq = q(p)
    r2 = q((pq * pq).sum(-1, keepdim=True))
    poly = 1 + q(cam[..., 7:8]) * r2 + q(cam[..., 8:9]) * q(r2 * r2)
    return q(q(cam[..., 6:7]) * q(poly)) * pq


def _split(x, sc):
    return x[: CAM * sc["C"]].reshape(sc["C"], CAM), x[CAM * sc["C"]:].reshape(sc["P"], 3)


def residual(x, sc, q=_same):
    cams, pts = _split(x, sc)
    return (project(cams[sc["cam_idx"]], pts[sc["pt_idx"]], q) - sc["obs"]).reshape(-1)


def cost(x, sc) -> float:
    r = residual(x, sc)
    return 0.5 * float((r * r).sum())


def cons(x, sc):
    cams = x[: 2 * CAM].reshape(2, CAM)
    c = -_rotate(-cams[:, :3], cams[:, 3:6], _same)
    return torch.cat([x[:6] - sc["pose0"], ((c[1] - c[0]) ** 2).sum().reshape(1) - sc["base2"]])


def cons_jac(x, sc):
    """Jc (7, 9C): the constraints touch only cameras 0 and 1."""
    n = 2 * CAM
    J = torch.autograd.functional.jacobian(lambda z: cons(torch.cat([z, x[n:]]), sc), x[:n])
    return torch.cat([J, J.new_zeros((7, CAM * sc["C"] - n))], 1)


def grad(x, r, sc):
    """J(x)^T r by autograd."""
    _, pull = torch.func.vjp(lambda z: residual(z, sc), x)
    return pull(r)[0]


def tolerance(x0, sc, eps: float) -> float:
    """atol + rtol |J^T F(x0) - Jc^T lambda_ls(x0)|_inf with atol = rtol =
    sqrt(eps); lambda_ls(x0) = argmin |J^T F(x0) - Jc^T lambda|_2 (1 where it
    is 0, as the solver's start)."""
    sq = eps ** 0.5
    g = grad(x0, residual(x0, sc), sc)[: CAM * sc["C"]]
    Jc = cons_jac(x0, sc)
    lam = torch.linalg.solve(Jc @ Jc.T, Jc @ g)
    lam = torch.ones_like(lam) if float(lam.norm()) == 0 else lam
    full = grad(x0, residual(x0, sc), sc)
    full[: CAM * sc["C"]] -= Jc.T @ lam
    return sq + sq * float(full.abs().max())


def measure(x, r, lam, sc) -> float:
    """max(|J^T r - Jc^T lambda|_inf / s_d, |F(x) - r|_inf, |c(x)|_inf)."""
    dual = grad(x, r, sc)
    dual[: CAM * sc["C"]] -= cons_jac(x, sc).T @ lam
    sd = max(float(lam.abs().sum()) / lam.numel(), SMAX) / SMAX
    primal = max(float((residual(x, sc) - r).abs().max()), float(cons(x, sc).abs().max()))
    return max(float(dual.abs().max()) / sd, primal)


def _blocks(x, sc, q):
    """A (n_obs, 2, 9), Bm (n_obs, 2, 3) and r (n_obs, 2) by autograd."""
    cams, pts = _split(x, sc)
    c, p = cams[sc["cam_idx"]], pts[sc["pt_idx"]]

    def one(ci, pi):
        return project(ci, pi, q)

    A = vmap(jacfwd(one, argnums=0))(c, p)
    Bm = vmap(jacfwd(one, argnums=1))(c, p)
    return A, Bm, residual(x, sc, q).reshape(-1, 2)


def _step(x, sc, mu: float, q):
    """The LM step: H = J^T J + mu diag(J^T J) with the linearized gauge
    constraints Jc d = -c; the points eliminated (index sums), the cameras'
    KKT system solved through the Cholesky factor of S + gamma Jc^T Jc (SPD
    where the constraints fix the gauge) and the 7 x 7 system of the
    multipliers.  None where the factor fails."""
    C, P = sc["C"], sc["P"]
    ci, pi = sc["cam_idx"], sc["pt_idx"]
    dt, dev = x.dtype, x.device
    A, Bm, r = _blocks(x, sc, q)
    A, Bm, r = q(A), q(Bm), q(r)
    U = torch.zeros(C, CAM, CAM, dtype=dt, device=dev).index_add_(0, ci, A.mT @ A)
    V = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(0, pi, Bm.mT @ Bm)
    W = q(A.mT @ Bm)
    gc = torch.zeros(C, CAM, dtype=dt, device=dev).index_add_(0, ci, (A.mT @ r[..., None])[..., 0])
    gp = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(0, pi, (Bm.mT @ r[..., None])[..., 0])
    U = U + mu * torch.diag_embed(torch.diagonal(U, dim1=-2, dim2=-1))
    V = V + mu * torch.diag_embed(torch.diagonal(V, dim1=-2, dim2=-1))
    Vinv = q(torch.linalg.inv(V))
    X = q(W @ Vinv[pi])
    S = torch.zeros(C, C, CAM, CAM, dtype=dt, device=dev)
    S[torch.arange(C), torch.arange(C)] = U
    # each point's k x k camera blocks: -X_a W_b^T over every pair of its observations
    order = torch.argsort(pi, stable=True)
    k = torch.bincount(pi, minlength=P)
    start = torch.cumsum(k, 0) - k
    for kk in torch.unique(k).tolist():
        pts = torch.nonzero(k == kk)[:, 0]
        step = max(1, PAIR_ITEMS // (kk * kk * CAM * CAM))
        for s in range(0, pts.numel(), step):
            obs = order[start[pts[s:s + step]][:, None] + torch.arange(kk, device=dev)]
            blk = torch.einsum("naij,nbkj->nabik", X[obs], W[obs])
            cam = ci[obs]
            S.index_put_((cam[:, :, None].expand(-1, kk, kk), cam[:, None, :].expand(-1, kk, kk)), -blk,
                         accumulate=True)
    S = S.permute(0, 2, 1, 3).reshape(C * CAM, C * CAM)
    rhs = (-gc + torch.zeros_like(gc).index_add_(0, ci, (X @ q(gp[pi])[..., None])[..., 0])).reshape(-1)
    c = cons(x, sc).to(dt)
    Jc = cons_jac(x, sc).to(dt)
    gamma = float(torch.diagonal(S).mean()) / max(float((Jc * Jc).sum(0).mean()), 1e-30)
    L, info = torch.linalg.cholesky_ex(S + gamma * Jc.T @ Jc)
    if int(info) != 0:
        return None
    Z = torch.cholesky_solve(torch.cat([(rhs - gamma * Jc.T @ c)[:, None], Jc.T], 1), L)
    nu = torch.linalg.solve(Jc @ Z[:, 1:], Jc @ Z[:, 0] + c)
    dc = (Z[:, 0] - Z[:, 1:] @ nu).reshape(C, CAM)
    wtd = torch.zeros_like(gp).index_add_(0, pi, (W.mT @ q(dc[ci])[..., None])[..., 0])
    dp = (Vinv @ (-gp - wtd)[..., None])[..., 0]
    return torch.cat([dc.reshape(-1), dp.reshape(-1)])


def solve(x0, sc, iters: int = 40, mu: float = 1e-6, q=_same):
    """The reference's LM from x0 in x0's dtype: a step is taken where it
    lowers the cost (mu /= 10), else mu *= 10; it stops when an accepted step
    lowers the cost by less than 1e-12 of it, or mu passes 1e8.  Returns
    (x, its cost in x0's dtype)."""
    def f_of(z):
        rr = residual(z, sc, q)
        return float(0.5 * (rr * rr).sum())

    x, f = x0.clone(), f_of(x0)
    with ieee():
        for _ in range(iters):
            d = _step(x, sc, mu, q)
            if d is None:
                mu *= 10
            else:
                xt = x + d
                ft = f_of(xt)
                if ft <= f:
                    done = f - ft <= 1e-12 * f
                    x, f, mu = xt, ft, max(mu / 10, 1e-12)
                    if done:
                        break
                    continue
                mu *= 10
            if mu > 1e8:
                break
    return x, f


def _scene(shared, inp, dtype=F64):
    """The reference's view of one input: the observation list, the input's
    observations and the gauge's values, in ``dtype``."""
    return {"C": shared["cams"].shape[0], "P": shared["pts"].shape[0], "cam_idx": shared["cam_idx"],
            "pt_idx": shared["pt_idx"], "obs": inp["data"]["obs"][0].to(dtype),
            "pose0": shared["pose0"].to(dtype), "base2": shared["base2"].to(dtype)}


def _reference(inp, cfg, shared):
    """(f_ref, tolerance) of an input, worked out once per input of the
    bank (its number ``set``)."""
    refs = shared.setdefault("bal_ref", {})
    key = int(inp["set"][0])
    if key not in refs:
        sc = _scene(shared, inp)
        x0 = inp["x0"][0].to(F64)
        _, f_ref = solve(x0, sc)
        refs[key] = (f_ref, tolerance(x0, sc, torch.finfo(getattr(torch, cfg["dtype"])).eps))
    return refs[key]


def judge(pairs, cfg: dict, shared: dict) -> dict:
    """The numbers compared, over ``pairs`` of (inputs, outputs), each one
    solve: inputs x0 (1, n), data {obs (1, n_obs, 2)} and ``set``; outputs
    x (1, n), r (1, m), lam (1, 7) and status (1,).  ``kkt_ratio``: the
    worst first-order measure at (x, r, lambda) over the stated tolerance;
    ``cost_gap``: the worst (f(x) - f_ref) / f_ref; both over the solves that
    say solved (None when none does); ``unsolved_pct``: the solves that do
    not, in percent."""
    kkt, gap, unsolved = None, None, 0
    for inp, out in pairs:
        if int(out["status"][0]) not in SOLVED:
            unsolved += 1
            continue
        f_ref, tol = _reference(inp, cfg, shared)
        sc = _scene(shared, inp)
        x, r, lam = out["x"][0].to(F64), out["r"][0].to(F64), out["lam"][0].to(F64)
        k = measure(x, r, lam, sc) / tol
        g = (cost(x, sc) - f_ref) / f_ref
        k, g = (float("inf") if v != v else v for v in (k, g))  # NaN reads worst
        kkt = k if kkt is None else max(kkt, k)
        gap = g if gap is None else max(gap, g)
    return {"kkt_ratio": kkt, "cost_gap": gap, "unsolved_pct": 100.0 * unsolved / max(len(pairs), 1)}


def control(inp: dict, shared: dict, precision: str) -> dict:
    """The control: the reference's LM in float32 with every product's
    operands rounded to TF32 (the residual's too), in the program's place:
    x, r = F(x) and lambda = lambda_ls(x) in that arithmetic and status
    first_order, as a solver that believes its arithmetic would report it."""
    if precision != "tf32":
        raise ValueError(f"bal_dubrovnik356's control is TF32, not {precision!r}")
    sc = _scene(shared, inp, torch.float32)
    x, _ = solve(inp["x0"][0].to(torch.float32), sc, q=tf32)
    r = residual(x, sc, tf32)
    g = grad(x, r, sc)[: CAM * sc["C"]]
    Jc = cons_jac(x, sc)
    lam = torch.linalg.solve(Jc @ Jc.T, Jc @ g)
    return {"x": x[None], "r": r[None], "lam": lam[None], "status": torch.ones(1, dtype=torch.int32, device=x.device)}
