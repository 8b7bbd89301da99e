"""Matrix-free Gauss–Newton solver for very large NLS problems, in PyTorch.

Port of ``cannoles_tpu/core/matfree.py``.  No matrix is formed: every
contraction of the Orban–Siqueira outer algorithm is a jvp/vjp product of
:class:`~cannoles_tpu_torch.problem.NLSProblem`, and the regularized KKT
system is solved by CG on the doubly condensed SPD operator

    (ρ I + JᵀJ + JcᵀJc/δ) zx = bx + Jcᵀ bc/δ,

where a CG that does not converge (singular or indefinite operator at
ρ = 0) reads as a failed factorization and feeds the reference's ρ ladder.
Gauss–Newton and LM only (with ``method='lm'`` the operator gains
clamp(damp)·I, adapted by the Ared/Pred ratio).

The state is batch-native like the dense solver's: every tensor has a
leading batch axis and every loop runs over per-lane masks; a solve is the
case B = 1, which is all the JAX package runs.  CG reads its convergence
test on the host every ``CG_CHECK`` iterations, not every one: the lanes
that have converged stop updating (their ``z`` and iteration count are
frozen), so ``ncg`` and the solution are those of a CG that tests every
iteration, at up to ``CG_CHECK − 1`` wasted products per solve.

``precond='jacobi'`` draws the JAX package's Hutchinson probes bit for bit
(``utils/prng.py``): float64 solvers take JAX's 64-bit draw (its float64
runs need ``jax_enable_x64``), float32 solvers its 32-bit draw.

``MatrixFreeSolver(problem, mesh=row_mesh)`` is the row-sharded run: the
solver holds this rank's row block (``parallel.mesh.row_block``) and
all-reduces every product Jᵀw and every sum and maximum over the residual
axis, as the dense solver does (its ``_rsum``/``_rmax``/``_rany``); CG and
every n- or p-vector stay replicated.  In the JAX package the same run
follows from where the data lies.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..params import F_BLOWUP, MAX_DLAMBDA, Params
from ..problem import NLSProblem
from ..utils.linalg import check_nan_inf, norm_2, norm_inf
from ..utils.precision import matmul_mode, scoped
from ..utils.spans import count_check, span
from ..utils.prng import rademacher
from ..parallel.mesh import row_block
from .solver import CaNNOLeSSolver, RunConfig, _add_batch_axis, _BudgetSpent, _sel
from .status import MSG, ExecutionStats, Status, get_status_code, status_name

__all__ = ["MatrixFreeSolver", "solve_matfree", "MFState", "CG_CHECK"]

# host reads of CG's convergence test: one per CG_CHECK iterations
CG_CHECK = 4


class MFState(NamedTuple):
    """Matrix-free solver state: vectors only, each with a leading batch axis."""

    x: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, p)
    r: torch.Tensor  # (B, m)
    Fx: torch.Tensor  # (B, m)
    cx: torch.Tensor  # (B, p)
    fx: torch.Tensor  # (B,)
    dual: torch.Tensor  # (B, n)
    prim_r: torch.Tensor  # (B, m) = Fx - r
    dx: torch.Tensor  # (B, n)
    dr: torch.Tensor  # (B, m)
    dlam: torch.Tensor  # (B, p)
    normdual: torch.Tensor
    normprimal: torch.Tensor
    rho: torch.Tensor
    rho_old: torch.Tensor
    damp: torch.Tensor  # LM damping (applied to the CG operator when method='lm')
    delta: torch.Tensor
    eta: torch.Tensor
    epsk: torch.Tensor
    alpha: torch.Tensor
    epsF: torch.Tensor
    epstol: torch.Tensor
    epsc: torch.Tensor
    iter: torch.Tensor  # int32
    inner_iter: torch.Tensor  # int32
    neval_F: torch.Tensor  # int32
    neval_c: torch.Tensor  # int32
    nbk: torch.Tensor  # int32
    ncg: torch.Tensor  # int32, total CG iterations
    nfact: torch.Tensor  # int32, solve attempts (ρ-ladder trips)
    nlinsolve: torch.Tensor  # int32
    status: torch.Tensor  # int32
    broken: torch.Tensor  # bool
    msg: torch.Tensor  # int32
    first_order: torch.Tensor  # bool
    small_residual: torch.Tensor  # bool
    data: Any = None


MF_TENSOR_FIELDS = MFState._fields[:-1]


def _sel_state(mask, a, b):
    """Per-field ``_sel`` over two states (or tuples of batched tensors);
    a state keeps ``a.data``, which both sides share."""
    if isinstance(a, MFState):
        return a._replace(**{f: _sel(mask, getattr(a, f), getattr(b, f)) for f in MF_TENSOR_FIELDS})
    return type(a)(*[_sel(mask, x, y) for x, y in zip(a, b)])


def _vdot(a, b):
    return (a * b).sum(-1)


def _cg(matvec: Callable, b, itmax: int, rtol: float, any_fn: Callable, minv=None, active=None):
    """(Preconditioned) CG on an SPD operator, per lane of ``b`` (B, n);
    returns (z, relative residual, iterations), the last two (B,).

    The loop condition is the JAX package's, ``k < itmax``, ‖res‖² > tol²
    and a finite γ, evaluated on the card every iteration; a lane whose
    condition fails stops updating.  ``any_fn(mask, site)`` reads it on the
    host every ``CG_CHECK`` iterations.  Convergence is judged on the true
    residual, with or without ``minv`` (r ↦ M⁻¹r).  A non-positive
    curvature pᵀAp sets γ = inf, so the attempt reads as failed.  Lanes
    outside ``active`` do not iterate."""
    nb = norm_2(b)
    tol2 = (rtol * nb) ** 2
    apply_m = (lambda r: r) if minv is None else minv
    y = apply_m(b)
    z, res, p = torch.zeros_like(b), b, y
    gamma, res2 = _vdot(b, y), _vdot(b, b)
    k = torch.zeros(b.shape[:1], dtype=torch.int32, device=b.device)
    run = torch.ones_like(nb, dtype=torch.bool) if active is None else active
    inf = torch.full_like(gamma, float("inf"))
    for it in range(itmax):
        go = run & (k < itmax) & (res2 > tol2) & torch.isfinite(gamma)
        if it % CG_CHECK == 0 and not any_fn(go, "matfree.cg"):
            break
        q = matvec(p)
        den = _vdot(p, q)
        ok = den > 0
        alpha = torch.where(ok, gamma / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(den))
        z_n = z + alpha[:, None] * p
        res_n = res - alpha[:, None] * q
        y = apply_m(res_n)
        gamma_new = _vdot(res_n, y)
        pos = gamma > 0
        beta = torch.where(pos, gamma_new / torch.where(pos, gamma, torch.ones_like(gamma)),
                           torch.zeros_like(gamma))
        p_n = y + beta[:, None] * p
        z, res, p = _sel(go, z_n, z), _sel(go, res_n, res), _sel(go, p_n, p)
        gamma = torch.where(go, torch.where(ok, gamma_new, inf), gamma)
        res2 = torch.where(go, _vdot(res_n, res_n), res2)
        k = k + go.to(torch.int32)
    denom = torch.where(nb > 0, nb, torch.ones_like(nb))
    relres = torch.sqrt(res2.abs()) / denom
    relres = torch.where(torch.isfinite(gamma), relres, inf)
    return z, relres, k


class _Rho(NamedTuple):
    rho: torch.Tensor
    sol: torch.Tensor
    success: torch.Tensor
    nfact: torch.Tensor
    ncg: torch.Tensor


class _InnerCarry(NamedTuple):
    s: MFState
    ndh: torch.Tensor
    nph: torch.Tensor
    ch: torch.Tensor
    first: torch.Tensor
    tired: torch.Tensor


class MatrixFreeSolver:
    """Gauss–Newton/LM matrix-free solver (one large problem per call).

    Options, as in the JAX package:

    * ``cg_maxiter``: CG budget per attempt (default min(n + p, 500));
    * ``cg_rtol``: CG relative-residual target; a CG that misses it is a
      failed attempt and bumps ρ (default eps^0.45);
    * ``precond``: ``'none'`` (default), ``'jacobi'`` (the diagonal of
      ρ + JᵀJ from ``precond_probes`` Hutchinson probes) or a callable
      ``(problem, x, data, rho, delta) -> (r ↦ M⁻¹r)`` rebuilt at each
      attempt, e.g. :func:`cannoles_tpu_torch.core.ba.ba_block_jacobi`;
    * ``use_initial_multiplier``, ``always_accept_extrapolation``;
    * ``multiplier_refit``: a CGLS multiplier refit after every outer
      iteration, kept where it lowers the dual norm;
    * ``mesh``: a row mesh (see the module docstring); not with a callable
      ``precond``, which would see one rank's rows.

    ``dtype``/``device`` default to those of ``problem.x0``."""

    def __init__(
        self,
        problem: NLSProblem,
        *,
        method: str = "gauss_newton",
        cg_maxiter: Optional[int] = None,
        cg_rtol: Optional[float] = None,
        precond="none",
        precond_probes: int = 8,
        use_initial_multiplier: bool = False,
        always_accept_extrapolation: bool = False,
        multiplier_refit: bool = False,
        params: Optional[Params] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
        mesh=None,
    ):
        if method not in ("gauss_newton", "lm", "Newton_noFHess", "LM"):
            raise ValueError(
                "matrix-free mode is Gauss–Newton/LM only (zero residual-"
                "Hessian block keeps the condensed operator SPD); got "
                f"method={method!r}"
            )
        self.method = "lm" if method in ("lm", "LM") else "gauss_newton"
        self.mesh = mesh
        if mesh is not None:
            if callable(precond):
                raise ValueError("a row-sharded MatrixFreeSolver takes precond='none' or 'jacobi'")
            problem = row_block(problem, mesh)
        self.problem = problem
        self.dtype = problem.x0.dtype if dtype is None else dtype
        if not self.dtype.is_floating_point:
            self.dtype = torch.float64
        self.device = problem.x0.device if device is None else torch.device(device)
        self.params = params or Params.for_dtype(self.dtype)
        n, p = problem.nvar, problem.ncon
        self.cg_maxiter = int(cg_maxiter) if cg_maxiter is not None else min(n + p, 500)
        eps = float(torch.finfo(self.dtype).eps)
        self.cg_rtol = float(cg_rtol) if cg_rtol is not None else eps**0.45
        if not callable(precond) and precond not in ("jacobi", "none"):
            raise ValueError(f"precond must be 'jacobi', 'none' or a callable, got {precond!r}")
        self.precond = precond
        self.precond_probes = int(precond_probes)
        self.use_initial_multiplier = bool(use_initial_multiplier)
        self.always_accept_extrapolation = bool(always_accept_extrapolation)
        self.multiplier_refit = bool(multiplier_refit)
        self.last_state: Optional[MFState] = None
        self.host_syncs = 0
        self._deadline: Optional[float] = None

    def _any(self, mask, site: str) -> bool:
        """One host sync (counted in ``host_syncs`` and, process-wide, at
        ``check:<site>``): whether any lane of ``mask`` is set; inside
        ``solve()`` also the wall-clock budget."""
        self.host_syncs += 1
        with span("cannoles.check", {"segment": site}):
            hit = bool(mask.any())
            count_check(site, hit)
            if self._deadline is not None:
                # on a row mesh every rank leaves the step at the same sync
                hit, spent = self._agree(hit, time.time() > self._deadline)
                if spent:
                    raise _BudgetSpent
        return hit

    _agree = CaNNOLeSSolver._agree
    make_config = CaNNOLeSSolver.make_config
    _dual_scaling = CaNNOLeSSolver._dual_scaling
    _rsum = CaNNOLeSSolver._rsum
    _rmax = CaNNOLeSSolver._rmax
    _rany = CaNNOLeSSolver._rany

    def _matmul_scope(self):
        """IEEE float32 in every product and contraction on the card (the
        JAX package's MatrixFreeSolver has no matmul_precision)."""
        return matmul_mode("highest")

    # ---------------- operator pieces (all matrix-free) ----------------
    def _dual_at(self, x, r, lam, data):
        pb = self.problem
        g = self._rsum(pb.jtprod_res(x, r, data))
        if pb.ncon > 0:
            g = g - pb.jtprod_cons(x, lam, data)
        return g

    def _lam_cgls(self, x, b, data, itmax, active=None):
        """λ = argmin ‖Jc(x)ᵀ λ − b‖: CG on Jc Jcᵀ λ = Jc b."""
        pb = self.problem

        def matvec(v):
            return pb.jprod_cons(x, pb.jtprod_cons(x, v, data), data)

        rhs = pb.jprod_cons(x, b, data)
        lam, _, _ = _cg(matvec, rhs, itmax, self.cg_rtol, self._any, active=active)
        return lam

    def _jacobi_minv(self, resvec, rho, like):
        """Diagonal preconditioner for the smooth block ρ + JᵀJ: the
        diagonal from Hutchinson probes (mean of z ∘ JᵀJz over the JAX
        package's Rademacher z), floored positive.  The constraint term
        stays out of M (see the JAX package's reasoning)."""
        n = like.shape[-1]
        bits = 64 if like.dtype == torch.float64 else 32
        Z = torch.as_tensor(rademacher(0, (self.precond_probes, n), bits), dtype=like.dtype,
                            device=like.device)
        est = torch.stack([z * resvec(z.expand_as(like)) for z in Z]).mean(0)
        floor = 1e-10 * torch.clamp(est.amax(-1), min=1.0)
        d = torch.maximum(est, floor[:, None]) + rho[:, None]
        return lambda r: r / d

    def _rhs(self, s: MFState):
        pb = self.problem
        bx = s.dual + self._rsum(pb.jtprod_res(s.x, s.prim_r, s.data))
        if pb.ncon > 0:
            bx = bx + pb.jtprod_cons(s.x, s.cx, s.data) / s.delta[:, None]
        return bx

    def _solve_condensed(self, s: MFState, rho, active=None):
        """One (P)CG attempt on ((ρ + λ_LM) I + JᵀJ + JcᵀJc/δ) zx = bx at
        the current iterate; returns (zx, converged, CG iterations).
        λ_LM = clamp(damp) for method='lm', zero for Gauss–Newton."""
        pb = self.problem
        x, data = s.x, s.data
        if self.method == "lm":
            rho = rho + torch.clamp(s.damp, 1e-10, 1e8)

        # Jᵀ(Jv): the pullback is built once per attempt, not per product
        pull = pb.res_pullback(x, data)

        def resvec(v):
            return self._rsum(pull(pb.jprod_res(x, v, data)))

        def matvec(v):
            out = rho[:, None] * v + resvec(v)
            if pb.ncon > 0:
                out = out + pb.jtprod_cons(x, pb.jprod_cons(x, v, data), data) / s.delta[:, None]
            return out

        bx = self._rhs(s)
        if callable(self.precond):
            minv = self.precond(pb, x, data, rho, s.delta)
        elif self.precond == "jacobi":
            minv = self._jacobi_minv(resvec, rho, bx)
        else:
            minv = None
        zx, relres, k = _cg(matvec, bx, self.cg_maxiter, self.cg_rtol, self._any, minv=minv,
                            active=active)
        return zx, (relres <= self.cg_rtol) & torch.isfinite(zx).all(-1), k

    def _ladder_start(self, rho_old):
        pr = self.params
        first_rho = torch.where(
            rho_old == 0,
            torch.full_like(rho_old, pr.rho0),
            torch.maximum(torch.full_like(rho_old, pr.rho_min), pr.kappa_dec * rho_old),
        )
        inc = torch.where(
            rho_old == 0,
            torch.full_like(rho_old, pr.kappa_large_inc),
            torch.full_like(rho_old, pr.kappa_inc),
        )
        return first_rho, inc

    def _newton_system(self, s: MFState, act):
        """The reference ρ schedule, "CG converged" standing in for
        "factorization succeeded with the right inertia".  Returns
        (sol, success, rho, rho_old_new, nfact, ncg)."""
        return self._ladder(s, act, lambda rho, do: self._solve_condensed(s, rho, do), 0)

    def _ladder(self, s: MFState, act, attempt, k_shift: int):
        """ρ = 0 first (rung ``k_shift`` onward), then rho0 or
        max(rho_min, κdec·rho_old), escalated by κlargeinc/κinc until an
        attempt succeeds or ρ > rho_max; ``nfact`` counts the attempts made
        with ρ ≤ rho_max and ``ncg`` their CG iterations."""
        pr = self.params
        rho_old = s.rho_old
        B, n = s.x.shape
        first_rho, inc = self._ladder_start(rho_old)
        i32 = dict(dtype=torch.int32, device=s.x.device)
        zero = torch.zeros_like(rho_old)
        c = _Rho(zero, s.x.new_zeros((B, n)), torch.zeros_like(act),
                 torch.zeros((B,), **i32), torch.zeros((B,), **i32))
        k = 0
        while True:
            go = act if k == 0 else act & (~c.success) & (c.rho <= pr.rho_max)
            if not self._any(go, "matfree.ladder"):
                break
            keff = k + k_shift
            rho = zero if keff == 0 else (first_rho if keff == 1 else c.rho * inc)
            do = go & (rho <= pr.rho_max)
            if self._any(do, "matfree.attempt"):
                sol_t, suc_t, kcg = attempt(rho, do)
            else:
                sol_t, suc_t, kcg = c.sol, torch.zeros_like(do), torch.zeros((B,), **i32)
            new = _Rho(rho, _sel(do, sol_t, c.sol), do & suc_t, c.nfact + do.to(torch.int32),
                       c.ncg + torch.where(do, kcg, torch.zeros_like(kcg)))
            c = _sel_state(go, new, c)
            k += 1
        rho_old_new = torch.where(
            c.rho == 0, rho_old, torch.where(c.rho <= pr.rho_max, c.rho, rho_old)
        )
        return c.sol, c.success, c.rho, rho_old_new, c.nfact, c.ncg

    def _merit(self, Fx, cx, lam, eta):
        val = 0.5 * self._rsum(_vdot(Fx, Fx))
        if self.problem.ncon > 0:
            val = val - _vdot(lam, cx) + 0.5 * eta * _vdot(cx, cx)
        return val

    # ---------------- init ----------------
    def _init_state(self, x0, lam0, cfg: RunConfig, data=None) -> MFState:
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        x = x0.to(dtype=self.dtype, device=self.device)
        lam = lam0.to(dtype=self.dtype, device=self.device)
        B = x.shape[0]
        i32 = dict(dtype=torch.int32, device=x.device)

        Fx = pb.F(x, data)
        broken = self._rany(check_nan_inf(Fx))
        fx = 0.5 * self._rsum(_vdot(Fx, Fx))
        cx = pb.c_shifted(x, data)
        r = Fx
        Jxtr = self._rsum(pb.jtprod_res(x, r, data))
        if p > 0 and not self.use_initial_multiplier:
            lam_ls = self._lam_cgls(x, Jxtr, data, itmax=min(n + p, 200))
            lam = _sel(norm_2(lam_ls) == 0, torch.ones_like(lam_ls), lam_ls)
        dual = Jxtr - pb.jtprod_cons(x, lam, data) if p > 0 else Jxtr
        prim_r = Fx - r
        normdual = norm_inf(dual)
        normprimal = torch.maximum(self._rmax(norm_inf(prim_r)), norm_inf(cx))

        epsF = cfg.Fatol + cfg.Frtol * 2 * torch.sqrt(fx)
        epstol = cfg.atol + cfg.rtol * normdual
        epsc = torch.sqrt(epstol)
        small_residual = (2 * torch.sqrt(fx) <= epsF) & (norm_2(cx) <= epsc)
        first_order = torch.maximum(normdual / self._dual_scaling(lam), normprimal) <= epstol

        def full(v):
            return torch.full((B,), v, dtype=self.dtype, device=x.device)

        s = MFState(
            x=x, lam=lam, r=r, Fx=Fx, cx=cx, fx=fx, dual=dual, prim_r=prim_r,
            dx=x.new_zeros((B, n)), dr=x.new_zeros((B, m)), dlam=x.new_zeros((B, p)),
            normdual=normdual, normprimal=normprimal,
            rho=full(0.0), rho_old=full(0.0), damp=full(1.0), delta=full(1.0),
            eta=full(1.0 if p > 0 else 0.0), epsk=full(1e3), alpha=full(0.0),
            epsF=epsF, epstol=epstol, epsc=epsc,
            iter=torch.zeros((B,), **i32), inner_iter=torch.zeros((B,), **i32),
            neval_F=torch.ones((B,), **i32),
            neval_c=torch.full((B,), 1 if p > 0 else 0, **i32),
            nbk=torch.zeros((B,), **i32), ncg=torch.zeros((B,), **i32),
            nfact=torch.zeros((B,), **i32), nlinsolve=torch.zeros((B,), **i32),
            status=torch.zeros((B,), **i32), broken=broken, msg=torch.zeros((B,), **i32),
            first_order=first_order, small_residual=small_residual, data=data,
        )
        status = get_status_code(
            optimal=s.first_order, small_residual=s.small_residual, broken=s.broken,
            evals=s.neval_F + s.neval_c, max_eval=cfg.max_eval,
        )
        return s._replace(status=status)

    # ---------------- one outer iteration on the lanes of ``active`` ----------------
    def _solve_system(self, s: MFState, act) -> MFState:
        pb, pr = self.problem, self.params
        zx, success, rho, rho_old, nfacti, ncgi = self._newton_system(s, act)
        dx = -zx
        # recover the eliminated blocks: dr = prim_r + J dx, dλ = (bc − Jc zx)/δ
        dr = s.prim_r + pb.jprod_res(s.x, dx, s.data)
        if pb.ncon > 0:
            dlam = -(pb.jprod_cons(s.x, zx, s.data) - s.cx) / s.delta[:, None]
        else:
            dlam = s.dlam
        bad = check_nan_inf(dx)
        blowup = s.fx >= min(F_BLOWUP, float(torch.finfo(self.dtype).max))
        over = rho > pr.rho_max
        broken = over | (~success) | bad | blowup
        msg = torch.zeros_like(s.msg)
        for cond, code in ((blowup, 4), (bad, 3), (~success, 2), (over, 1)):
            msg = torch.where(cond, torch.full_like(msg, code), msg)
        return s._replace(
            dx=dx, dr=dr, dlam=dlam, rho=rho, rho_old=rho_old,
            nfact=s.nfact + nfacti, ncg=s.ncg + ncgi, nlinsolve=s.nlinsolve + 1,
            broken=s.broken | broken, msg=torch.where(s.msg == 0, msg, s.msg),
        )

    def _trial_step(self, s: MFState, act):
        pb, pr = self.problem, self.params
        p = pb.ncon
        data = s.data
        is_extrap = s.inner_iter == 0
        dx, dr = s.dx, s.dr
        epsk = torch.where(
            is_extrap,
            torch.maximum(torch.minimum(1e3 * s.delta, 0.99 * s.epsk), 0.9 * s.epsk),
            s.epsk,
        )
        eta_ls = 1.0 / s.delta if p > 0 else s.eta
        JxtFx = self._rsum(pb.jtprod_res(s.x, s.Fx, data))
        Dphi = _vdot(JxtFx, dx)
        if p > 0:
            w = s.lam - s.cx / s.delta[:, None]
            Dphi = Dphi - _vdot(dx, pb.jtprod_cons(s.x, w, data))
        not_descent = (Dphi >= 0) & (~is_extrap)
        phix = self._merit(s.Fx, s.cx, s.lam, eta_ls)
        eps2 = float(torch.finfo(self.dtype).eps) ** 2

        xt = s.x + dx
        Ft = pb.F(xt, data)
        ct = pb.c_shifted(xt, data)
        phit = self._merit(Ft, ct, s.lam, eta_ls)
        alpha = torch.ones_like(s.delta)
        nbk = torch.zeros_like(s.nbk)
        fail = torch.zeros_like(s.broken)
        ls_lanes = act & (~not_descent) & (~is_extrap)
        while True:
            go = ls_lanes & (~fail) & (phit > phix + pr.gamma_A * alpha * Dphi)
            if not self._any(go, "matfree.ls"):
                break
            alpha_n = alpha / 4
            xt_n = s.x + alpha_n[:, None] * dx
            Ft_n = pb.F(xt_n, data)
            ct_n = pb.c_shifted(xt_n, data)
            alpha = torch.where(go, alpha_n, alpha)
            xt, Ft, ct = _sel(go, xt_n, xt), _sel(go, Ft_n, Ft), _sel(go, ct_n, ct)
            phit = torch.where(go, self._merit(Ft_n, ct_n, s.lam, eta_ls), phit)
            nbk = nbk + go.to(torch.int32)
            fail = torch.where(go, alpha_n < eps2, fail)

        ndl = norm_2(s.dlam)
        scale = MAX_DLAMBDA / torch.where(ndl > 0, ndl, torch.ones_like(ndl))
        dlam = _sel(is_extrap & (ndl > MAX_DLAMBDA), s.dlam * scale[:, None], s.dlam)
        rt = _sel(is_extrap, s.r + dr, Ft)
        if p > 0:
            lamt = _sel(is_extrap, s.lam + dlam, s.lam - s.cx / s.delta[:, None])
        else:
            lamt = s.lam
        alpha_out = torch.where(is_extrap, torch.zeros_like(alpha), alpha)
        eta = torch.where(is_extrap, s.eta, eta_ls)
        nF_add = 1 + nbk
        nc_add = (1 + nbk) if p > 0 else torch.zeros_like(nbk)
        ls_broken = not_descent | fail
        ls_msg = torch.where(
            not_descent, torch.full_like(s.msg, 5),
            torch.where(fail, torch.full_like(s.msg, 6), torch.zeros_like(s.msg)),
        )
        return xt, rt, lamt, Ft, ct, alpha_out, eta, epsk, dlam, nbk, nF_add, nc_add, ls_broken, ls_msg

    def _inner_ok(self, c: _InnerCarry, combined, cfg: RunConfig, act) -> _InnerCarry:
        pb, pr = self.problem, self.params
        p = pb.ncon
        s = c.s
        data = s.data
        (xt, rt, lamt, Ft, ct, alpha, eta, epsk, dlam,
         nbk_add, nF_add, nc_add, ls_broken, ls_msg) = self._trial_step(s, act)

        damp = s.damp
        if self.method == "lm":
            # the Ared/Pred ratio steers the applied Levenberg damping
            nF2 = self._rsum(_vdot(s.Fx, s.Fx))
            Ared = nF2 - self._rsum(_vdot(Ft, Ft))
            step_a = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
            pred_vec = s.Fx + step_a[:, None] * pb.jprod_res(s.x, s.dx, data)
            Pred = nF2 - self._rsum(_vdot(pred_vec, pred_vec))
            ratio = Ared / Pred
            damp = torch.where(ratio > 0.75, damp / 10, torch.where(ratio < 0.25, damp * 10, damp))

        prim_r_hat = Ft - rt
        dual_hat = self._dual_at(xt, rt, lamt, data)
        ndh = norm_inf(dual_hat)
        nph = torch.maximum(self._rmax(norm_inf(prim_r_hat)), norm_inf(ct))
        ch = ndh + nph
        good = (ch <= 0.99 * combined + epsk) & (~ls_broken)
        accept = ((s.inner_iter > 0) | self.always_accept_extrapolation | good) & (~ls_broken)

        x_n = _sel(accept, xt, s.x)
        r_n = _sel(accept, rt, s.r)
        dual_n = _sel(good, dual_hat, self._dual_at(x_n, r_n, s.lam, data))
        delta_n = s.delta
        if p > 0:
            dec = (
                (s.inner_iter > 0)
                & (ndh <= 0.99 * s.normdual + epsk / 2)
                & (nph > 0.99 * s.normprimal + epsk / 2)
            )
            delta_n = torch.where(dec, torch.clamp(s.delta / 10, min=pr.delta_min), s.delta)
        inner_n = s.inner_iter + 1
        neF = s.neval_F + nF_add
        nec = s.neval_c + nc_add
        tired = ((neF + nec) > cfg.max_eval) | (inner_n > cfg.max_inner)
        s_n = s._replace(
            x=x_n, r=r_n, Fx=_sel(accept, Ft, s.Fx),
            fx=torch.where(accept, 0.5 * self._rsum(_vdot(Ft, Ft)), s.fx), cx=_sel(accept, ct, s.cx),
            lam=_sel(good, lamt, s.lam), dual=dual_n,
            prim_r=_sel(accept, prim_r_hat, s.prim_r),
            dlam=dlam, eta=eta, epsk=epsk, alpha=alpha, damp=damp, delta=delta_n,
            inner_iter=inner_n, neval_F=neF, neval_c=nec, nbk=s.nbk + nbk_add,
            broken=s.broken | ls_broken, msg=torch.where(s.msg == 0, ls_msg, s.msg),
        )
        return _InnerCarry(s_n, ndh, nph, ch, torch.zeros_like(c.first), tired)

    def _outer_step(self, s: MFState, cfg: RunConfig, active) -> MFState:
        """One outer iteration for the lanes of ``active``; the others keep
        their state."""
        pb, pr = self.problem, self.params
        n, p = pb.nvar, pb.ncon
        data = s.data
        s_in = s
        combined = s.normdual + s.normprimal
        delta0 = torch.clamp(torch.minimum(cfg.delta_dec * s.delta, combined), min=pr.delta_min)
        s = s._replace(delta=delta0, damp=torch.ones_like(s.damp),
                       inner_iter=torch.zeros_like(s.inner_iter))

        c = _InnerCarry(s, s.normdual, s.normprimal, torch.full_like(s.fx, float("inf")),
                        torch.ones_like(s.broken), (s.neval_F + s.neval_c) > cfg.max_eval)
        while True:
            conv = (c.ch <= 0.99 * combined + c.s.epsk) | c.tired
            go = active & (c.first | ~conv) & (~c.s.broken)
            if not self._any(go, "matfree.inner"):
                break
            s = c.s
            # skip the solve right after a failed extrapolation (the
            # inner_iter == 1 quirk of the reference)
            do_solve = go & ((s.inner_iter != 1) | self.always_accept_extrapolation)
            if self._any(do_solve, "matfree.solve"):
                s = _sel_state(do_solve, self._solve_system(s, do_solve), s)
            ok = go & (~s.broken)
            c_broken = _InnerCarry(s, c.ndh, c.nph, c.ch, torch.zeros_like(c.first), c.tired)
            c_new = (self._inner_ok(c._replace(s=s), combined, cfg, ok) if self._any(ok, "matfree.ok")
                     else c_broken)
            c_new = _InnerCarry(_sel_state(ok, c_new.s, s),
                                *[_sel(ok, a, b) for a, b in zip(c_new[1:], c_broken[1:])])
            c = _InnerCarry(_sel_state(go, c_new.s, c.s),
                            *[_sel(go, a, b) for a, b in zip(c_new[1:], c[1:])])
        s = c.s._replace(normdual=c.ndh, normprimal=c.nph)

        if self.multiplier_refit and p > 0:
            # the JAX engine keeps the refit wherever it lowers the dual norm
            lam_fit = self._lam_cgls(s.x, self._rsum(pb.jtprod_res(s.x, s.r, data)), data,
                                     itmax=min(n + p, 200), active=active)
            dual_fit = self._dual_at(s.x, s.r, lam_fit, data)
            nd_fit = norm_inf(dual_fit)
            take = nd_fit < s.normdual
            s = s._replace(lam=_sel(take, lam_fit, s.lam), dual=_sel(take, dual_fit, s.dual),
                           normdual=torch.where(take, nd_fit, s.normdual))

        first_order = torch.maximum(s.normdual / self._dual_scaling(s.lam), s.normprimal) <= s.epstol
        small_residual = (2 * torch.sqrt(s.fx) <= s.epsF) & (norm_2(s.cx) <= s.epsc)
        s = s._replace(first_order=first_order, small_residual=small_residual)
        recheck = active & small_residual & ~first_order
        if self._any(recheck, "matfree.recheck"):
            # small-residual optimality re-check, with operators
            r = s.Fx
            Jxtr = self._rsum(pb.jtprod_res(s.x, r, data))
            if p > 0:
                lam = self._lam_cgls(s.x, Jxtr, data, itmax=min(n + p, 200), active=recheck)
                dual = Jxtr - pb.jtprod_cons(s.x, lam, data)
            else:
                lam, dual = s.lam, Jxtr
            nd = norm_inf(dual)
            npr = norm_inf(s.cx)
            fo = torch.maximum(nd / self._dual_scaling(lam), npr) <= s.epstol
            s = _sel_state(recheck, s._replace(r=r, lam=lam, dual=dual, prim_r=s.Fx - r,
                                               normdual=nd, normprimal=npr, first_order=fo), s)

        iter_n = s.iter + 1
        status = get_status_code(
            optimal=s.first_order, small_residual=s.small_residual, broken=s.broken,
            evals=s.neval_F + s.neval_c, max_eval=cfg.max_eval,
            iter_=iter_n, max_iter=cfg.max_iter,
            stalled=(s.inner_iter > cfg.max_inner) & (cfg.max_inner >= 0),
        )
        s = s._replace(iter=iter_n, status=status)
        return _sel_state(active, s, s_in)

    # ---------------- host-driven solve ----------------
    @scoped
    def solve(
        self,
        x0=None,
        lam0=None,
        *,
        callback: Optional[Callable] = None,
        max_time: float = 300.0,
        verbose: int = 0,
        resume_from: Optional[MFState] = None,
        data=None,
        **numeric,
    ) -> ExecutionStats:
        """One instance (B = 1), one outer step per host iteration.
        ``data``: the instance's data in place of ``problem.data`` (the same
        structure, no batch axis).
        ``resume_from``: a state (B = 1) to continue; its tolerances are
        kept unless ``atol``/``rtol``/``Fatol``/``Frtol`` are given, which
        re-target the run from the current iterate.  ``max_time`` is read
        between outer steps and, after the first, at every host sync inside
        one (an interrupted step is dropped)."""
        pb = self.problem
        pb.validate_for_solve()
        t0 = time.time()
        cfg = self.make_config(**numeric)
        stats = ExecutionStats()
        stats.status = "unknown"
        if resume_from is not None:
            state = resume_from._replace(status=torch.zeros_like(resume_from.status))
            if {"atol", "rtol", "Fatol", "Frtol"} & numeric.keys():
                epstol = cfg.atol + cfg.rtol * state.normdual
                epsF = cfg.Fatol + cfg.Frtol * 2 * torch.sqrt(state.fx)
                state = state._replace(epstol=epstol, epsF=epsF, epsc=torch.sqrt(epstol))
        else:
            x0 = pb.x0 if x0 is None else x0
            lam0 = pb.y0 if lam0 is None else lam0
            x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device).reshape(1, -1)
            lam0 = torch.as_tensor(lam0, dtype=self.dtype, device=self.device).reshape(1, -1)
            state = self._init_state(x0, lam0, cfg, _add_batch_axis(pb.data if data is None else data, self.device))
        self._sync(state, stats, time.time() - t0)
        self._callback(callback, state, stats)
        try:
            while stats.status == "unknown":
                try:
                    state = self._outer_step(state, cfg, state.status == Status.UNKNOWN)
                except _BudgetSpent:
                    stats.status = status_name(Status.MAX_TIME)
                    stats.elapsed_time = time.time() - t0
                    break
                elapsed = time.time() - t0
                self._sync(state, stats, elapsed)
                # on a row mesh the ranks stop together (``_agree``)
                if self._agree(stats.status == "unknown" and elapsed > max_time)[0]:
                    stats.status = status_name(Status.MAX_TIME)
                if verbose > 0 and stats.iter % max(verbose, 1) == 0:
                    print(
                        f"iter={stats.iter:4d} f={stats.objective:.6e} "
                        f"‖∇L‖={stats.dual_feas:.2e} ‖c‖={stats.primal_feas:.2e} "
                        f"cg_iters={int(state.ncg[0])}"
                    )
                self._callback(callback, state, stats)
                self._deadline = t0 + max_time
        finally:
            self._deadline = None
        stats.solver_specific.update(
            nbk=int(state.nbk[0]), nfact=int(state.nfact[0]), ncg=int(state.ncg[0]),
            nlinsolve=int(state.nlinsolve[0]), internal_msg=MSG[int(state.msg[0])],
            neval_residual=int(state.neval_F[0]), neval_cons=int(state.neval_c[0]),
        )
        self.last_state = state
        pb.counters.neval_residual += int(state.neval_F[0])
        pb.counters.neval_cons += int(state.neval_c[0])
        return stats

    def _callback(self, callback, s: MFState, stats: ExecutionStats):
        """The callback's turn; a 'user' stop on one rank of a row mesh
        stops every rank."""
        if callback is not None:
            callback(self.problem, s, stats)
        if self._agree(stats.status == "user")[0]:
            stats.status = "user"

    def _sync(self, s: MFState, stats: ExecutionStats, elapsed: float):
        if stats.status != "user":
            stats.status = status_name(int(s.status[0]))
        stats.iter = int(s.iter[0])
        stats.elapsed_time = elapsed
        stats.objective = float(s.fx[0])
        stats.dual_feas = float(s.normdual[0])
        stats.primal_feas = float(norm_2(s.cx)[0])
        stats.solution = s.x[0].cpu().numpy()
        stats.multipliers = s.lam[0].cpu().numpy()


def solve_matfree(
    problem: NLSProblem,
    *,
    x=None,
    lam=None,
    method: str = "gauss_newton",
    cg_maxiter: Optional[int] = None,
    cg_rtol: Optional[float] = None,
    precond="none",
    callback=None,
    max_time: float = 300.0,
    verbose: int = 0,
    **numeric,
) -> ExecutionStats:
    """Solve one (typically very large) equality-constrained NLS problem
    with the matrix-free Gauss–Newton engine: no Jacobian is formed.  Same
    stopping rules, schedules and stats as :func:`cannoles`."""
    solver = MatrixFreeSolver(problem, method=method, cg_maxiter=cg_maxiter, cg_rtol=cg_rtol,
                              precond=precond)
    return solver.solve(x0=x, lam0=lam, callback=callback, max_time=max_time, verbose=verbose,
                        **numeric)
