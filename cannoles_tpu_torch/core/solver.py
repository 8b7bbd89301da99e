"""Constrained nonlinear least-squares solver, batch-native, in PyTorch.

Port of ``cannoles_tpu/core/solver.py`` (the Orban–Siqueira regularization
method of CaNNOLeS.jl).  The JAX package vmaps a scalar state machine built
from ``lax.while_loop``s; ``torch.func.vmap`` cannot batch a loop whose trip
count depends on the data, so here the state machine is written batched:

* every state tensor has a leading batch axis B; a single solve is B = 1;
* every ``while_loop`` is a Python loop over a per-lane ``active`` mask,
  which is the parent loop's mask AND the loop's own condition.  Updates go
  through ``torch.where``, and the loop ends when no lane is active (one
  host sync, counted in ``CaNNOLeSSolver.host_syncs``);
* a lane that is not active keeps its state bit for bit, which is what a
  lane of JAX's batched ``while_loop`` does, so each lane follows the
  trajectory it would follow alone.

``linsolve='chol'`` is the two-level Cholesky of the condensed system:
``torch.linalg.cholesky`` below ``pallas_chol_min`` (the counterpart of
XLA's cholesky) and the blocked Cholesky kernels of ``ops/block_chol.py`` at
or above it.

``linsolve='cpp'`` is the host C++ LDLᵀ of ``ops/cpp_ldlt.py`` (a host
round trip per attempt, as the JAX package's ``pure_callback``).

``mesh=`` (a row mesh, ``parallel/mesh.py``) makes the solver hold one
rank's block of the residual rows: every sum and maximum over the residual
axis goes through ``_rsum``/``_rmax``/``_rany``, which all-reduce over the
mesh (the identity without one), where the JAX package lets GSPMD insert
the all-reduces.  x, λ, the condensed system and every n- or p-vector stay
replicated, bit for bit equal on every rank, so every host decision agrees.

``matmul_precision`` (None | 'highest' | 'float32' | 'bfloat16' |
'tensorfloat32') sets the precision of the solve's float32 matmuls on the
card, scoped to ``solve()``/``run()`` by ``utils.precision.matmul_mode``:
IEEE float32 for the first three, TF32 for 'tensorfloat32', and for
'bfloat16' a one-pass bf16 JᵀJ condensation with float32 accumulation (the
other unpinned matmuls in TF32).  The factorization attempts and the
quality-gate residual stay IEEE under every mode, as the JAX package pins
them to ``precision='highest'``; on the CPU every matmul is IEEE under every
mode, and only the gate's tolerance follows the mode (``_gate_eps``).

The XLA/TPU seams ``_scalar_mode``, ``_reuse_trial_linearization`` and
``_descent_rescue_eigh`` are not ported.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.block_chol import block_cho_solve, block_cholesky, block_forward_solve
from ..ops.cgls import cgls
from ..ops.cpp_ldlt import cpp_ldlt_factor_solve
from ..ops.fused_ldlt import fused_ldlt_solve
from ..ops.ldlt import eigh_factor, eigh_solve, inertia_success, ldlt_factor, ldlt_solve
from ..parallel.mesh import row_block
from ..params import F_BLOWUP, MAX_DLAMBDA, SMAX, Params
from ..problem import NLSProblem
from ..utils.linalg import check_nan_inf, norm_1, norm_2, norm_inf
from ..utils.precision import check_mode, critical_matmul, gate_eps, matmul_mode, scoped
from .status import MSG, ExecutionStats, Status, get_status_code, status_name

__all__ = [
    "CaNNOLeSSolver",
    "cannoles",
    "SolverState",
    "RunConfig",
    "AVAILABLE_METHODS",
    "AVAILABLE_LINSOLVE",
    "resolve_auto",
]

AVAILABLE_METHODS = ("newton", "lm", "gauss_newton", "newton_vanishing")
_METHOD_ALIASES = {
    "Newton": "newton",
    "LM": "lm",
    "Newton_noFHess": "gauss_newton",
    "newton_nofhess": "gauss_newton",
    "Newton_vanishing": "newton_vanishing",
}
AVAILABLE_LINSOLVE = ("ldlt", "eigh", "pallas", "cpp", "chol")
_LINSOLVE_ALIASES = {"ldlfactorizations": "ldlt", "ma57": "eigh", "pallas_ldl": "pallas"}


def _check_available_method(method: str) -> str:
    method = _METHOD_ALIASES.get(method, method)
    if method not in AVAILABLE_METHODS:
        opts = ", ".join(f"`{m}`" for m in AVAILABLE_METHODS)
        raise ValueError(f"`method` must be one of these: {opts}")
    return method


def resolve_auto(problem, method: str, linsolve: str, kkt: str):
    """Resolve 'auto' linsolve/kkt as the JAX package does: the condensed
    (n+p)² form when m ≥ 4(n+p) and n+m+p ≥ 64; 'chol' on a condensed
    Gauss–Newton/LM system, else 'ldlt' with the in-loop eigh retry.
    Returns ``(linsolve, kkt, robust_fallback)``."""
    method = _check_available_method(method)
    n, m, p = problem.nvar, problem.nequ, problem.ncon
    if kkt == "auto":
        kkt = "condensed" if (m >= 4 * (n + p) and n + m + p >= 64) else "full"
    auto = linsolve == "auto"
    if auto:
        if kkt == "condensed" and method in ("gauss_newton", "lm"):
            linsolve = "chol"
        else:
            linsolve = "ldlt"
    return linsolve, kkt, auto


class RunConfig(NamedTuple):
    """Numeric knobs, as 0-d tensors in the solver's dtype (int32 budgets)."""

    atol: torch.Tensor
    rtol: torch.Tensor
    Fatol: torch.Tensor
    Frtol: torch.Tensor
    delta_dec: torch.Tensor
    max_eval: torch.Tensor
    max_inner: torch.Tensor
    max_iter: torch.Tensor  # -1 = unlimited


class SolverState(NamedTuple):
    """The full solver state; every tensor has a leading batch axis B."""

    x: torch.Tensor  # (B, n)
    lam: torch.Tensor  # (B, p)
    r: torch.Tensor  # (B, m)
    Fx: torch.Tensor  # (B, m)
    cx: torch.Tensor  # (B, p)
    fx: torch.Tensor  # (B,) ½‖F‖²
    JxT: torch.Tensor  # (B, n, m)
    Jcx: torch.Tensor  # (B, p, n)
    dual: torch.Tensor  # (B, n)
    primal: torch.Tensor  # (B, m+p)
    d: torch.Tensor  # (B, n+m+p) current Newton step
    dlam: torch.Tensor  # (B, p)
    normdual: torch.Tensor
    normprimal: torch.Tensor
    rho: torch.Tensor
    rho_old: torch.Tensor
    delta: torch.Tensor
    eta: torch.Tensor
    epsk: torch.Tensor
    alpha: torch.Tensor
    damp: torch.Tensor
    epsF: torch.Tensor
    epstol: torch.Tensor
    epsc: torch.Tensor
    iter: torch.Tensor  # int32
    inner_iter: torch.Tensor  # int32
    neval_F: torch.Tensor  # int32
    neval_c: torch.Tensor  # int32
    nbk: torch.Tensor  # int32
    nfact: torch.Tensor  # int32
    nlinsolve: torch.Tensor  # int32
    status: torch.Tensor  # int32
    broken: torch.Tensor  # bool
    msg: torch.Tensor  # int32
    first_order: torch.Tensor  # bool
    small_residual: torch.Tensor  # bool
    # problem-family data: None or a pytree whose leaves have the batch axis
    data: Any = None


TENSOR_FIELDS = SolverState._fields[:-1]


def _sel(mask, a, b):
    """torch.where over a leading batch axis: a where mask, else b."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _sel_tuple(mask, a, b):
    """Per-field _sel over two NamedTuples of batched tensors; a
    SolverState keeps ``a.data``, which the two sides share."""
    if isinstance(a, SolverState):
        return a._replace(**{f: _sel(mask, getattr(a, f), getattr(b, f)) for f in TENSOR_FIELDS})
    return type(a)(*[_sel(mask, x, y) for x, y in zip(a, b)])


def _mv(A, v):
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _vdot(a, b):
    return (a * b).sum(-1)


def _cholesky_nan(A):
    """Batched lower Cholesky factor, NaN on the lanes where it fails (what
    XLA's cholesky returns), with no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))


def _cho_solve(L, b):
    """Solve (L Lᵀ) x = b for a batch of vectors b (B, k)."""
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


class _InnerCarry(NamedTuple):
    s: SolverState
    normdualhat: torch.Tensor
    normprimalhat: torch.Tensor
    combined_hat: torch.Tensor
    first: torch.Tensor
    tired: torch.Tensor


class _Rho(NamedTuple):
    rho: torch.Tensor
    sol: torch.Tensor
    success: torch.Tensor
    nfact: torch.Tensor


class _BudgetSpent(Exception):
    """``solve()``'s wall-clock budget ran out at a host sync."""


class CaNNOLeSSolver:
    """Solver for one problem structure (CaNNOLeSSolver analog): build once,
    solve many batches with different starts, data and tolerances.

    ``dtype``/``device`` default to those of ``problem.x0``; every tensor
    the solver makes lives there.  With a row ``mesh`` (condensed KKT only)
    ``problem`` is the whole problem and ``self.problem`` this rank's row
    block of it (``parallel.mesh.row_block``), on ``mesh.device``."""

    def __init__(
        self,
        problem: NLSProblem,
        *,
        method: str = "newton",
        linsolve: str = "ldlt",
        use_initial_multiplier: bool = False,
        always_accept_extrapolation: bool = False,
        lm_damping: bool = False,
        multiplier_refit: bool = False,
        block_size: int = 32,
        kkt: str = "full",
        params: Optional[Params] = None,
        delta_min: Optional[float] = None,
        quality_gate: Optional[bool] = None,
        robust_fallback: bool = False,
        descent_rescue: bool = True,
        matmul_precision: Optional[str] = None,
        pallas_chol_min: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
        mesh=None,
    ):
        self.method = _check_available_method(method)
        linsolve = _LINSOLVE_ALIASES.get(linsolve, linsolve)
        if linsolve not in AVAILABLE_LINSOLVE:
            raise ValueError(f"Can't handle linsolve={linsolve!r}")
        if kkt not in ("full", "condensed"):
            raise ValueError(f"kkt must be 'full' or 'condensed', got {kkt!r}")
        if linsolve == "chol" and kkt != "condensed":
            raise ValueError(
                "linsolve='chol' requires kkt='condensed' (the full KKT system "
                "is indefinite in the residual block)"
            )
        self.linsolve = linsolve
        self.kkt = kkt
        self._dims = (problem.nvar, problem.nequ, problem.ncon)  # the whole problem's
        self.mesh = mesh
        if mesh is not None:
            if kkt != "condensed":
                raise ValueError("row-sharded solve requires the condensed KKT backend")
            problem = row_block(problem, mesh)
        self.problem = problem
        self.use_initial_multiplier = bool(use_initial_multiplier)
        self.always_accept_extrapolation = bool(always_accept_extrapolation)
        # per-column LM scaling of the KKT's top-left block (method='lm')
        self.lm_damping = bool(lm_damping)
        # per-outer CGLS multiplier refit, kept where it lowers the dual norm
        self.multiplier_refit = bool(multiplier_refit)
        # accepted so that the JAX package's calls carry over; the port's
        # ldlt has no panels and its fused kernel no lane blocks, so no
        # backend reads it
        self.block_size = int(block_size)
        # linsolve='chol': n at or above which the blocked Cholesky kernels
        # factor the n×n block instead of torch.linalg.cholesky.  Off by
        # default, as in the JAX package (a TPU measurement; the card's
        # times are in PERF.md)
        self.pallas_chol_min = (1 << 31) if pallas_chol_min is None else int(pallas_chol_min)
        # backward-error gate: default on where fixed-order elimination has
        # room to misjudge inertia (the JAX package measured breakdown at N=21)
        N = problem.nvar + problem.nequ + problem.ncon
        if kkt == "condensed":
            N = problem.nvar + problem.ncon
        self.quality_gate = (N >= 16) if quality_gate is None else bool(quality_gate)
        self.robust_fallback = bool(robust_fallback) and linsolve != "eigh"
        self.descent_rescue = bool(descent_rescue) and linsolve != "eigh"
        self.dtype = problem.x0.dtype if dtype is None else dtype
        if not self.dtype.is_floating_point:
            self.dtype = torch.float64
        self.device = problem.x0.device if device is None else torch.device(device)
        if params is None:
            overrides = {} if delta_min is None else {"delta_min": float(delta_min)}
            params = Params.for_dtype(self.dtype, **overrides)
        self.params = params
        self.matmul_precision = check_mode(matmul_precision)
        # the gate's tolerance scales with the committed arithmetic's unit
        # roundoff; its residual is always IEEE (_solve_quality_ok)
        self._gate_eps = gate_eps(matmul_precision, self.dtype)
        if self.method in ("newton", "newton_vanishing") and not problem.has_residual_hessian:
            raise NotImplementedError(
                f"problem '{problem.name}' provides no residual Hessian; "
                "use method='gauss_newton' (reference :Newton_noFHess)"
            )
        self.last_state: Optional[SolverState] = None
        # host syncs (mask.any() reads) since construction
        self.host_syncs = 0
        # solve()'s wall-clock deadline (time.time()), read at every host sync
        self._deadline: Optional[float] = None

    def _any(self, mask) -> bool:
        self.host_syncs += 1
        hit = bool(mask.any())
        if self._deadline is not None:
            # on a row mesh every rank leaves the step at the same sync
            hit, spent = self._agree(hit, time.time() > self._deadline)
            if spent:
                raise _BudgetSpent
        return hit

    def _agree(self, *flags: bool):
        """Host decisions that the ranks of a row mesh take together: each
        flag comes back true on every rank where it is true on any (as given
        without a mesh).  For what each rank reads on its own clock or from
        its own callback; the replicated state needs no agreement."""
        if self.mesh is None:
            return flags
        return tuple(self.mesh.any(torch.tensor(flags, device=self.mesh.device)).tolist())

    # reductions over the residual axis: over every rank's rows on a row
    # mesh, the identity without one (the argument is a fresh tensor)
    def _rsum(self, t):
        return t if self.mesh is None else self.mesh.sum(t)

    def _rmax(self, t):
        return t if self.mesh is None else self.mesh.max(t)

    def _rany(self, t):
        return t if self.mesh is None else self.mesh.any(t)

    def _matmul_scope(self):
        """The solve's matmul precision (``run``, ``solve`` and whoever else
        drives the solver's steps)."""
        return matmul_mode(self.matmul_precision)

    def _pinned(self):
        """IEEE float32 for the contractions that the JAX package pins to
        'highest', where the solve's scope is not IEEE already."""
        if self.matmul_precision in ("tensorfloat32", "bfloat16"):
            return matmul_mode("highest")
        return contextlib.nullcontext()

    def reset(self, problem: Optional[NLSProblem] = None) -> "CaNNOLeSSolver":
        """Re-solve support (the reference's SolverCore.reset!): with no
        argument a no-op (re-solving from a new x0 needs no reset); with a
        problem of identical dimensions, a solver with the same options,
        dtype and device wired to the new problem."""
        if problem is None:
            return self
        if (problem.nvar, problem.nequ, problem.ncon) != self._dims:
            raise ValueError("reset requires a problem with identical dimensions")
        return self._rebuilt(problem, self.mesh)

    def _rebuilt(self, problem: NLSProblem, mesh) -> "CaNNOLeSSolver":
        """A solver with the same options and dtype on ``problem`` and
        ``mesh`` (on ``mesh.device`` when there is one)."""
        return CaNNOLeSSolver(
            problem,
            method=self.method,
            linsolve=self.linsolve,
            use_initial_multiplier=self.use_initial_multiplier,
            always_accept_extrapolation=self.always_accept_extrapolation,
            lm_damping=self.lm_damping,
            multiplier_refit=self.multiplier_refit,
            block_size=self.block_size,
            kkt=self.kkt,
            params=self.params,
            quality_gate=self.quality_gate,
            robust_fallback=self.robust_fallback,
            descent_rescue=self.descent_rescue,
            matmul_precision=self.matmul_precision,
            pallas_chol_min=self.pallas_chol_min,
            dtype=self.dtype,
            device=self.device if mesh is None else None,
            mesh=mesh,
        )

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------
    def _H_block(self, x, lam, r, Fx, JxT, damp, data):
        """Top-left KKT block: the method's residual Hessian minus the
        constraint curvature term, plus (LM with ``lm_damping``) the
        per-column scaling clamp(damp)·‖J[:, j]‖²."""
        pb = self.problem
        n = pb.nvar
        if self.method in ("newton", "newton_vanishing"):
            Hres = self._rsum(pb.hess_res(x, r, data))
            if self.method == "newton_vanishing":
                Hres = _sel(self._rsum(_vdot(Fx, Fx)) > 1e-8, Hres, torch.zeros_like(Hres))
        else:
            Hres = x.new_zeros((x.shape[0], n, n))
        if pb.ncon > 0:
            Hres = Hres - pb.hess_cons(x, lam, data)
        if self.method == "lm" and self.lm_damping:
            scale = torch.clamp(damp, 1e-10, 1e8)
            Hres = Hres + torch.diag_embed(scale[:, None] * self._rsum((JxT * JxT).sum(-1)))
        return Hres

    def _assemble_kkt(self, H, JxT, Jcx, delta):
        """Dense symmetric KKT  W = [H Jᵀ Jcᵀ; J -I 0; Jc 0 -δI], (B, N, N)."""
        pb = self.problem
        m, p = pb.nequ, pb.ncon
        B = H.shape[0]
        Jx = JxT.transpose(-2, -1)
        Im = (-torch.eye(m, dtype=H.dtype, device=H.device)).expand(B, m, m)
        if p == 0:
            return torch.cat([torch.cat([H, JxT], 2), torch.cat([Jx, Im], 2)], 1)
        Zmp = H.new_zeros((B, m, p))
        Ip = -delta[:, None, None] * torch.eye(p, dtype=H.dtype, device=H.device)
        return torch.cat(
            [
                torch.cat([H, JxT, Jcx.transpose(-2, -1)], 2),
                torch.cat([Jx, Im, Zmp], 2),
                torch.cat([Jcx, Zmp.transpose(-2, -1), Ip], 2),
            ],
            1,
        )

    def _assemble_condensed(self, H, JxT, Jcx, delta):
        """Schur-condensed KKT  K = [H + JᵀJ  Jcᵀ; Jc  -δI], (B, n+p, n+p):
        the residual block is eliminated through its -I block, which keeps
        the inertia decisions.  JᵀJ is a batched matmul at the mode's
        precision for it (``critical_matmul``)."""
        p = self.problem.ncon
        M = H + self._rsum(critical_matmul(JxT, JxT.transpose(-2, -1), self.matmul_precision))
        if p == 0:
            return M
        Ip = -delta[:, None, None] * torch.eye(p, dtype=H.dtype, device=H.device)
        return torch.cat(
            [torch.cat([M, Jcx.transpose(-2, -1)], 2), torch.cat([Jcx, Ip], 2)], 1
        )

    def _solve_quality_ok(self, W, sol, rhs):
        """Backward-error gate on a factorization attempt:
        ‖W·sol − rhs‖∞ ≤ N·eps^(3/4)·(‖rhs‖∞ + max|W|·‖sol‖₁), per lane,
        with ``eps`` the committed arithmetic's (``_gate_eps``) and the
        residual in IEEE under every mode."""
        N = W.shape[-1]
        tol = self._gate_eps**0.75 * N
        res = self._gate_residual(W, sol, rhs)
        scale = norm_inf(rhs) + W.abs().flatten(1).amax(-1) * norm_1(sol)
        return norm_inf(res) <= tol * (scale + 1e-30)

    def _gate_residual(self, W, sol, rhs):
        """rhs − W·sol in IEEE under every mode."""
        with self._pinned():
            return rhs - _mv(W, sol)

    def _attempt(self, W, rhs):
        sol, success = self._attempt_raw(W, rhs)
        if self.quality_gate:
            success = success & self._solve_quality_ok(W, sol, rhs)
        return sol, success

    def _attempt_raw(self, W, rhs):
        """One factorization attempt per lane: (solution of W sol = rhs,
        inertia-success flag), in IEEE under every mode."""
        with self._pinned():
            return self._attempt_backend(W, rhs)

    def _attempt_backend(self, W, rhs):
        pr = self.params
        n = self.problem.nvar
        if self.linsolve == "pallas":
            sol, d = fused_ldlt_solve(W, rhs, pr.eig_tol)
            return sol, inertia_success(d, sol, n, pr.eig_tol)
        if self.linsolve == "eigh":
            fac = eigh_factor(W, pr.eig_tol)
            return eigh_solve(fac, rhs, pr.eig_tol), inertia_success(fac.vec, fac.mat, n, pr.eig_tol)
        if self.linsolve == "cpp":
            return cpp_ldlt_factor_solve(W, rhs, n, pr.eig_tol)
        if self.linsolve == "chol":
            return self._attempt_chol(W, rhs)
        fac = ldlt_factor(W, pr.eig_tol)
        success = inertia_success(fac.vec, fac.mat, n, pr.eig_tol)
        return ldlt_solve(fac, rhs, pr.eig_tol), success

    def _attempt_chol(self, W, rhs):
        """Two-level Cholesky on the condensed quasi-definite system
        K = [M Jcᵀ; Jc −δI]: In(K) = (n, p, 0) ⟺ M ≻ 0, so success is the
        Cholesky of M finite with every pivot above eig_tol, the Schur block
        S = δI + Zᵀ Z (Z = L⁻¹Jcᵀ) factored, and the solution finite.  The
        n×n factor takes ``torch.linalg.cholesky`` below ``pallas_chol_min``
        (NaN where it fails, as XLA's) and the blocked Cholesky kernels at
        or above it (nb = 256, as the JAX package hardcodes)."""
        eig_tol = self.params.eig_tol
        n, p = self.problem.nvar, self.problem.ncon
        M = W[:, :n, :n]
        bx = rhs[:, :n]
        if n >= self.pallas_chol_min:
            facM = block_cholesky(M, eig_tol, nb=256)
            okM = facM.ok

            def M_solve(b):
                return block_cho_solve(facM, b)

            def M_fwd(b):
                return block_forward_solve(facM, b)
        else:
            Lm = _cholesky_nan(M)
            dlm = torch.diagonal(Lm, dim1=-2, dim2=-1)
            okM = torch.isfinite(Lm).flatten(1).all(-1) & (dlm * dlm > eig_tol).all(-1)

            def M_solve(b):
                return _cho_solve(Lm, b)

            def M_fwd(b):
                return torch.linalg.solve_triangular(Lm, b, upper=False)
        if p == 0:
            sol = M_solve(bx)
            return sol, okM & torch.isfinite(sol).all(-1)
        Jc = W[:, n:, :n]
        delta = -W[:, n, n]  # the (2,2) block is -δI (rho touches only the x-diagonal)
        bc = rhs[:, n:]
        Z = M_fwd(Jc.mT)  # L Z = Jcᵀ: (B, n, p), zero rows where L is padded
        S = delta[:, None, None] * torch.eye(p, dtype=W.dtype, device=W.device) + Z.mT @ Z
        Ls = _cholesky_nan(S)
        okS = torch.isfinite(Ls).flatten(1).all(-1)
        zl = _cho_solve(Ls, _mv(Jc, M_solve(bx)) - bc)
        zx = M_solve(bx - _mv(Jc.mT, zl))
        sol = torch.cat([zx, zl], -1)
        return sol, okM & okS & torch.isfinite(sol).all(-1)

    def _rho_ladder(self, attempt, rhs, rho_old, active):
        """The reference's exact rho schedule around one factorization seam:
        try rho=0; on inertia failure rho ← rho0 (first time) or
        max(rho_min, κdec·rho_old); escalate by κlargeinc/κinc until success
        or rho > rho_max.  ``nfact`` counts the attempts made with
        rho ≤ rho_max.  Lanes outside ``active`` make no attempt; when no
        lane is active the ladder costs no trip."""
        pr = self.params
        B = rhs.shape[0]
        zero = rhs.new_zeros((B,))
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
        c = _Rho(zero, torch.zeros_like(rhs), torch.zeros_like(active),
                 torch.zeros((B,), dtype=torch.int32, device=rhs.device))
        k = 0
        while True:
            go = active if k == 0 else active & (~c.success) & (c.rho <= pr.rho_max)
            if not self._any(go):
                return c
            rho = zero if k == 0 else (first_rho if k == 1 else c.rho * inc)
            do = rho <= pr.rho_max
            sol_t, suc_t = attempt(rho)
            new = _Rho(rho, _sel(do, sol_t, c.sol), do & suc_t, c.nfact + do.to(torch.int32))
            c = _sel_tuple(go, new, c)
            k += 1

    def _newton_system(self, W0, rhs, rho_old, active, bad_direction=None):
        """Inertia-corrected factorize-and-solve: the rho ladder around the
        primary backend, plus (robust_fallback) an exact-inertia eigh ladder
        for lanes that needed regularization, plus (descent_rescue, gate
        off) a gated ladder for lanes whose successful step is not a descent
        direction.  Returns (step, success, rho, rho_old_new, nfact)."""
        pr = self.params
        n = self.problem.nvar
        idx = torch.arange(n, device=W0.device)

        def shifted(rho):
            W = W0.clone()
            W[:, idx, idx] = W0[:, idx, idx] + rho[:, None]
            return W

        def attempt(rho):
            return self._attempt(shifted(rho), rhs)

        def attempt_gated(rho):
            W = shifted(rho)
            sol, suc = self._attempt_raw(W, rhs)
            return sol, suc & self._solve_quality_ok(W, sol, rhs)

        def attempt_eigh(rho):
            fac = eigh_factor(shifted(rho), pr.eig_tol)
            sol = eigh_solve(fac, rhs, pr.eig_tol)
            return sol, inertia_success(fac.vec, fac.mat, n, pr.eig_tol)

        def merge(out, out2, need, take):
            nfact_all = out.nfact + torch.where(need, out2.nfact, torch.zeros_like(out2.nfact))
            return _sel_tuple(take, out2, out)._replace(nfact=nfact_all)

        out = self._rho_ladder(attempt, rhs, rho_old, active)

        if self.robust_fallback:
            need = (out.rho != 0) | (~out.success)
            out2 = self._rho_ladder(attempt_eigh, rhs, rho_old, active & need)
            out = merge(out, out2, need, need & (out2.success | (~out.success)))

        if bad_direction is not None and self.descent_rescue and not self.quality_gate:
            bad = out.success & bad_direction(-out.sol)
            outg = self._rho_ladder(attempt_gated, rhs, rho_old, active & bad)
            out = merge(out, outg, bad, bad & outg.success & (~bad_direction(-outg.sol)))

        rho_old_new = torch.where(
            out.rho == 0, rho_old, torch.where(out.rho <= pr.rho_max, out.rho, rho_old)
        )
        step = _sel(out.success, -out.sol, torch.zeros_like(out.sol))
        return step, out.success, out.rho, rho_old_new, out.nfact

    def _merit(self, Fx, cx, lam, eta):
        """Augmented-Lagrangian merit ϕ = ½‖F‖² − λᵀc + (η/2)‖c‖²."""
        val = 0.5 * self._rsum(_vdot(Fx, Fx))
        if self.problem.ncon > 0:
            val = val - _vdot(lam, cx) + 0.5 * eta * _vdot(cx, cx)
        return val

    def _dual_scaling(self, lam):
        """sd = max(smax, ‖λ‖₁/ncon)/smax."""
        p = self.problem.ncon
        if p == 0:
            return lam.new_ones(lam.shape[:1])
        return torch.clamp(norm_1(lam) / p, min=SMAX) / SMAX

    def _small_res_recheck(self, s: SolverState) -> SolverState:
        """optimality_check_small_residual: re-estimate λ by CGLS at the
        current point and recompute the KKT residuals."""
        pb = self.problem
        r = s.Fx
        Jxtr = self._rsum(_mv(s.JxT, r))
        if pb.ncon > 0:
            JcT = s.Jcx.transpose(-2, -1)
            lam = cgls(JcT, Jxtr)
            dual = Jxtr - _mv(JcT, lam)
        else:
            lam = s.lam
            dual = Jxtr
        primal = torch.cat([torch.zeros_like(s.Fx), s.cx], -1)
        return s._replace(
            r=r, lam=lam, dual=dual, primal=primal,
            normdual=norm_inf(dual), normprimal=norm_inf(s.cx),
        )

    def _recheck_where(self, mask, s: SolverState) -> SolverState:
        """Small-residual re-check on the lanes of ``mask``, with the
        first-order test redone on the re-estimated multipliers."""
        if not self._any(mask):
            return s
        s2 = self._small_res_recheck(s)
        sd2 = self._dual_scaling(s2.lam)
        fo = torch.maximum(s2.normdual / sd2, s2.normprimal) <= s2.epstol
        return _sel_tuple(mask, s2._replace(first_order=fo), s)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_state(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        x = x0.to(dtype=self.dtype, device=self.device)
        lam = lam0.to(dtype=self.dtype, device=self.device)
        B = x.shape[0]

        Fx, JxT = pb.F_and_Jt(x, data)
        broken = self._rany(check_nan_inf(Fx))
        fx = 0.5 * self._rsum(_vdot(Fx, Fx))
        cx = pb.c_shifted(x, data)
        Jcx = pb.Jc(x, data)
        i32 = dict(dtype=torch.int32, device=x.device)
        r = Fx
        Jxtr = self._rsum(_mv(JxT, r))
        JcT = Jcx.transpose(-2, -1)
        if not self.use_initial_multiplier and p > 0:
            lam_ls = cgls(JcT, Jxtr)
            lam = _sel(norm_2(lam_ls) == 0, torch.ones_like(lam_ls), lam_ls)

        dual = Jxtr - (_mv(JcT, lam) if p > 0 else torch.zeros_like(Jxtr))
        primal = torch.cat([Fx - r, cx], -1)
        normdual = norm_inf(dual)
        normprimal = self._rmax(norm_inf(primal))

        epsF = cfg.Fatol + cfg.Frtol * 2 * torch.sqrt(fx)
        epstol = cfg.atol + cfg.rtol * normdual
        epsc = torch.sqrt(epstol)
        small_residual = (2 * torch.sqrt(fx) <= epsF) & (norm_2(cx) <= epsc)
        first_order = torch.maximum(normdual / self._dual_scaling(lam), normprimal) <= epstol

        def full(v):
            return torch.full((B,), v, dtype=self.dtype, device=x.device)

        s = SolverState(
            x=x, lam=lam, r=r, Fx=Fx, cx=cx, fx=fx, JxT=JxT, Jcx=Jcx,
            dual=dual, primal=primal,
            d=x.new_zeros((B, n + m + p)),
            dlam=x.new_zeros((B, p)),
            normdual=normdual, normprimal=normprimal,
            rho=full(0.0), rho_old=full(0.0), delta=full(1.0),
            eta=full(1.0 if p > 0 else 0.0), epsk=full(1e3), alpha=full(0.0),
            damp=full(1.0),
            epsF=epsF, epstol=epstol, epsc=epsc,
            iter=torch.zeros((B,), **i32),
            inner_iter=torch.zeros((B,), **i32),
            neval_F=torch.ones((B,), **i32),
            neval_c=torch.full((B,), 1 if p > 0 else 0, **i32),
            nbk=torch.zeros((B,), **i32),
            nfact=torch.zeros((B,), **i32),
            nlinsolve=torch.zeros((B,), **i32),
            status=torch.zeros((B,), **i32),
            broken=broken,
            msg=torch.zeros((B,), **i32),
            first_order=first_order,
            small_residual=small_residual,
            data=data,
        )
        s = self._recheck_where(small_residual & ~first_order, s)
        status = get_status_code(
            optimal=s.first_order,
            small_residual=s.small_residual,
            broken=s.broken,
            evals=s.neval_F + s.neval_c,
            max_eval=cfg.max_eval,
        )
        return s._replace(status=status)

    # ------------------------------------------------------------------
    # one outer iteration on the lanes of ``active``
    # ------------------------------------------------------------------
    def _solve_system(self, s: SolverState, act) -> SolverState:
        pb, pr = self.problem, self.params
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        H = self._H_block(s.x, s.lam, s.r, s.Fx, s.JxT, s.damp, s.data)
        bad_direction = None
        if self.descent_rescue:
            # the same slope as trial_step's Dϕ; extrapolation iterations
            # (inner_iter == 0) never require descent
            JxtFx = self._rsum(_mv(s.JxT, s.Fx))
            Jcw = _mv(s.Jcx.transpose(-2, -1), s.lam - s.cx / s.delta[:, None]) if p > 0 else None

            def bad_direction(d):
                Dphi = _vdot(JxtFx, d[:, :n])
                if Jcw is not None:
                    Dphi = Dphi - _vdot(d[:, :n], Jcw)
                return (Dphi >= 0) & (s.inner_iter != 0)

        if self.kkt == "condensed":
            rhs_r = s.primal[:, :m]
            K0 = self._assemble_condensed(H, s.JxT, s.Jcx, s.delta)
            b = torch.cat([s.dual + self._rsum(_mv(s.JxT, rhs_r)), s.primal[:, m:]], -1)
            z, success, rho, rho_old, nfacti = self._newton_system(
                K0, b, s.rho_old, act, bad_direction
            )
            dx = z[:, :n]
            # recover the eliminated residual step: J dx - dr = -rhs_r
            dr = rhs_r + (dx.unsqueeze(-2) @ s.JxT).squeeze(-2)
            d = torch.cat([dx, dr, z[:, n:]], -1)
        else:
            W0 = self._assemble_kkt(H, s.JxT, s.Jcx, s.delta)
            rhs = torch.cat([s.dual, s.primal], -1)
            d, success, rho, rho_old, nfacti = self._newton_system(
                W0, rhs, s.rho_old, act, bad_direction
            )
        bad_d = self._rany(check_nan_inf(d))
        blowup = s.fx >= min(F_BLOWUP, float(torch.finfo(self.dtype).max))
        over = rho > pr.rho_max
        broken = over | (~success) | bad_d | blowup
        msg = torch.zeros_like(s.msg)
        for cond, code in ((blowup, 4), (bad_d, 3), (~success, 2), (over, 1)):
            msg = torch.where(cond, torch.full_like(msg, code), msg)
        return s._replace(
            d=d,
            dlam=-d[:, n + m:],
            rho=rho,
            rho_old=rho_old,
            nfact=s.nfact + nfacti,
            nlinsolve=s.nlinsolve + 1,
            broken=s.broken | broken,
            msg=torch.where(s.msg == 0, msg, s.msg),
        )

    def _trial_step(self, s: SolverState, act):
        """Unified extrapolation / Armijo line-search step: one α = 1 trial
        evaluation, then per-lane α/4 backtracking on the Armijo lanes of
        ``act`` (extrapolation lanes never backtrack)."""
        pb, pr = self.problem, self.params
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        dtype = self.dtype
        data = s.data
        is_extrap = s.inner_iter == 0
        dx = s.d[:, :n]
        dr = s.d[:, n:n + m]

        epsk = torch.where(
            is_extrap,
            torch.maximum(torch.minimum(1e3 * s.delta, 0.99 * s.epsk), 0.9 * s.epsk),
            s.epsk,
        )
        eta_ls = 1.0 / s.delta if p > 0 else s.eta
        JxtFx = self._rsum(_mv(s.JxT, s.Fx))
        Dphi = _vdot(JxtFx, dx)
        if p > 0:
            w = s.lam - s.cx / s.delta[:, None]
            Dphi = Dphi - _vdot(dx, _mv(s.Jcx.transpose(-2, -1), w))
        not_descent = (Dphi >= 0) & (~is_extrap)
        phix = self._merit(s.Fx, s.cx, s.lam, eta_ls)
        gammaA = pr.gamma_A
        eps2 = float(torch.finfo(dtype).eps) ** 2

        xt = s.x + dx
        Ft = pb.F(xt, data)
        ct = pb.c_shifted(xt, data)
        phit = self._merit(Ft, ct, s.lam, eta_ls)
        alpha = torch.ones_like(s.delta)
        nbk = torch.zeros_like(s.nbk)
        fail = torch.zeros_like(s.broken)
        ls_lanes = act & (~not_descent) & (~is_extrap)
        while True:
            go = ls_lanes & (~fail) & (phit > phix + gammaA * alpha * Dphi)
            if not self._any(go):
                break
            alpha_n = alpha / 4
            xt_n = s.x + alpha_n[:, None] * dx
            Ft_n = pb.F(xt_n, data)
            ct_n = pb.c_shifted(xt_n, data)
            alpha = torch.where(go, alpha_n, alpha)
            xt = _sel(go, xt_n, xt)
            Ft = _sel(go, Ft_n, Ft)
            ct = _sel(go, ct_n, ct)
            phit = torch.where(go, self._merit(Ft_n, ct_n, s.lam, eta_ls), phit)
            nbk = nbk + go.to(torch.int32)
            fail = torch.where(go, alpha_n < eps2, fail)

        # extrapolation lanes: rt = r + dr, λt = λ + clip(dλ)
        ndl = norm_2(s.dlam)
        Mdl = MAX_DLAMBDA
        scale = Mdl / torch.where(ndl > 0, ndl, torch.ones_like(ndl))
        dlam = _sel(is_extrap & (ndl > Mdl), s.dlam * scale[:, None], s.dlam)
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
            not_descent,
            torch.full_like(s.msg, 5),
            torch.where(fail, torch.full_like(s.msg, 6), torch.zeros_like(s.msg)),
        )
        return xt, rt, lamt, Ft, ct, alpha_out, eta, epsk, dlam, nbk, nF_add, nc_add, ls_broken, ls_msg

    def _inner_ok(self, c: _InnerCarry, combined, cfg: RunConfig, act) -> _InnerCarry:
        """The non-broken branch of one inner iteration (trial step, trial
        linearization, acceptance and the δ heuristic)."""
        pb, pr = self.problem, self.params
        n, p = pb.nvar, pb.ncon
        s = c.s
        (xt, rt, lamt, Ft, ct, alpha, eta, epsk, dlam,
         nbk_add, nF_add, nc_add, ls_broken, ls_msg) = self._trial_step(s, act)

        damp = s.damp
        if self.method == "lm":
            # Ared/Pred bookkeeping; steers the KKT only with lm_damping
            nF2 = self._rsum(_vdot(s.Fx, s.Fx))
            Ared = nF2 - self._rsum(_vdot(Ft, Ft))
            step_a = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
            pred_vec = s.Fx + step_a[:, None] * (s.d[:, :n].unsqueeze(-2) @ s.JxT).squeeze(-2)
            Pred = nF2 - self._rsum(_vdot(pred_vec, pred_vec))
            ratio = Ared / Pred
            damp = torch.where(ratio > 0.75, damp / 10, torch.where(ratio < 0.25, damp * 10, damp))

        JtT = pb.Jt(xt, s.data)
        Jct = pb.Jc(xt, s.data)
        Jxtr = self._rsum(_mv(JtT, rt))
        dual_hat = Jxtr - (_mv(Jct.transpose(-2, -1), lamt) if p > 0 else torch.zeros_like(Jxtr))
        primal_hat = torch.cat([Ft - rt, ct], -1)
        ndh = norm_inf(dual_hat)
        nph = self._rmax(norm_inf(primal_hat))
        ch = ndh + nph

        good = (ch <= 0.99 * combined + epsk) & (~ls_broken)
        accept = ((s.inner_iter > 0) | self.always_accept_extrapolation | good) & (~ls_broken)

        x_n = _sel(accept, xt, s.x)
        r_n = _sel(accept, rt, s.r)
        Fx_n = _sel(accept, Ft, s.Fx)
        fx_n = torch.where(accept, 0.5 * self._rsum(_vdot(Ft, Ft)), s.fx)
        cx_n = _sel(accept, ct, s.cx)
        JxT_n = _sel(accept, JtT, s.JxT)
        Jcx_n = _sel(accept, Jct, s.Jcx)
        lam_n = _sel(good, lamt, s.lam)
        # on a rejected λ, recompute dual at the (possibly updated) iterate
        dual_re = self._rsum(_mv(JxT_n, r_n)) - (
            _mv(Jcx_n.transpose(-2, -1), s.lam) if p > 0 else torch.zeros_like(s.x)
        )
        dual_n = _sel(good, dual_hat, dual_re)

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
            x=x_n, r=r_n, Fx=Fx_n, fx=fx_n, cx=cx_n, JxT=JxT_n, Jcx=Jcx_n,
            lam=lam_n, dual=dual_n, primal=primal_hat, dlam=dlam,
            eta=eta, epsk=epsk, alpha=alpha, damp=damp, delta=delta_n,
            inner_iter=inner_n, neval_F=neF, neval_c=nec,
            nbk=s.nbk + nbk_add,
            broken=s.broken | ls_broken,
            msg=torch.where(s.msg == 0, ls_msg, s.msg),
        )
        return _InnerCarry(s_n, ndh, nph, ch, torch.zeros_like(c.first), tired)

    def _outer_step(self, s: SolverState, cfg: RunConfig, active) -> SolverState:
        """One outer iteration for the lanes of ``active``; the others keep
        their state."""
        pb, pr = self.problem, self.params
        p = pb.ncon
        s_in = s
        combined = s.normdual + s.normprimal
        delta0 = torch.clamp(torch.minimum(cfg.delta_dec * s.delta, combined), min=pr.delta_min)
        s = s._replace(
            delta=delta0, damp=torch.ones_like(s.damp), inner_iter=torch.zeros_like(s.inner_iter)
        )

        c = _InnerCarry(
            s, s.normdual, s.normprimal, torch.full_like(s.fx, float("inf")),
            torch.ones_like(s.broken), (s.neval_F + s.neval_c) > cfg.max_eval,
        )
        while True:
            conv = (c.combined_hat <= 0.99 * combined + c.s.epsk) | c.tired
            go = active & (c.first | ~conv) & (~c.s.broken)
            if not self._any(go):
                break
            s = c.s
            # skip the solve right after a failed extrapolation (the
            # inner_iter == 1 quirk of the reference)
            do_solve = go & ((s.inner_iter != 1) | self.always_accept_extrapolation)
            if self._any(do_solve):
                s = _sel_tuple(do_solve, self._solve_system(s, do_solve), s)
            ok = go & (~s.broken)
            c_broken = _InnerCarry(
                s, c.normdualhat, c.normprimalhat, c.combined_hat,
                torch.zeros_like(c.first), c.tired,
            )
            c_new = self._inner_ok(c._replace(s=s), combined, cfg, ok) if self._any(ok) else c_broken
            c_new = _InnerCarry(
                _sel_tuple(ok, c_new.s, s),
                *[_sel(ok, a, b) for a, b in zip(c_new[1:], c_broken[1:])],
            )
            c = _InnerCarry(
                _sel_tuple(go, c_new.s, c.s),
                *[_sel(go, a, b) for a, b in zip(c_new[1:], c[1:])],
            )
        s = c.s._replace(normdual=c.normdualhat, normprimal=c.normprimalhat)

        if self.multiplier_refit and p > 0:
            # per-outer CGLS multiplier refit, kept only where it strictly
            # lowers the dual norm
            JcT = s.Jcx.transpose(-2, -1)
            Jxtr_f = self._rsum(_mv(s.JxT, s.r))
            lam_fit = cgls(JcT, Jxtr_f)
            dual_fit = Jxtr_f - _mv(JcT, lam_fit)
            nd_fit = norm_inf(dual_fit)
            take = (nd_fit < s.normdual) & (~s.broken)
            s = s._replace(
                lam=_sel(take, lam_fit, s.lam),
                dual=_sel(take, dual_fit, s.dual),
                normdual=torch.where(take, nd_fit, s.normdual),
            )

        # outer bookkeeping
        sd = self._dual_scaling(s.lam)
        first_order = torch.maximum(s.normdual / sd, s.normprimal) <= s.epstol
        small_residual = (2 * torch.sqrt(s.fx) <= s.epsF) & (norm_2(s.cx) <= s.epsc)
        s = s._replace(first_order=first_order, small_residual=small_residual)
        s = self._recheck_where(active & small_residual & ~first_order, s)

        iter_n = s.iter + 1
        status = get_status_code(
            optimal=s.first_order,
            small_residual=s.small_residual,
            broken=s.broken,
            evals=s.neval_F + s.neval_c,
            max_eval=cfg.max_eval,
            iter_=iter_n,
            max_iter=cfg.max_iter,
            stalled=(s.inner_iter > cfg.max_inner) & (cfg.max_inner >= 0),
        )
        s = s._replace(iter=iter_n, status=status)
        return _sel_tuple(active, s, s_in)

    # ------------------------------------------------------------------
    # batched run: init, then outer steps until no lane is UNKNOWN
    # ------------------------------------------------------------------
    @scoped
    def run(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        """Solve a batch to the end: x0 (B, n), lam0 (B, p), data leaves
        with a leading B axis (or None).  Counterpart of the JAX
        ``_run_compiled`` under vmap."""
        s = self._init_state(x0, lam0, cfg, data)
        while True:
            active = s.status == Status.UNKNOWN
            if not self._any(active):
                return s
            s = self._outer_step(s, cfg, active)

    # ------------------------------------------------------------------
    # host-driven solve (callbacks, wall-clock limit, logging)
    # ------------------------------------------------------------------
    def make_config(
        self,
        *,
        atol=None,
        rtol=None,
        Fatol=None,
        Frtol=None,
        delta_dec=0.1,
        max_eval=100000,
        max_inner=10000,
        max_iter=-1,
    ) -> RunConfig:
        eps = float(torch.finfo(self.dtype).eps)
        sqeps = eps**0.5

        def f(v):
            return torch.tensor(v, dtype=self.dtype, device=self.device)

        def i(v):
            return torch.tensor(v, dtype=torch.int32, device=self.device)

        return RunConfig(
            atol=f(sqeps if atol is None else atol),
            rtol=f(sqeps if rtol is None else rtol),
            Fatol=f(sqeps if Fatol is None else Fatol),
            Frtol=f(eps if Frtol is None else Frtol),
            delta_dec=f(delta_dec),
            max_eval=i(max_eval),
            max_inner=i(max_inner),
            max_iter=i(max_iter),
        )

    @scoped
    def solve(
        self,
        x0=None,
        lam0=None,
        *,
        callback: Optional[Callable] = None,
        max_time: float = 30.0,
        verbose: int = 0,
        stats: Optional[ExecutionStats] = None,
        resume_from: Optional[SolverState] = None,
        **numeric,
    ) -> ExecutionStats:
        """Host-driven solve of one instance (B = 1): one outer step per host
        iteration, with the callback and log rows between them.
        ``callback(problem, state, stats)``; set ``stats.status = 'user'``
        to stop.

        ``max_time`` is read between outer steps, as in the JAX package, and
        after the first outer step also at every host sync inside one: an
        outer step of the port can take thousands of host trips (an inner
        loop up to ``max_inner`` iterations), where the JAX package runs it
        as one compiled call.  A step that the budget interrupts is dropped,
        and the last outer iterate is returned with status ``max_time``.

        ``resume_from``: a state with B = 1 (``last_state``, or one loaded
        with ``utils.checkpoint.load_state``) to continue.  Its tolerances
        ride the state; explicit ``atol``/``rtol``/``Fatol``/``Frtol``
        re-target the run from the current iterate (ϵtol = atol +
        rtol·‖∇L‖ now)."""
        pb = self.problem
        pb.validate_for_solve()
        t0 = time.time()
        cfg = self.make_config(**numeric)
        stats = stats or ExecutionStats()
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
            state = self._init_state(x0, lam0, cfg, _add_batch_axis(pb.data, self.device))
        self._sync_stats(state, stats, time.time() - t0)
        if verbose > 0:
            self._log_header()
        self._between_steps(state, stats, callback, verbose > 0, False)
        done = stats.status != "unknown"

        try:
            while not done:
                try:
                    state = self._outer_step(state, cfg, state.status == Status.UNKNOWN)
                except _BudgetSpent:
                    stats.status = status_name(Status.MAX_TIME)
                    stats.elapsed_time = time.time() - t0
                    break
                elapsed = time.time() - t0
                self._sync_stats(state, stats, elapsed)
                log = verbose > 0 and stats.iter % verbose == 0
                self._between_steps(state, stats, callback, log, elapsed > max_time)
                done = stats.status != "unknown"
                self._deadline = t0 + max_time
        finally:
            self._deadline = None

        self._finalize_stats(state, stats)
        self.last_state = state
        pb.counters.neval_residual += int(state.neval_F[0])
        pb.counters.neval_cons += int(state.neval_c[0])
        return stats

    def _between_steps(self, s: SolverState, stats: ExecutionStats, callback, log: bool, over: bool):
        """The host's turn after an outer step: the wall-clock budget
        (``over``: this rank's clock is past it), the log row and the
        callback.  On a row mesh each decision is the ranks' together: all
        stop when one rank's budget is spent or its callback sets 'user', and
        all take part in the log row's reduction when one rank logs."""
        over, any_log = self._agree(stats.status == "unknown" and over, log)
        if over:
            stats.status = status_name(Status.MAX_TIME)
        if any_log:
            self._log_row(s, stats, show=log)
        if callback is not None:
            callback(self.problem, s, stats)
        if self._agree(stats.status == "user")[0]:
            stats.status = "user"

    def _sync_stats(self, s: SolverState, stats: ExecutionStats, elapsed: float):
        code = int(s.status[0])
        # don't clobber a host-set status (user/max_time)
        if stats.status in ("unknown", status_name(code)) or code != 0:
            if stats.status != "user":
                stats.status = status_name(code)
        stats.iter = int(s.iter[0])
        stats.elapsed_time = elapsed
        stats.objective = float(s.fx[0])
        stats.dual_feas = float(s.normdual[0])
        stats.primal_feas = float(norm_2(s.cx)[0])
        stats.solution = s.x[0].cpu().numpy()
        stats.multipliers = s.lam[0].cpu().numpy()

    def _finalize_stats(self, s: SolverState, stats: ExecutionStats):
        stats.solver_specific.update(
            nbk=int(s.nbk[0]),
            nfact=int(s.nfact[0]),
            nlinsolve=int(s.nlinsolve[0]),
            internal_msg=MSG[int(s.msg[0])],
            neval_residual=int(s.neval_F[0]),
            neval_cons=int(s.neval_c[0]),
        )

    def _log_header(self):
        cols = ["iter", "#F+c", "f(x)", "‖∇L‖", "‖Fx-r‖", "‖c(x)‖", "α", "η", "ρ", "δ", "in_it", "nbk"]
        print("  ".join(f"{c:>9s}" for c in cols))

    def _log_row(self, s: SolverState, stats: ExecutionStats, show: bool = True):
        m = self.problem.nequ
        pr = s.primal[:, :m]
        pf = float(torch.sqrt(self._rsum(_vdot(pr, pr)))[0])
        cf = float(norm_2(s.primal[:, m:])[0]) if self.problem.ncon > 0 else 0.0
        if not show:
            return
        print(
            f"{int(s.iter[0]):9d}  {int(s.neval_F[0] + s.neval_c[0]):9d}  {float(s.fx[0]):9.2e}  "
            f"{float(s.normdual[0]):9.2e}  {pf:9.2e}  {cf:9.2e}  {float(s.alpha[0]):9.2e}  "
            f"{float(s.eta[0]):9.2e}  {float(s.rho[0]):9.2e}  {float(s.delta[0]):9.2e}  "
            f"{int(s.inner_iter[0]):9d}  {int(s.nbk[0]):9d}"
        )


def _add_batch_axis(tree, device):
    """A problem's unbatched data pytree with a leading batch axis of 1."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device).unsqueeze(0)
    if isinstance(tree, dict):
        return {k: _add_batch_axis(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_add_batch_axis(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree), device=device).unsqueeze(0)


def cannoles(
    problem: NLSProblem,
    *,
    method: str = "newton",
    linsolve: str = "auto",
    kkt: str = "auto",
    x=None,
    lam=None,
    use_initial_multiplier: bool = False,
    always_accept_extrapolation: bool = False,
    multiplier_refit: bool = False,
    callback=None,
    max_time: float = 30.0,
    verbose: int = 0,
    matmul_precision: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    device=None,
    **numeric,
) -> ExecutionStats:
    """Solve ``min ½‖F(x)‖²  s.t.  c(x) = 0`` for one instance.

    Keyword arguments follow the JAX package's ``cannoles``: ``method``
    ('newton' | 'lm' | 'gauss_newton' | 'newton_vanishing'), ``linsolve``
    ('auto' | 'ldlt' | 'eigh' | 'pallas' | 'chol'; 'auto' is 'chol' on a
    condensed Gauss–Newton/LM system, else 'ldlt', with the in-loop eigh
    retry), ``kkt`` ('auto' | 'full' | 'condensed'), ``multiplier_refit``, the budgets
    ``max_iter``, ``max_eval``, ``max_inner``, ``max_time``, the tolerances
    ``atol``, ``rtol``, ``Fatol``, ``Frtol``, ``verbose`` and ``callback``.
    ``matmul_precision`` is the solver's (the JAX package's ``cannoles``
    takes it only through ``CaNNOLeSSolver``).  ``dtype``/``device`` default
    to those of ``problem.x0``.
    Returns an :class:`ExecutionStats`.
    """
    problem.validate_for_solve()
    linsolve, kkt, auto = resolve_auto(problem, method, linsolve, kkt)
    solver = CaNNOLeSSolver(
        problem,
        method=method,
        linsolve=linsolve,
        kkt=kkt,
        robust_fallback=auto,
        use_initial_multiplier=use_initial_multiplier,
        always_accept_extrapolation=always_accept_extrapolation,
        multiplier_refit=multiplier_refit,
        matmul_precision=matmul_precision,
        dtype=dtype,
        device=device,
    )
    return solver.solve(
        x0=x, lam0=lam, callback=callback, max_time=max_time, verbose=verbose, **numeric
    )
