"""Constrained nonlinear least-squares solver, batch-native, in PyTorch.

Port of ``cannoles_tpu/core/solver.py`` (the Orban–Siqueira regularization
method of CaNNOLeS.jl).  The JAX package vmaps a scalar state machine built
from ``lax.while_loop``s; ``torch.func.vmap`` cannot batch a loop whose trip
count depends on the data, so here the state machine is written batched:

* every state tensor has a leading batch axis B; a single solve is B = 1;
* every ``while_loop`` is a Python loop over a per-lane ``active`` mask,
  which is the parent loop's mask AND the loop's own condition.  Updates go
  through ``torch.where``, and the loop ends when no lane is active;
* a lane that is not active keeps its state bit for bit, which is what a
  lane of JAX's batched ``while_loop`` does, so each lane follows the
  trajectory it would follow alone;
* the loops' bodies are segments between host checks (``core/segments.py``):
  init; the system build with the first ρ attempt; one attempt; the trial
  point; one line-search trip; the acceptance; the outer bookkeeping.  A
  host check reads a segment's flags in one sync (counted in
  ``CaNNOLeSSolver.host_syncs``).  Where the JAX package jits the outer
  step, the port on a CUDA device captures each segment once as a CUDA
  graph and replays it (``route == "graph"``); on the CPU, with a row mesh
  and with ``linsolve='cpp'`` the segments run eagerly (``route ==
  "eager"``; ``route_reason`` says why).  Both routes give the same bits.
  ``solve()`` pays a solver's one-time costs before its clock
  (``_warm_up``, the counterpart of the JAX package's ``_outer_warm``).

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

import collections
import contextlib
import time
from types import SimpleNamespace
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
from ..utils.spans import count_check, span
from .segments import Bank, _leaves, clone_tree, counters, load, restore_counters, run_segment
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
    """torch.where over a leading batch axis: a where mask, else b (``a``
    itself where the two sides are one tensor, as a state field that a step
    left alone is: the same bits without the operation)."""
    if a is b:
        return a
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
    """Solve (L Lᵀ) x = b for a batch of vectors b (B, k).  At B > 1 by two
    triangular solves, L y = b then Lᵀ x = y (``jax.scipy.linalg.cho_solve``'s
    structure; cuBLAS's trsm on a card, which a CUDA graph captures, where a
    batched ``torch.cholesky_solve`` goes to MAGMA and allocates inside the
    capture).  At B = 1 ``torch.cholesky_solve``: cuSOLVER's ``potrs`` on a
    card, which the capture takes, and whose rounding is closer to the
    CPU's (the float64 card-vs-CPU bars of the row-sharded fit hold with it
    and not with trsm).  On the CPU both are LAPACK's ``potrs``, the same
    bits."""
    if L.shape[0] == 1:
        return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)


class _Hat(NamedTuple):
    """The inner loop's carry beside the state."""

    normdualhat: torch.Tensor
    normprimalhat: torch.Tensor
    combined_hat: torch.Tensor
    first: torch.Tensor
    tired: torch.Tensor


class _LS(NamedTuple):
    """The line search's trial point and its bookkeeping."""

    xt: torch.Tensor
    Ft: torch.Tensor
    ct: torch.Tensor
    phit: torch.Tensor
    alpha: torch.Tensor
    nbk: torch.Tensor
    fail: torch.Tensor


class _LSFixed(NamedTuple):
    """What the line search's trips read and do not change."""

    epsk: torch.Tensor
    eta_ls: torch.Tensor
    Dphi: torch.Tensor
    not_descent: torch.Tensor
    phix: torch.Tensor
    ls_lanes: torch.Tensor


def _flags(a, b=None):
    """A host check's flags: whether any lane of ``a`` (and of ``b``) is
    set, as one (2,) tensor, read in one sync."""
    return torch.stack([a.any(), (a if b is None else b).any()])


def _layout(tree):
    """The shapes and dtypes of a data pytree (a bank's key)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, _layout(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_layout(v) for v in tree)
    return repr(tree)


class _Rho(NamedTuple):
    rho: torch.Tensor
    sol: torch.Tensor
    success: torch.Tensor
    nfact: torch.Tensor


# banks (captured segments with their buffers) a solver keeps on the graph
# route: the batch sizes of a vsolve's chunks, its last chunk and a few
# rescue sizes
MAX_BANKS = 8


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
        debug_print: bool = False,
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
        # one row per outer iteration and active lane (``_debug_rows``)
        self.debug_print = bool(debug_print)
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
        # host checks (reads of a segment's flags, one sync each) since
        # construction
        self.host_syncs = 0
        # solve()'s wall-clock deadline (time.time()), read at every host check
        self._deadline: Optional[float] = None
        # where the segments run (``core/segments.py``): eagerly with a row
        # mesh (its all-reduces go through the host), with linsolve='cpp'
        # (a host round trip) and on the CPU; else replayed CUDA graphs
        if mesh is not None:
            self.route, self.route_reason = "eager", "mesh"
        elif linsolve == "cpp":
            self.route, self.route_reason = "eager", "cpp"
        elif self.device.type == "cuda":
            self.route, self.route_reason = "graph", "cuda"
        else:
            self.route, self.route_reason = "eager", "cpu"
        # the graph route's banks by (B, data layout), the most recently
        # used last, and the one memory pool of their graphs (made at the
        # first capture)
        self._banks: collections.OrderedDict = collections.OrderedDict()
        self._pool: list = [None]
        # whether solve() has paid its one-time costs (_warm_up)
        self._warm = False

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
            debug_print=self.debug_print,
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

    # ------------------------------------------------------------------
    # the rho ladder, one segment per attempt
    # ------------------------------------------------------------------
    def _ladder_start(self, rho_old, rhs, active) -> dict:
        """The reference's exact rho schedule around one factorization seam:
        try rho=0; on inertia failure rho ← rho0 (first time) or
        max(rho_min, κdec·rho_old); escalate by κlargeinc/κinc until success
        or rho > rho_max.  ``nfact`` counts the attempts made with
        rho ≤ rho_max.  Lanes outside ``active`` make no attempt.  Returns
        the schedule and the empty carry as bank entries."""
        pr = self.params
        B = rhs.shape[0]
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
        c = _Rho(rhs.new_zeros((B,)), torch.zeros_like(rhs), torch.zeros_like(active),
                 torch.zeros((B,), dtype=torch.int32, device=rhs.device))
        return dict(lad_first=first_rho, lad_inc=inc, lad_c=c, lad_act=active, lad_go=active)

    def _ladder_step(self, kind, k, W0, rhs, t, go):
        """Attempt ``k`` (0: rho = 0, 1: the first rho, 2: every later one)
        on the lanes of ``go``; returns the carry and the next go mask."""
        pr = self.params
        c = t.lad_c
        rho = rhs.new_zeros(c.rho.shape) if k == 0 else (t.lad_first if k == 1 else c.rho * t.lad_inc)
        do = rho <= pr.rho_max
        sol_t, suc_t = self._attempt_kind(kind, W0, rhs, rho)
        new = _Rho(rho, _sel(do, sol_t, c.sol), do & suc_t, c.nfact + do.to(torch.int32))
        c = _sel_tuple(go, new, c)
        return c, t.lad_act & (~c.success) & (c.rho <= pr.rho_max)

    def _attempt_kind(self, kind, W0, rhs, rho):
        """One attempt on W0 + rho·I (x block): the primary backend
        (``main``), the gated backend (``gated``) or eigh (``eigh``)."""
        pr = self.params
        n = self.problem.nvar
        W = W0.clone()
        W.diagonal(dim1=-2, dim2=-1)[:, :n].add_(rho[:, None])
        if kind == "main":
            return self._attempt(W, rhs)
        if kind == "gated":
            sol, suc = self._attempt_raw(W, rhs)
            return sol, suc & self._solve_quality_ok(W, sol, rhs)
        fac = eigh_factor(W, pr.eig_tol)
        sol = eigh_solve(fac, rhs, pr.eig_tol)
        return sol, inertia_success(fac.vec, fac.mat, n, pr.eig_tol)

    def _attempt_seg(self, kind, k):
        def seg(t):
            c, go = self._ladder_step(kind, k, t.W0, t.rhs, t, t.lad_go)
            return dict(lad_c=c, lad_go=go, flags=_flags(go))

        return seg

    def _ladder(self, t, kind, k=0):
        """Run the attempts of one ladder from attempt ``k``, one host check
        after each (the one before attempt ``k`` was made by the caller)."""
        while True:
            kk = min(k, 2)
            run_segment(t, f"attempt:{kind}:{kk}", self._attempt_seg(kind, kk),
                      eager=kind == "eigh" or self.linsolve == "eigh")
            k += 1
            if not self._check(t)[0]:
                return

    @staticmethod
    def _merge(out, out2, need, take):
        nfact_all = out.nfact + torch.where(need, out2.nfact, torch.zeros_like(out2.nfact))
        return _sel_tuple(take, out2, out)._replace(nfact=nfact_all)

    def _bad_direction(self, t, d):
        """Lanes whose step is not a descent direction of the merit (the
        same slope as the trial step's Dϕ; extrapolation iterations,
        inner_iter == 0, never require descent)."""
        n = self.problem.nvar
        Dphi = _vdot(t.dphi_g, d[:, :n])
        if self.problem.ncon > 0:
            Dphi = Dphi - _vdot(d[:, :n], t.dphi_c)
        return (Dphi >= 0) & (t.s.inner_iter != 0)

    def _newton_system_segments(self, t):
        """Inertia-corrected factorize-and-solve on ``t.W0``, ``t.rhs`` for
        the lanes of ``t.do_solve``, after the first attempt (whose flags
        the first check reads): the rho ladder around the primary backend,
        then the fallback ladders.  Leaves the result in ``t.lad_c``."""
        if self._check(t)[0]:
            self._ladder(t, "main", 1)
        self._fallback_ladders(t, descent=True)

    def _fallback_ladders(self, t, descent: bool):
        """(robust_fallback) an exact-inertia eigh ladder for lanes that
        needed regularization, and (descent_rescue with the gate off) a
        gated ladder for lanes whose successful step is not a descent
        direction."""
        if self.robust_fallback:
            def rf_prep(t):
                out = t.lad_c
                need = (out.rho != 0) | (~out.success)
                st = self._ladder_start(t.s.rho_old, t.rhs, t.do_solve & need)
                return dict(lad_main=out, need=need, **st, flags=_flags(st["lad_act"]))

            def rf_merge(t):
                out, out2, need = t.lad_main, t.lad_c, t.need
                return dict(lad_c=self._merge(out, out2, need, need & (out2.success | (~out.success))))

            run_segment(t, "rf_prep", rf_prep)
            if self._check(t)[0]:
                self._ladder(t, "eigh")
            run_segment(t, "rf_merge", rf_merge)
        if descent and self.descent_rescue and not self.quality_gate:
            def dr_prep(t):
                out = t.lad_c
                bad = out.success & self._bad_direction(t, -out.sol)
                st = self._ladder_start(t.s.rho_old, t.rhs, t.do_solve & bad)
                return dict(lad_main=out, need=bad, **st, flags=_flags(st["lad_act"]))

            def dr_merge(t):
                out, outg, bad = t.lad_main, t.lad_c, t.need
                take = bad & outg.success & (~self._bad_direction(t, -outg.sol))
                return dict(lad_c=self._merge(out, outg, bad, take))

            run_segment(t, "dr_prep", dr_prep)
            if self._check(t)[0]:
                self._ladder(t, "gated")
            run_segment(t, "dr_merge", dr_merge)

    def _newton_system(self, W0, rhs, rho_old, active):
        """The ladders on one system as a function (eager, no descent
        rescue; ``utils.profiling.stage_timings`` times it).  Returns
        (step, success, rho, rho_old_new, nfact)."""
        pr = self.params
        t = Bank("eager", self.problem.name)
        t.W0, t.rhs, t.do_solve, t.s = W0, rhs, active, SimpleNamespace(rho_old=rho_old)
        t.__dict__.update(self._ladder_start(rho_old, rhs, active))
        t.flags, t.last = _flags(active), "newton_system"
        if self._check(t)[0]:
            self._ladder(t, "main")
        self._fallback_ladders(t, descent=False)
        out = t.lad_c
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

    def _small_res_recheck(self, s: SolverState, check: bool) -> SolverState:
        """optimality_check_small_residual: re-estimate λ by CGLS at the
        current point and recompute the KKT residuals."""
        pb = self.problem
        r = s.Fx
        Jxtr = self._rsum(_mv(s.JxT, r))
        if pb.ncon > 0:
            JcT = s.Jcx.transpose(-2, -1)
            lam = cgls(JcT, Jxtr, check=check)
            dual = Jxtr - _mv(JcT, lam)
        else:
            lam = s.lam
            dual = Jxtr
        primal = torch.cat([torch.zeros_like(s.Fx), s.cx], -1)
        return s._replace(
            r=r, lam=lam, dual=dual, primal=primal,
            normdual=norm_inf(dual), normprimal=norm_inf(s.cx),
        )

    def _recheck(self, mask, s: SolverState, check: bool) -> SolverState:
        """Small-residual re-check on the lanes of ``mask``, with the
        first-order test redone on the re-estimated multipliers."""
        s2 = self._small_res_recheck(s, check)
        sd2 = self._dual_scaling(s2.lam)
        fo = torch.maximum(s2.normdual / sd2, s2.normprimal) <= s2.epstol
        return _sel_tuple(mask, s2._replace(first_order=fo), s)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _seg_init(self, t) -> dict:
        pb = self.problem
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        cfg, data = t.cfg, t.data
        x = t.x0
        lam = t.lam0
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
            lam_ls = cgls(JcT, Jxtr, check=t._host_reads)
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
        return self._finish_init(s, small_residual & ~first_order, cfg)

    def _finish_init(self, s, mask, cfg) -> dict:
        """Init's status, and the entries for the host check that follows:
        the lanes to re-check and the lanes left to solve."""
        status = get_status_code(
            optimal=s.first_order,
            small_residual=s.small_residual,
            broken=s.broken,
            evals=s.neval_F + s.neval_c,
            max_eval=cfg.max_eval,
        )
        fin = s._replace(status=status)
        nxt = status == Status.UNKNOWN
        return dict(s_pre=s, s=fin, mask=mask, nxt=nxt, flags=_flags(mask, nxt))

    def _init(self, t):
        """Init on the bank's x0, lam0, cfg and data: ``t.s`` and ``t.nxt``;
        returns whether any lane is left to solve."""
        with span("cannoles.init"):
            run_segment(t, "init", self._seg_init)
            re, nxt = self._check(t)
            if re:
                def recheck_init(t):
                    s = self._recheck(t.mask, t.s_pre, t._host_reads)
                    out = self._finish_init(s, t.mask, t.cfg)
                    return dict(s=out["s"], nxt=out["nxt"], flags=_flags(out["nxt"]))

                run_segment(t, "recheck_init", recheck_init)
                nxt = self._check(t)[0]
        return nxt

    def _init_state(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        """Init of a batch as a function: x0 (B, n), lam0 (B, p)."""
        t = self._bank(x0.shape[0], data)
        load(t, x0=x0.to(dtype=self.dtype, device=self.device),
             lam0=lam0.to(dtype=self.dtype, device=self.device), cfg=cfg, data=data)
        self._init(t)
        return self._result(t.s, data)

    # ------------------------------------------------------------------
    # one outer iteration on the lanes of ``t.nxt``
    # ------------------------------------------------------------------
    def _inner_go(self, active, combined, hat, s):
        """The inner loop's test: the lanes that take another inner
        iteration, and those of them that solve a system (not right after a
        failed extrapolation: the inner_iter == 1 quirk of the reference)."""
        conv = (hat.combined_hat <= 0.99 * combined + s.epsk) | hat.tired
        go = active & (hat.first | ~conv) & (~s.broken)
        do_solve = go if self.always_accept_extrapolation else go & (s.inner_iter != 1)
        return go, do_solve

    def _seg_outer_pre(self, t) -> dict:
        pr = self.params
        s, cfg, active = t.s, t.cfg, t.nxt
        combined = s.normdual + s.normprimal
        delta0 = torch.clamp(torch.minimum(cfg.delta_dec * s.delta, combined), min=pr.delta_min)
        s2 = s._replace(
            delta=delta0, damp=torch.ones_like(s.damp), inner_iter=torch.zeros_like(s.inner_iter)
        )
        hat = _Hat(
            s2.normdual, s2.normprimal, torch.full_like(s2.fx, float("inf")),
            torch.ones_like(s2.broken), (s2.neval_F + s2.neval_c) > cfg.max_eval,
        )
        go, do_solve = self._inner_go(active, combined, hat, s2)
        return dict(s_in=s, s=s2, active=active, combined=combined, hat=hat, go=go,
                    do_solve=do_solve, flags=_flags(go, do_solve))

    def _seg_solve0(self, t) -> dict:
        """The system build (the H block, the KKT or condensed system and its
        right-hand side) and the ladder's first attempt (rho = 0)."""
        pb = self.problem
        m = pb.nequ
        s = t.s
        H = self._H_block(s.x, s.lam, s.r, s.Fx, s.JxT, s.damp, s.data)
        out = {}
        if self.descent_rescue:
            out["dphi_g"] = self._rsum(_mv(s.JxT, s.Fx))
            if pb.ncon > 0:
                out["dphi_c"] = _mv(s.Jcx.transpose(-2, -1), s.lam - s.cx / s.delta[:, None])
        if self.kkt == "condensed":
            W0 = self._assemble_condensed(H, s.JxT, s.Jcx, s.delta)
            rhs = torch.cat([s.dual + self._rsum(_mv(s.JxT, s.primal[:, :m])), s.primal[:, m:]], -1)
        else:
            W0 = self._assemble_kkt(H, s.JxT, s.Jcx, s.delta)
            rhs = torch.cat([s.dual, s.primal], -1)
        st = self._ladder_start(s.rho_old, rhs, t.do_solve)
        t0 = SimpleNamespace(**st)
        c, go = self._ladder_step("main", 0, W0, rhs, t0, t.do_solve)
        st.update(lad_c=c, lad_go=go)
        return dict(out, W0=W0, rhs=rhs, **st, flags=_flags(go))

    def _post_solve(self, t) -> SolverState:
        """The step from the ladders' result, on the lanes of ``do_solve``."""
        pb, pr = self.problem, self.params
        n, m = pb.nvar, pb.nequ
        s, out = t.s, t.lad_c
        rho_old = torch.where(
            out.rho == 0, s.rho_old, torch.where(out.rho <= pr.rho_max, out.rho, s.rho_old)
        )
        z = _sel(out.success, -out.sol, torch.zeros_like(out.sol))
        success, rho = out.success, out.rho
        if self.kkt == "condensed":
            dx = z[:, :n]
            # recover the eliminated residual step: J dx - dr = -rhs_r
            dr = s.primal[:, :m] + (dx.unsqueeze(-2) @ s.JxT).squeeze(-2)
            d = torch.cat([dx, dr, z[:, n:]], -1)
        else:
            d = z
        bad_d = self._rany(check_nan_inf(d))
        blowup = s.fx >= min(F_BLOWUP, float(torch.finfo(self.dtype).max))
        over = rho > pr.rho_max
        broken = over | (~success) | bad_d | blowup
        msg = torch.zeros_like(s.msg)
        for cond, code in ((blowup, 4), (bad_d, 3), (~success, 2), (over, 1)):
            msg = torch.where(cond, torch.full_like(msg, code), msg)
        s_new = s._replace(
            d=d,
            dlam=-d[:, n + m:],
            rho=rho,
            rho_old=rho_old,
            nfact=s.nfact + out.nfact,
            nlinsolve=s.nlinsolve + 1,
            broken=s.broken | broken,
            msg=torch.where(s.msg == 0, msg, s.msg),
        )
        return _sel_tuple(t.do_solve, s_new, s)

    def _trial_seg(self, solved: bool):
        """The step (after a solve) and the trial point's first evaluation:
        one α = 1 trial, and the line search's first test on the Armijo
        lanes (extrapolation lanes never backtrack)."""

        def seg(t):
            pb, pr = self.problem, self.params
            n, p = pb.nvar, pb.ncon
            s = self._post_solve(t) if solved else t.s
            ok = t.go & (~s.broken)
            is_extrap = s.inner_iter == 0
            dx = s.d[:, :n]
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

            xt = s.x + dx
            Ft = pb.F(xt, s.data)
            ct = pb.c_shifted(xt, s.data)
            phit = self._merit(Ft, ct, s.lam, eta_ls)
            ls = _LS(xt, Ft, ct, phit, torch.ones_like(s.delta), torch.zeros_like(s.nbk),
                     torch.zeros_like(s.broken))
            fixed = _LSFixed(epsk, eta_ls, Dphi, not_descent, phix, ok & (~not_descent) & (~is_extrap))
            go = self._ls_go(ls, fixed)
            return dict(s=s, ok=ok, ls=ls, lsf=fixed, ls_go=go, flags=_flags(go))

        return seg

    def _ls_go(self, ls, f):
        """The Armijo lanes that backtrack once more."""
        return f.ls_lanes & (~ls.fail) & (ls.phit > f.phix + self.params.gamma_A * ls.alpha * f.Dphi)

    def _seg_ls(self, t) -> dict:
        """One α/4 backtracking trip on the lanes of ``ls_go``."""
        pb = self.problem
        s, ls, f, go = t.s, t.ls, t.lsf, t.ls_go
        eps2 = float(torch.finfo(self.dtype).eps) ** 2
        alpha_n = ls.alpha / 4
        xt_n = s.x + alpha_n[:, None] * s.d[:, :pb.nvar]
        Ft_n = pb.F(xt_n, s.data)
        ct_n = pb.c_shifted(xt_n, s.data)
        ls = _LS(
            _sel(go, xt_n, ls.xt),
            _sel(go, Ft_n, ls.Ft),
            _sel(go, ct_n, ls.ct),
            torch.where(go, self._merit(Ft_n, ct_n, s.lam, f.eta_ls), ls.phit),
            torch.where(go, alpha_n, ls.alpha),
            ls.nbk + go.to(torch.int32),
            torch.where(go, alpha_n < eps2, ls.fail),
        )
        go = self._ls_go(ls, f)
        return dict(ls=ls, ls_go=go, flags=_flags(go))

    def _seg_accept(self, t) -> dict:
        """The rest of one inner iteration on the lanes of ``ok`` (the
        extrapolation bookkeeping, the trial linearization, acceptance and
        the δ heuristic), the carry's update on the lanes of ``go``, and the
        next iteration's test."""
        pb, pr = self.problem, self.params
        n, m, p = pb.nvar, pb.nequ, pb.ncon
        s, ls, f, cfg, ok, hat = t.s, t.ls, t.lsf, t.cfg, t.ok, t.hat
        is_extrap = s.inner_iter == 0
        nbk = ls.nbk
        # extrapolation lanes: rt = r + dr, λt = λ + clip(dλ)
        ndl = norm_2(s.dlam)
        Mdl = MAX_DLAMBDA
        scale = Mdl / torch.where(ndl > 0, ndl, torch.ones_like(ndl))
        dlam = _sel(is_extrap & (ndl > Mdl), s.dlam * scale[:, None], s.dlam)
        rt = _sel(is_extrap, s.r + s.d[:, n:n + m], ls.Ft)
        if p > 0:
            lamt = _sel(is_extrap, s.lam + dlam, s.lam - s.cx / s.delta[:, None])
        else:
            lamt = s.lam
        alpha = torch.where(is_extrap, torch.zeros_like(ls.alpha), ls.alpha)
        eta = torch.where(is_extrap, s.eta, f.eta_ls)
        nF_add = 1 + nbk
        nc_add = (1 + nbk) if p > 0 else torch.zeros_like(nbk)
        ls_broken = f.not_descent | ls.fail
        ls_msg = torch.where(
            f.not_descent,
            torch.full_like(s.msg, 5),
            torch.where(ls.fail, torch.full_like(s.msg, 6), torch.zeros_like(s.msg)),
        )
        xt, Ft, ct, epsk = ls.xt, ls.Ft, ls.ct, f.epsk

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

        good = (ch <= 0.99 * t.combined + epsk) & (~ls_broken)
        if self.always_accept_extrapolation:
            accept = ~ls_broken
        else:
            accept = ((s.inner_iter > 0) | good) & (~ls_broken)

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
            nbk=s.nbk + nbk,
            broken=s.broken | ls_broken,
            msg=torch.where(s.msg == 0, ls_msg, s.msg),
        )
        # lanes outside ``ok`` keep the solve's state (on the lanes outside
        # ``go`` that is the carry's, bit for bit, so no select by ``go``);
        # the carry's norms: the iteration's on ``ok``, kept elsewhere, and
        # ``first`` cleared on ``go``
        s = _sel_tuple(ok, s_n, s)
        kept = _Hat(hat.normdualhat, hat.normprimalhat, hat.combined_hat,
                    torch.zeros_like(hat.first), hat.tired)
        new = _Hat(ndh, nph, ch, torch.zeros_like(hat.first), tired)
        new = _Hat(*[_sel(ok, a, b) for a, b in zip(new, kept)])
        hat = _Hat(*[_sel(t.go, a, b) for a, b in zip(new, hat)])
        go, do_solve = self._inner_go(t.active, t.combined, hat, s)
        return dict(s=s, hat=hat, go=go, do_solve=do_solve, flags=_flags(go, do_solve))

    def _seg_outer_post(self, t) -> dict:
        """The outer bookkeeping: the multiplier refit, the first-order and
        small-residual tests, and (unless a re-check follows) the status."""
        p = self.problem.ncon
        s = t.s._replace(normdual=t.hat.normdualhat, normprimal=t.hat.normprimalhat)
        if self.multiplier_refit and p > 0:
            # per-outer CGLS multiplier refit, kept only where it strictly
            # lowers the dual norm
            JcT = s.Jcx.transpose(-2, -1)
            Jxtr_f = self._rsum(_mv(s.JxT, s.r))
            lam_fit = cgls(JcT, Jxtr_f, check=t._host_reads)
            dual_fit = Jxtr_f - _mv(JcT, lam_fit)
            nd_fit = norm_inf(dual_fit)
            take = (nd_fit < s.normdual) & (~s.broken)
            s = s._replace(
                lam=_sel(take, lam_fit, s.lam),
                dual=_sel(take, dual_fit, s.dual),
                normdual=torch.where(take, nd_fit, s.normdual),
            )
        sd = self._dual_scaling(s.lam)
        first_order = torch.maximum(s.normdual / sd, s.normprimal) <= s.epstol
        small_residual = (2 * torch.sqrt(s.fx) <= s.epsF) & (norm_2(s.cx) <= s.epsc)
        s = s._replace(first_order=first_order, small_residual=small_residual)
        mask = t.active & small_residual & ~first_order
        fin = self._finish_outer(s, t)
        nxt = fin.status == Status.UNKNOWN
        return dict(s_pre=s, s=fin, mask=mask, nxt=nxt, flags=_flags(mask, nxt))

    def _finish_outer(self, s, t) -> SolverState:
        cfg = t.cfg
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
        return _sel_tuple(t.active, s._replace(iter=iter_n, status=status), t.s_in)

    def _seg_recheck_outer(self, t) -> dict:
        s = self._finish_outer(self._recheck(t.mask, t.s_pre, t._host_reads), t)
        nxt = s.status == Status.UNKNOWN
        return dict(s=s, nxt=nxt, flags=_flags(nxt))

    def _outer(self, t, rows: bool = True) -> bool:
        """One outer iteration for the lanes of ``t.nxt`` (the others keep
        their state); returns whether any lane is left to solve.  With
        ``debug_print`` (and ``rows``) it prints the iteration's rows."""
        with span("cannoles.outer"):
            run_segment(t, "outer_pre", self._seg_outer_pre)
            go, do_solve = self._check(t)
            while go:
                if do_solve:
                    run_segment(t, "solve0", self._seg_solve0, eager=self.linsolve == "eigh")
                    self._newton_system_segments(t)
                run_segment(t, "trial:solved" if do_solve else "trial", self._trial_seg(do_solve))
                while self._check(t)[0]:
                    run_segment(t, "ls", self._seg_ls)
                run_segment(t, "accept", self._seg_accept)
                go, do_solve = self._check(t)
            run_segment(t, "outer_post", self._seg_outer_post)
            re, nxt = self._check(t)
            if re:
                run_segment(t, "recheck_outer", self._seg_recheck_outer)
                nxt = self._check(t)[0]
        if self.debug_print and rows:
            self._debug_rows(t)
        return nxt

    def _debug_rows(self, t):
        """``debug_print``'s rows after an outer iteration: one per lane
        that took it, in lane order, in the JAX package's column set and
        format (its in-graph print).  The values are read on the host,
        outside ``host_syncs``; on a row mesh rank 0 prints."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        s = t.s
        lanes = torch.nonzero(t.active).flatten()
        cols = ("iter", "fx", "normdual", "normprimal", "alpha", "rho", "delta", "inner_iter", "nbk")
        for i, f, nd, np_, a, rho, dl, ii, nbk in zip(*(getattr(s, c)[lanes].tolist() for c in cols)):
            print(f"iter={i} f={f:.3e} ‖∇L‖={nd:.2e} ‖c‖={np_:.2e} α={a:.2e} "
                  f"ρ={rho:.2e} δ={dl:.2e} in_it={ii} nbk={nbk}")

    def _outer_step(self, s: SolverState, cfg: RunConfig, active) -> SolverState:
        """One outer iteration for the lanes of ``active`` as a function; the
        other lanes keep their state."""
        t = self._bank(s.x.shape[0], s.data)
        load(t, s=s, cfg=cfg, nxt=active)
        self._outer(t)
        return self._result(t.s, s.data)

    # ------------------------------------------------------------------
    # routes, banks and host checks
    # ------------------------------------------------------------------
    def _bank(self, B: int, data, own: bool = False) -> Bank:
        """The bank of a batch of B lanes with this data layout: on the
        graph route one per (B, data shapes), kept with its graphs (the
        ``MAX_BANKS`` most recently used: a rescue's B changes from call to
        call); a fresh one per call on the eager route.  ``own``: the data
        is the problem's own (``solve()``), which the bank adopts (no copy;
        its graphs read it in place), so its bank is also keyed by where
        the data lies."""
        if self.route == "eager":
            return Bank("eager", self.problem.name)
        key = (B, _layout(data))
        if own and data is not None:
            key += (tuple(x.data_ptr() for x in _leaves(data)),)
        bank = self._banks.get(key)
        if bank is None:
            bank = self._banks[key] = Bank(self.route, f"problem {self.problem.name!r} (B={B}, {self.dtype})",
                                           pool=self._pool)
            while len(self._banks) > MAX_BANKS:
                self._banks.popitem(last=False)
        self._banks.move_to_end(key)
        return bank

    def _result(self, s: SolverState, data) -> SolverState:
        """A bank's state ``s`` handed out: on the graph route a copy (the
        buffers are rewritten by the next run) that carries the caller's
        ``data``, which no segment changes, instead of a copy of it."""
        if self.route == "eager":
            return s
        return clone_tree(s._replace(data=None))._replace(data=data)

    def _check(self, t) -> list:
        """A host check: read the flags of the bank's last segment (one
        sync, counted in ``host_syncs`` and, process-wide, at
        ``check:<segment>``) and, inside ``solve()``, the wall-clock budget."""
        self.host_syncs += 1
        with span("cannoles.check", {"segment": t.last}):
            vals = t.flags.tolist()
            count_check(t.last, any(vals))
            if self._deadline is not None:
                # on a row mesh every rank leaves the step at the same check
                *vals, spent = self._agree(*vals, time.time() > self._deadline)
                if spent:
                    raise _BudgetSpent
        return vals

    def graph_replays(self) -> dict:
        """Replays per captured segment over this solver's banks (the graph
        route), summed over batch sizes."""
        out: dict = {}
        for bank in self._banks.values():
            for k, v in bank.replays().items():
                out[k] = out.get(k, 0) + v
        return out

    # ------------------------------------------------------------------
    # batched run: init, then outer steps until no lane is UNKNOWN
    # ------------------------------------------------------------------
    @scoped
    def run(self, x0, lam0, cfg: RunConfig, data=None) -> SolverState:
        """Solve a batch to the end: x0 (B, n), lam0 (B, p), data leaves
        with a leading B axis (or None).  Counterpart of the JAX
        ``_run_compiled`` under vmap."""
        with span("cannoles.run", {"B": x0.shape[0], "route": self.route}):
            t = self._bank(x0.shape[0], data)
            load(t, x0=x0.to(dtype=self.dtype, device=self.device),
                 lam0=lam0.to(dtype=self.dtype, device=self.device), cfg=cfg, data=data)
            more = self._init(t)
            while more:
                more = self._outer(t)
            return self._result(t.s, data)

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
        cfg = self.make_config(**numeric)
        stats = stats or ExecutionStats()
        stats.status = "unknown"
        data = _add_batch_axis(pb.data, self.device)
        if resume_from is None:
            x0 = pb.x0 if x0 is None else x0
            lam0 = pb.y0 if lam0 is None else lam0
            x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device).reshape(1, -1)
            lam0 = torch.as_tensor(lam0, dtype=self.dtype, device=self.device).reshape(1, -1)
        # the problem's own data, which the graph route's bank adopts
        own = resume_from is None and _views_of(data, pb.data)
        if not self._warm:
            start = resume_from if resume_from is not None else (x0, lam0, data)
            self._warm_up(start, numeric, own)
        t0 = time.time()
        given = data if resume_from is None else resume_from.data
        t = self._bank(1, given, own=own)

        if resume_from is not None:
            state = resume_from._replace(status=torch.zeros_like(resume_from.status))
            if {"atol", "rtol", "Fatol", "Frtol"} & numeric.keys():
                epstol = cfg.atol + cfg.rtol * state.normdual
                epsF = cfg.Fatol + cfg.Frtol * 2 * torch.sqrt(state.fx)
                state = state._replace(epstol=epstol, epsF=epsF, epsc=torch.sqrt(epstol))
            load(t, s=state, cfg=cfg, nxt=state.status == Status.UNKNOWN)
        else:
            load(t, x0=x0, lam0=lam0, cfg=cfg, data=data, adopt=("data",) if own else ())
            self._init(t)
        state = t.s
        self._sync_stats(state, stats, time.time() - t0)
        if verbose > 0:
            self._log_header()
        seen = self._result(state, given) if callback is not None else state
        self._between_steps(seen, stats, callback, verbose > 0, False)
        done = stats.status != "unknown"

        try:
            while not done:
                try:
                    self._outer(t)
                except _BudgetSpent:
                    # the interrupted step is dropped: its start is s_in
                    state = t.s_in
                    stats.status = status_name(Status.MAX_TIME)
                    stats.elapsed_time = time.time() - t0
                    break
                state = t.s
                elapsed = time.time() - t0
                self._sync_stats(state, stats, elapsed)
                log = verbose > 0 and stats.iter % verbose == 0
                # a callback may keep the state: on the graph route it gets a copy
                seen = self._result(state, given) if callback is not None else state
                self._between_steps(seen, stats, callback, log, elapsed > max_time)
                done = stats.status != "unknown"
                self._deadline = t0 + max_time
        finally:
            self._deadline = None

        state = self._result(state, given)
        self._finalize_stats(state, stats)
        self.last_state = state
        pb.counters.neval_residual += int(state.neval_F[0])
        pb.counters.neval_cons += int(state.neval_c[0])
        return stats

    def _warm_up(self, start, numeric, own=False):
        """The one-time costs of a solver, paid before ``solve()`` starts its
        clock (the counterpart of the JAX package's ``_outer_warm``): init
        and one outer step of at most two inner iterations from ``start``
        ((x0, lam0, data) or a state to resume), on a bank whose results are
        dropped.  It imports what the evaluators import lazily, builds the
        kernels and, on the graph route, captures the segments it runs.  The
        host checks and kernel launches it makes are not counted."""
        syncs, launches = self.host_syncs, counters()
        try:
            cfg = self.make_config(**{**numeric, "max_inner": 1})
            if isinstance(start, SolverState):
                t = self._bank(1, start.data)
                load(t, s=start, cfg=cfg)
            else:
                x0, lam0, data = start
                t = self._bank(1, data, own=own)
                load(t, x0=x0, lam0=lam0, cfg=cfg, data=data, adopt=("data",) if own else ())
                self._init(t)
            load(t, nxt=torch.ones_like(t.s.broken))
            self._outer(t, rows=False)
        finally:
            self.host_syncs = syncs
            restore_counters(launches)
        self._warm = True

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


def _views_of(a, b) -> bool:
    """Whether every leaf of the pytree ``a`` is a tensor that lies in the
    storage of the matching tensor leaf of ``b`` (``_add_batch_axis`` made
    no copy)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_views_of(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(_views_of(x, y) for x, y in zip(a, b))
    return a is None and b is None


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
