"""Camera-Schur bundle-adjustment solver: direct landmark elimination.

Port of ``cannoles_tpu/core/ba.py``.  For a scene of C cameras and P
landmarks on a (C, P) observation grid (full, or masked by ``data["vis"]``)
the condensed Gauss–Newton system

    (ρ I + JᵀJ + JcᵀJc/δ) z = b,    x = [cams (C, 6); pts (P, 3)]

has the arrowhead structure [[U + Dc, W], [Wᵀ, V]]: U (C, 6, 6) and
V (P, 3, 3) block-diagonal, W (C, P, 6, 3) the coupling.  The landmarks are
eliminated with P closed-form 3×3 adjugate inverses, the reduced camera
system S = U + Dc − Σₚ W Vₚ⁻¹ Wᵀ (6C × 6C) is factored with
``torch.linalg.cholesky`` (the counterpart of the XLA Cholesky the JAX
package calls) and back-substitution recovers the landmark step.  The
per-observation Jacobian blocks come from ``torch.func.jacfwd`` vmapped
over the grid; no (m, n) Jacobian is formed.

An attempt succeeds when every landmark block is positive definite
(Sylvester minors), the Jacobi-scaled S has a finite Cholesky factor with
every pivot above ``eig_tol``, and, after one pass of iterative refinement,
the step's relative residual on the exact operator is at most
η = max(10·cg_rtol, 0.1).  Everything else, the outer loop, the ρ ladder
and the statuses, is :class:`~cannoles_tpu_torch.core.matfree.MatrixFreeSolver`'s.

On an observation list (``data["cam_idx"]``, ``data["pt_idx"]``, the
residual the raveled (n_obs, 2) reprojections, as
:func:`cannoles_tpu_torch.models.bal.bal_problem` builds it) no grid is
formed: cameras of cd = 6 or 9 parameters (read from the layout),
per-observation blocks A (n_obs, 2, cd), Bm (n_obs, 2, 3) and
W = AᵀBm (n_obs, cd, 3) (``ops/obs_blocks.py``: one kernel launch on a card
with Snavely's camera, ``jacfwd`` and an einsum otherwise), U and V summed
over each camera's and each point's observations, and
S = blockdiag(U) + Dc − Σₚ Σ_{i,j ∈ obs(p)}
X_i W_jᵀ summed over the pairs of observations that share a point
(``ops/schur_pairs.py``: the pairs listed once per observation structure,
each lower-triangle block summed by one kernel launch on a card), then
mirrored.  The back-substitution runs by the same sums, and so do the
solver's products: J v = A v_c[cam_idx] + Bm v_p[pt_idx] and Jᵀw by the
segment sums of Aᵀw and Bmᵀw, from the blocks at x, which every product
and the assembly at one iterate share (:class:`_ListProducts`).  Every
product over observations (J v, Jᵀw, U and V, the back-substitution's
two sums) is one call of ``ops/obs_products.py``: one kernel launch on a
card, its plain version (einsums and ``schur_pairs.segment_sum``) on the
CPU.  Every sum over observations runs in a fixed order, so a solve
repeats bit for bit on a card.

Spans ``cannoles.schur.blocks``, ``.assemble``, ``.factor``, ``.solve``
and the counts ``("schur", "assemble" | "pairs")`` (``utils/spans.py``)
cover both routes.

Tensors keep the port's leading batch axis (a solve is B = 1); every
einsum carries it as ``b``.  On a list every lane shares lane 0's
observation structure.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import jacfwd, vjp, vmap

from ..ops import obs_blocks, obs_products, schur_pairs
from ..params import Params
from ..problem import NLSProblem
from ..utils.linalg import norm_2
from ..utils.spans import count, span
from .matfree import MatrixFreeSolver, MFState
from .solver import _add_batch_axis, _cholesky_nan

__all__ = ["SchurBASolver", "inv3x3_sym", "ba_block_jacobi"]


def _project_default(cd: int = 6):
    """The projection of cameras of ``cd`` parameters: the pinhole model of
    ``models/ba_large.py`` (6) or Snavely's of ``models/bal.py`` (9)."""
    if cd == 9:
        from ..models.bal import snavely_project

        return snavely_project
    from ..models.ba_large import project_point

    return project_point


def _obs_blocks(project, x, C: int, P: int):
    """Per-observation Jacobian blocks of ``project`` at x (B, 6C + 3P):
    A = ∂u/∂cam (B, C, P, 2, 6) and Bm = ∂u/∂pt (B, C, P, 2, 3)."""
    Bt = x.shape[0]
    cams = x[:, : 6 * C].reshape(Bt, C, 6)
    pts = x[:, 6 * C:].reshape(Bt, P, 3)

    def jac_one(cam, pt):
        A = jacfwd(lambda cc: project(cc, pt))(cam)
        Bm = jacfwd(lambda pp: project(cam, pp))(pt)
        return A, Bm

    grid = vmap(vmap(vmap(jac_one, in_dims=(None, 0)), in_dims=(0, None)), in_dims=(0, 0))
    A, Bm = grid(cams, pts)
    return A.to(x.dtype), Bm.to(x.dtype)


class _ListProducts:
    """The list route's view of a problem: its products from the
    per-observation blocks at x, everything else the problem's.

    J v = A v_c[cam_idx] + Bm v_p[pt_idx], Jᵀw = (Σ_{obs of c} Aᵀw,
    Σ_{obs of p} Bmᵀw) (``ops/obs_products.py``), Jc v and Jcᵀw from the
    constraints' Jacobian on the camera block.  The blocks A (masked by
    ``solver``'s frozen coordinates), Bm and W = AᵀBm (``ops/obs_blocks.py``)
    and Jc are worked out once per iterate and kept for the last ``KEEP``
    iterates (held, so compared by identity), so the Schur assembly and
    every product at one x share one forward pass."""

    KEEP = 2

    def __init__(self, problem: NLSProblem, solver: "SchurBASolver"):
        self._pb, self._solver, self._kept = problem, solver, []

    def __getattr__(self, name):
        if name in ("_pb", "_solver", "_kept"):
            raise AttributeError(name)
        return getattr(self._pb, name)

    def _at(self, x, data) -> dict:
        for x_k, version, got in self._kept:
            if x_k is x and version == x._version:
                return got
        sv = self._solver
        _, sl = sv._structure(data)
        A, Bm, W = obs_blocks.blocks(sv.project, x, sl, sv.cd, sv._cam_mask)
        got = dict(A=A, Bm=Bm, W=W, sl=sl)
        self._kept = [(x, x._version, got)] + self._kept[: self.KEEP - 1]
        return got

    def blocks(self, x, data):
        """(A (B, n_obs, 2, cd), Bm (B, n_obs, 2, 3)) at x."""
        got = self._at(x, data)
        return got["A"], got["Bm"]

    def cons_jacobian(self, x, data):
        """Jc (B, p, cd·C) at x: the camera block's columns."""
        got = self._at(x, data)
        if "Jc" not in got:
            got["Jc"] = _cons_jacobian(self._pb, x, data)[:, :, : self._solver.cd * self._solver.C]
        return got["Jc"]

    def jprod_res(self, x, v, data=None):
        got = self._at(x, data)
        return obs_products.jv(got["A"], got["Bm"], v, got["sl"])

    def jtprod_res(self, x, w, data=None):
        got = self._at(x, data)
        return obs_products.jtw(got["A"], got["Bm"], w, got["sl"])

    def jprod_cons(self, x, v, data=None):
        Jc = self.cons_jacobian(x, data)
        return torch.einsum("bkn,bn->bk", Jc, v[:, : Jc.shape[-1]])

    def jtprod_cons(self, x, w, data=None):
        Jc = self.cons_jacobian(x, data)
        return torch.cat([torch.einsum("bkn,bk->bn", Jc, w), w.new_zeros((w.shape[0], x.shape[1] - Jc.shape[-1]))], -1)


def _cons_jacobian(pb: NLSProblem, x, data):
    """Jc (B, p, n) by reverse mode, p pullbacks of the constraints: at
    n = 30,600 forward mode would push an n × n tangent basis through
    them."""
    _, pull = vjp(lambda z: pb.c_shifted(z, data), x)
    eye = torch.eye(pb.ncon, dtype=x.dtype, device=x.device)
    basis = eye[:, None, :].expand(pb.ncon, x.shape[0], pb.ncon)
    return vmap(lambda w: pull(w)[0])(basis).transpose(0, 1)


def _masked(A, Bm, data):
    vis = data.get("vis") if isinstance(data, dict) else None
    if vis is not None:
        m = vis.to(A.dtype)[..., None, None]
        A, Bm = A * m, Bm * m
    return A, Bm


def _diag(M):
    return torch.diagonal(M, dim1=-2, dim2=-1)


def _jacobi_scaled_inv3(V, tol):
    """Closed-form inverses of the Jacobi-scaled 3×3 blocks D^-½ V D^-½
    (unit diagonal), scaled back; returns (V⁻¹, posdef)."""
    sV = torch.rsqrt(torch.clamp(_diag(V), min=1e-30))
    Vsinv, pos = inv3x3_sym(V * sV[..., :, None] * sV[..., None, :], tol)
    return Vsinv * sV[..., :, None] * sV[..., None, :], pos


def ba_block_jacobi(n_cams: int, n_pts: int, project: Optional[Callable] = None):
    """Block-Jacobi preconditioner factory for ``MatrixFreeSolver(precond=...)``
    on BA problems: M = blockdiag(U_c + ρI, V_p + ρI), the per-camera 6×6
    and per-landmark 3×3 Gauss–Newton blocks.  Each application is a
    batched 3×3 adjugate inverse and a batched 6×6 Cholesky solve.

    Assumes the layout ``x = [cams (C, 6); pts (P, 3)]`` with the residual
    the raveled (C, P, 2) grid of ``project`` (masked by ``data["vis"]``
    where given); checked against the problem's dimensions when built."""
    C, P = int(n_cams), int(n_pts)
    if project is None:
        project = _project_default()

    def factory(problem, x, data, rho, delta):
        if problem.nvar != 6 * C + 3 * P or problem.nequ != 2 * C * P:
            raise ValueError(
                f"ba_block_jacobi({C}, {P}) expects the BA layout "
                f"nvar=6C+3P={6*C+3*P}, nequ=2CP={2*C*P}; got "
                f"nvar={problem.nvar}, nequ={problem.nequ} — the residual "
                "must be the (possibly vis-masked) raveled (C, P, 2) "
                "reprojection grid"
            )
        Bt = x.shape[0]
        dt, dev = x.dtype, x.device
        rho = torch.as_tensor(rho, dtype=dt, device=dev).reshape(-1)
        A, Bm = _masked(*_obs_blocks(project, x, C, P), data)
        eye6 = torch.eye(6, dtype=dt, device=dev)
        eye3 = torch.eye(3, dtype=dt, device=dev)
        U = torch.einsum("bcpki,bcpkj->bcij", A, A) + rho[:, None, None, None] * eye6
        V = torch.einsum("bcpki,bcpkj->bpij", Bm, Bm) + rho[:, None, None, None] * eye3
        Vinv, posV = _jacobi_scaled_inv3(V, 0.0)
        # a tiny floor keeps M SPD where ρ = 0 and a camera block is singular
        floor = 1e-10 * torch.clamp(_diag(U).flatten(1).amax(-1), min=1.0)
        Lu = _cholesky_nan((U + floor[:, None, None, None] * eye6).reshape(-1, 6, 6)).reshape(Bt, C, 6, 6)
        ok_u = torch.isfinite(Lu).flatten(1).all(-1)

        def minv(r):
            rc = r[:, : 6 * C].reshape(Bt, C, 6)
            rp = r[:, 6 * C:].reshape(Bt, P, 3)
            zc = torch.cholesky_solve(rc[..., None], Lu)[..., 0]
            zc = torch.where(ok_u[:, None, None], zc, rc)  # identity where U broke
            zp = torch.where(posV[..., None], torch.einsum("bpij,bpj->bpi", Vinv, rp), rp)
            return torch.cat([zc.reshape(Bt, -1), zp.reshape(Bt, -1)], -1)

        return minv

    return factory


def inv3x3_sym(V: torch.Tensor, tol: float):
    """Closed-form inverse of symmetric (..., 3, 3) blocks via adjugates.

    Returns (Vinv, posdef), posdef the per-block Sylvester test (the three
    leading principal minors above tol-scaled bounds).  A block that fails
    it gets a zero inverse."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    cof00 = d * f - e * e
    cof01 = c * e - b * f
    cof02 = b * e - c * d
    det2 = a * d - b * b
    det3 = a * cof00 + b * cof01 + c * cof02
    posdef = (a > tol) & (det2 > tol * a) & (det3 > tol * det2)
    inv_det = torch.where(posdef, 1.0 / torch.where(posdef, det3, torch.ones_like(det3)),
                          torch.zeros_like(det3))
    i11 = a * f - c * c
    i12 = b * c - a * e
    i22 = a * d - b * b
    row0 = torch.stack([cof00, cof01, cof02], -1)
    row1 = torch.stack([cof01, i11, i12], -1)
    row2 = torch.stack([cof02, i12, i22], -1)
    return torch.stack([row0, row1, row2], -2) * inv_det[..., None, None], posdef


class SchurBASolver(MatrixFreeSolver):
    """Gauss–Newton/LM bundle-adjustment solver with direct camera-Schur
    landmark elimination.

    ``problem``: the BA problem, layout ``[cams (C, cd); pts (P, 3)]``.  On
    the grid route the residual is the raveled (C, P, 2) reprojection grid
    (cd = 6; build it with
    :func:`cannoles_tpu_torch.models.ba_large.large_bundle_adjustment`); on
    the list route ``problem.data`` holds ``cam_idx`` and ``pt_idx``
    (n_obs,) and the residual is the raveled (n_obs, 2) reprojections, cd = 6
    or 9 read from the layout (build it with
    :func:`cannoles_tpu_torch.models.bal.bal_problem`).  ``n_cams``,
    ``n_pts``: C and P.  ``project``: the per-observation projection
    ``(cam (cd,), pt (3,)) -> (2,)`` (default: the pinhole model of
    ``models/ba_large.py`` for cd = 6, Snavely's of ``models/bal.py`` for
    cd = 9).  Constraints may touch only the camera block (gauge fixing).
    ``frozen_cam_coords``: camera coordinates the residual freezes
    (``gauge='fixed'``); their Jacobian columns are masked to zero.
    On a list the solver's ``problem`` is the given problem with its
    products taken from the blocks (:class:`_ListProducts`)."""

    def __init__(
        self,
        problem: NLSProblem,
        n_cams: int,
        n_pts: int,
        *,
        project: Optional[Callable] = None,
        method: str = "gauss_newton",
        frozen_cam_coords=None,
        params: Optional[Params] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
        **solver_kw,
    ):
        super().__init__(problem, method=method, params=params, dtype=dtype, device=device, **solver_kw)
        self.C, self.P = int(n_cams), int(n_pts)
        data = problem.data
        self.listed = isinstance(data, dict) and "cam_idx" in data and "pt_idx" in data
        if self.listed:
            cd, rest = divmod(problem.nvar - 3 * self.P, self.C)
            if rest or cd not in (6, 9):
                raise ValueError(f"nvar={problem.nvar} is not cd*{n_cams} + 3*{n_pts} with 6 or 9 "
                                 "parameters a camera — not the BA layout")
            n_obs = int(data["cam_idx"].shape[0])
            if problem.nequ != 2 * n_obs or tuple(data["pt_idx"].shape) != (n_obs,):
                raise ValueError(f"nequ={problem.nequ} != 2*n_obs={2 * n_obs} — residual must be the "
                                 "raveled (n_obs, 2) reprojections of the observation list")
        else:
            cd = 6
            if problem.nvar != 6 * self.C + 3 * self.P:
                raise ValueError(f"nvar={problem.nvar} != 6*{n_cams} + 3*{n_pts} — not the BA layout")
            if problem.nequ != 2 * self.C * self.P:
                raise ValueError(
                    f"nequ={problem.nequ} != 2*C*P — residual must be the "
                    "(possibly vis-masked) raveled (C, P, 2) grid"
                )
        self.cd = cd
        self.project = _project_default(cd) if project is None else project
        self._plan = None  # (structure key, PairPlan, SegmentLists) of the last list seen
        if frozen_cam_coords is not None:
            idx = np.asarray(frozen_cam_coords, dtype=np.int64)
            if idx.size and (idx.min() < 0 or idx.max() >= cd * self.C):
                raise ValueError("frozen_cam_coords must index the camera block")
            mask = np.ones(cd * self.C, dtype=np.float64)
            mask[idx] = 0.0
            self._cam_mask = torch.as_tensor(mask.reshape(self.C, cd), dtype=self.dtype, device=self.device)
        else:
            self._cam_mask = None
        if problem.ncon > 0:
            # gauge constraints must not touch landmarks: checked once at x0
            x0 = problem.x0.to(dtype=self.dtype, device=self.device).reshape(1, -1)
            Jc = _cons_jacobian(problem, x0, _add_batch_axis(problem.data, self.device))[0]
            if float(Jc[:, cd * self.C:].abs().max()) > 0:
                raise ValueError(
                    "SchurBASolver requires constraints on the camera block "
                    "only (gauge fixing); found landmark dependence"
                )
        if self.listed:
            self.problem = _ListProducts(problem, self)

    def _structure(self, data):
        """(PairPlan, SegmentLists) of lane 0's observation list, both built
        once per structure (the lists keep the index tensors, so that their
        storage, which keys the plan, stays theirs)."""
        ci, pi = data["cam_idx"][0], data["pt_idx"][0]
        key = (ci.untyped_storage().data_ptr(), ci.storage_offset(), pi.untyped_storage().data_ptr(),
               pi.storage_offset(), ci.shape[0], ci.device)
        if self._plan is None or self._plan[0] != key:
            self._plan = (key, schur_pairs.plan(ci, pi, self.C), obs_products.lists(ci, pi, self.C, self.P))
        return self._plan[1:]

    def _blocks(self, x, data):
        """The ρ-free blocks, shared by every attempt of one ρ ladder: on the
        grid U₀ (B, C, 6, 6), V₀ (B, P, 3, 3) and W (B, C, P, 6, 3); on a list
        U₀ (B, C, cd, cd), V₀ and W (B, n_obs, cd, 3)."""
        if self.listed:
            got = self.problem._at(x, data)
            U, V = obs_products.uv(got["A"], got["Bm"], got["sl"])
            return U, V, got["W"]
        A, Bm = _masked(*_obs_blocks(self.project, x, self.C, self.P), data)
        if self._cam_mask is not None:
            A = A * self._cam_mask[:, None, None, :]
        U = torch.einsum("bcpki,bcpkj->bcij", A, A)
        V = torch.einsum("bcpki,bcpkj->bpij", Bm, Bm)
        W = torch.einsum("bcpki,bcpkj->bcpij", A, Bm)
        return U, V, W

    def _precompute(self, s: MFState):
        pb = self.problem
        with span("cannoles.schur.blocks"):
            U0, V0, W = self._blocks(s.x, s.data)
            bx = self._rhs(s)
            Dc = None
            if pb.ncon > 0:
                Jc = (pb.cons_jacobian(s.x, s.data) if self.listed
                      else _cons_jacobian(pb, s.x, s.data)[:, :, : self.cd * self.C])
                Dc = torch.einsum("bki,bkj->bij", Jc, Jc) / s.delta[:, None, None]
        return U0, V0, W, bx, Dc

    def _newton_system(self, s: MFState, act):
        """The parent's ρ ladder with the ρ-free blocks built once.  With
        frozen gauge coordinates S is singular at ρ = 0, so the ladder
        starts at its first regularized rung."""
        pre = []

        def attempt(rho, do):
            if not pre:
                pre.append(self._precompute(s))
            return self._solve_with_blocks(s, rho, pre[0])

        return self._ladder(s, act, attempt, 1 if self._cam_mask is not None else 0)

    def _solve_condensed(self, s: MFState, rho, active=None):
        """One Schur solve at ``rho`` (the parent's single-attempt API)."""
        return self._solve_with_blocks(s, rho, self._precompute(s))

    def _grid_system(self, U, Vinv, W, Dc):
        """X = W V⁻¹ and S = blockdiag(U) + Dc − Σₚ X Wᵀ on the grid, with the
        sums of the back-substitution: (S, Σ_p X b_p by camera, Σ_c Wᵀ z_c by
        point)."""
        Bt, C, cd = U.shape[0], self.C, self.cd
        X = torch.einsum("bcpij,bpjk->bcpik", W, Vinv)
        T = torch.einsum("bcpik,bdpjk->bcidj", X, W)
        Ublk = torch.einsum("bcij,cd->bcidj", U, torch.eye(C, dtype=U.dtype, device=U.device))
        S = (Ublk - T).reshape(Bt, cd * C, cd * C)
        if Dc is not None:
            S = S + Dc

        def reduce(bp):
            return torch.einsum("bcpij,bpj->bci", X, bp)

        def lift(zc):
            return torch.einsum("bcpij,bci->bpj", W, zc)

        return S, reduce, lift

    def _list_system(self, U, Vinv, W, Dc, data):
        """The list route's (S, reduce, lift) of :meth:`_grid_system`: X per
        observation, the pairs' blocks from ``ops.schur_pairs.accumulate``
        placed in the lower triangle with blockdiag(U), then mirrored."""
        pp, sl = self._structure(data)
        Bt, C, cd = U.shape[0], self.C, self.cd
        X = torch.einsum("boij,bojk->boik", W, Vinv[:, sl.pt_idx])
        M = U.new_zeros((Bt, C, cd, C, cd))
        diag = torch.arange(C, device=U.device)
        for b in range(Bt):
            T = schur_pairs.accumulate(X[b].contiguous(), W[b].contiguous(), pp)
            M[b][pp.block_cam[:, 0], :, pp.block_cam[:, 1], :] = -T
            M[b][diag, :, diag, :] += U[b]
        count(("schur", "pairs"), Bt * pp.n_pairs)
        Ml = M.reshape(Bt, cd * C, cd * C)
        S = torch.tril(Ml) + torch.tril(Ml, -1).mT
        if Dc is not None:
            S = S + Dc

        def reduce(bp):
            return obs_products.reduce(X, bp, sl)

        def lift(zc):
            return obs_products.lift(W, zc, sl)

        return S, reduce, lift

    def _solve_with_blocks(self, s: MFState, rho, pre):
        """Direct Schur solve of (ρ I + JᵀJ + JcᵀJc/δ) z = b from the
        precomputed blocks; returns (zx, ok, 1 per lane)."""
        pb, pr = self.problem, self.params
        C, P, cd = self.C, self.P, self.cd
        x, data = s.x, s.data
        Bt = x.shape[0]
        dt, dev = x.dtype, x.device
        rho = torch.as_tensor(rho, dtype=dt, device=dev).reshape(-1).expand(Bt)
        if self.method == "lm":
            rho = rho + torch.clamp(s.damp, 1e-10, 1e8)
        U0, V0, W, bx, Dc = pre
        bc = bx[:, : cd * C].reshape(Bt, C, cd)
        bp = bx[:, cd * C:].reshape(Bt, P, 3)

        with span("cannoles.schur.assemble"):
            U = U0 + rho[:, None, None, None] * torch.eye(cd, dtype=dt, device=dev)
            V = V0 + rho[:, None, None, None] * torch.eye(3, dtype=dt, device=dev)
            # landmark elimination, Jacobi-scaled (f32 blocks span ~8 orders
            # across depth; scaling keeps the small pivots and makes the minors
            # test scale-relative)
            Vinv, posdef = _jacobi_scaled_inv3(V, pr.eig_tol)
            # reduced camera system S = blockdiag(U) + Dc − Σₚ X Wᵀ, (cd·C, cd·C)
            S, reduce, lift = (self._list_system(U, Vinv, W, Dc, data) if self.listed
                               else self._grid_system(U, Vinv, W, Dc))
            count(("schur", "assemble"), Bt)

        with span("cannoles.schur.factor"):
            # Jacobi-scaled camera system: unit diagonal before the Cholesky
            sS = torch.rsqrt(torch.clamp(_diag(S), min=1e-30))
            Ls = _cholesky_nan(S * sS[:, :, None] * sS[:, None, :])
            dls = _diag(Ls)
            okS = torch.isfinite(Ls).flatten(1).all(-1) & (dls * dls > pr.eig_tol).all(-1)

        def schur_solve(bcv, bpv):
            rcv = (bcv - reduce(bpv)).reshape(Bt, cd * C)
            zcv = (sS * torch.cholesky_solve((sS * rcv)[..., None], Ls)[..., 0]).reshape(Bt, C, cd)
            zpv = torch.einsum("bpij,bpj->bpi", Vinv, bpv - lift(zcv))
            return torch.cat([zcv.reshape(Bt, -1), zpv.reshape(Bt, -1)], -1)

        def matvec(v):
            out = rho[:, None] * v + pb.jtprod_res(x, pb.jprod_res(x, v, data), data)
            if pb.ncon > 0:
                out = out + pb.jtprod_cons(x, pb.jprod_cons(x, v, data), data) / s.delta[:, None]
            return out

        def split(v):
            return v[:, : cd * C].reshape(Bt, C, cd), v[:, cd * C:].reshape(Bt, P, 3)

        with span("cannoles.schur.solve"):
            zx = schur_solve(bc, bp)
            # one pass of operator-level iterative refinement (the adjugate
            # inverses and the float32 einsum chain lose 3-4 digits)
            zx = zx + schur_solve(*split(bx - matvec(zx)))
            # backward-error gate at the inexact-Newton forcing bound
            nb2 = norm_2(bx)
            relres = norm_2(bx - matvec(zx)) / torch.where(nb2 > 0, nb2, torch.ones_like(nb2))
            eta = max(self.cg_rtol * 10, 0.1)
            ok = posdef.all(-1) & okS & torch.isfinite(zx).all(-1) & (relres <= eta)
        return zx, ok, torch.ones((Bt,), dtype=torch.int32, device=dev)
