"""The products over observations of the camera-Schur engine's list route:
the CUDA kernel and its plain version.

On an observation list (``core/ba.py``) every product that runs over the
1.26M observations of a scene like BAL Dubrovnik-356 is one of five kinds,
with A (B, n_obs, 2, cd), Bm (B, n_obs, 2, 3) the per-observation Jacobian
blocks, X and W (B, n_obs, cd, 3) the Schur engine's, and c_o, p_o the
camera and point of observation o:

* ``jv``: J v, (A_o v_c[c_o] + Bm_o v_p[p_o]) for every o, (B, 2·n_obs);
* ``jtw``: Jᵀw, [Σ_{o∈obs(c)} A_oᵀ w_o; Σ_{o∈obs(p)} Bm_oᵀ w_o], (B, cd·C + 3P);
* ``reduce``: Σ_{o∈obs(c)} X_o b[p_o], (B, C, cd);
* ``lift``: Σ_{o∈obs(p)} W_oᵀ z[c_o], (B, P, 3);
* ``uv``: U_c = Σ_{o∈obs(c)} A_oᵀ A_o (B, C, cd, cd) and V_p = Σ_{o∈obs(p)}
  Bm_oᵀ Bm_o (B, P, 3, 3).

:func:`lists` builds, once per observation structure, the CSR lists of each
camera's and each point's observations in ascending order (the order in
which ``schur_pairs.segment_sum`` adds them).

No TPU kernel is replaced: the JAX package has no observation-list route.
On a card each call is one launch of ``csrc/obs_products.cu``, which forms
every per-observation product in registers and sums each camera's and each
point's in an order fixed by the lists, with no float atomics, so a solve
repeats bit for bit; the design note is at the top of that file.  On the
CPU each kind runs its plain version, the einsums and segment sums the list
route used before the kernel (``plain_*``), so the CPU's bits are theirs.
The blocks are read by their strides (a forward-mode Jacobian's views, as
they come); the vectors are made contiguous.  The library is built at the
first launch, not with the other kernels (``ops/_native.py``
``library``).

Counters (``core.segments.counters()``): ``"obs_products"`` the kernel's
launches that succeeded, ``("obs_products", kind)`` the list route's
product calls of each kind on any device.  A card's
call is one launch, so on a card the engagement, launches over calls, is 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import spans
from . import schur_pairs

__all__ = ["SegmentLists", "lists", "jv", "jtw", "reduce", "lift", "uv", "plain_jv", "plain_jtw", "plain_reduce",
           "plain_lift", "plain_uv", "KINDS"]

KINDS = ("jv", "jtw", "reduce", "lift", "uv")
spans.declare("obs_products", *(("obs_products", k) for k in KINDS))
# the kernel's grid takes the lanes as its y
_MAX_LANES = 65_535


class SegmentLists(NamedTuple):
    """Each camera's and each point's observations of one observation list."""

    cam_idx: torch.Tensor  # (n_obs,) as given: the plain version's index
    pt_idx: torch.Tensor  # (n_obs,) as given
    cam: torch.Tensor  # (n_obs,) int32
    pt: torch.Tensor  # (n_obs,) int32
    cam_order: torch.Tensor  # (n_obs,) int32: observations by camera, ascending within one
    cam_start: torch.Tensor  # (n_cams + 1,) int32
    pt_order: torch.Tensor  # (n_obs,) int32: observations by point, ascending within one
    pt_start: torch.Tensor  # (n_pts + 1,) int32
    n_cams: int
    n_pts: int

    @property
    def n_obs(self) -> int:
        return int(self.cam.shape[0])


def _csr(index: torch.Tensor, n: int):
    order = torch.argsort(index, stable=True)
    start = torch.cat([index.new_zeros(1), torch.cumsum(torch.bincount(index, minlength=n), 0)])
    return order.to(torch.int32), start.to(torch.int32)


def lists(cam_idx: torch.Tensor, pt_idx: torch.Tensor, n_cams: int, n_pts: int) -> SegmentLists:
    """The CSR lists of the observations (``cam_idx``, ``pt_idx``), on their
    device."""
    n_obs = int(cam_idx.shape[0])
    if n_obs >= 1 << 31:
        raise ValueError(f"{n_obs} observations: the lists are 32-bit")
    cam_order, cam_start = _csr(cam_idx, int(n_cams))
    pt_order, pt_start = _csr(pt_idx, int(n_pts))
    return SegmentLists(cam_idx, pt_idx, cam_idx.to(torch.int32), pt_idx.to(torch.int32), cam_order, cam_start,
                        pt_order, pt_start, int(n_cams), int(n_pts))


def _seg(values, index, n: int):
    """``schur_pairs.segment_sum`` over axis 1 of (B, k, ...): (B, n, ...)."""
    return schur_pairs.segment_sum(values.transpose(0, 1), index, n).transpose(0, 1)


def plain_jv(A, Bm, v, sl: SegmentLists):
    """J v (B, 2·n_obs) of v (B, cd·C + 3P)."""
    cd, C, P = A.shape[-1], sl.n_cams, sl.n_pts
    vc = v[:, : cd * C].reshape(v.shape[0], C, cd)[:, sl.cam_idx]
    vp = v[:, cd * C:].reshape(v.shape[0], P, 3)[:, sl.pt_idx]
    Jv = torch.einsum("boki,boi->bok", A, vc) + torch.einsum("boki,boi->bok", Bm, vp)
    return Jv.reshape(v.shape[0], -1)


def plain_jtw(A, Bm, w, sl: SegmentLists):
    """Jᵀw (B, cd·C + 3P) of w (B, 2·n_obs)."""
    w = w.reshape(w.shape[0], -1, 2)
    gc = _seg(torch.einsum("boki,bok->boi", A, w), sl.cam_idx, sl.n_cams)
    gp = _seg(torch.einsum("boki,bok->boi", Bm, w), sl.pt_idx, sl.n_pts)
    return torch.cat([gc.reshape(w.shape[0], -1), gp.reshape(w.shape[0], -1)], -1)


def plain_reduce(X, bp, sl: SegmentLists):
    """Σ_{o∈obs(c)} X_o b[p_o] (B, C, cd) of b (B, P, 3)."""
    return _seg((X * bp[:, sl.pt_idx][:, :, None, :]).sum(-1), sl.cam_idx, sl.n_cams)


def plain_lift(W, zc, sl: SegmentLists):
    """Σ_{o∈obs(p)} W_oᵀ z[c_o] (B, P, 3) of z (B, C, cd)."""
    return _seg((W * zc[:, sl.cam_idx][..., None]).sum(-2), sl.pt_idx, sl.n_pts)


def plain_uv(A, Bm, sl: SegmentLists):
    """(U (B, C, cd, cd), V (B, P, 3, 3))."""
    U = _seg(torch.einsum("boki,bokj->boij", A, A), sl.cam_idx, sl.n_cams)
    V = _seg(torch.einsum("boki,bokj->boij", Bm, Bm), sl.pt_idx, sl.n_pts)
    return U, V


@functools.lru_cache(maxsize=None)
def _function(dtype):
    from . import _native

    lib = _native.library("obs_products.cu")
    return _native.function(lib, f"cannoles_obs_products_{'f32' if dtype == torch.float32 else 'f64'}",
                            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 13)


def _check_blocks(name, M, lanes, sl, rows, cols, dtype):
    if M.dtype != dtype:
        raise TypeError(f"obs_products takes blocks of one dtype, float32 or float64; {name} is {M.dtype}")
    if tuple(M.shape) != (lanes, sl.n_obs, rows, cols):
        raise ValueError(f"obs_products: {name} must be {(lanes, sl.n_obs, rows, cols)}; got {tuple(M.shape)}")


def _launch(kind: str, m1, m2, vec, out1, out2, sl: SegmentLists):
    """One launch of kind ``kind`` on the card (``m1``'s device): raises if
    the inputs are not what the kernel takes or the launch is refused."""
    dtype, dev, lanes = m1.dtype, m1.device, m1.shape[0]
    cd = m1.shape[-1] if kind in ("jv", "jtw", "uv") else m1.shape[-2]
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"obs_products takes float32 or float64; got {dtype}")
    if cd not in (6, 9):
        raise ValueError(f"obs_products takes cameras of 6 or 9 parameters; got {cd}")
    if not 1 <= lanes <= _MAX_LANES:
        raise ValueError(f"obs_products takes 1 to {_MAX_LANES} lanes; got {lanes}")
    idx = (sl.cam, sl.pt, sl.cam_order, sl.cam_start, sl.pt_order, sl.pt_start)
    for t in (m1, m2, vec, out1, out2, *idx):
        if t is not None and t.device != dev:
            raise ValueError("obs_products takes its blocks, vectors and lists on one device")
    if vec is not None and vec.dtype != dtype:
        raise TypeError(f"obs_products takes vectors of the blocks' dtype {dtype}; got {vec.dtype}")
    m2_ = m1 if m2 is None else m2
    strides = (ctypes.c_longlong * 11)(*m1.stride(), *m2_.stride(), vec.stride(0) if vec is not None else 0,
                                       out1.stride(0), out2.stride(0) if out2 is not None else 0)
    rc = _function(dtype)(KINDS.index(kind), cd, lanes, sl.n_obs, sl.n_cams, sl.n_pts,
                          *(t.data_ptr() for t in idx), m1.data_ptr(), m2_.data_ptr(),
                          vec.data_ptr() if vec is not None else None, out1.data_ptr(),
                          out2.data_ptr() if out2 is not None else None, ctypes.addressof(strides),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"obs_products launch failed (code {rc}): {kind} at {sl.n_obs} observations, cd = {cd}, "
                           f"{lanes} lanes")
    spans.count("obs_products")


def jv(A, Bm, v, sl: SegmentLists):
    """J v (B, 2·n_obs) of v (B, cd·C + 3P): the plain version on the CPU,
    one launch on a card."""
    spans.count(("obs_products", "jv"))
    if A.device.type == "cpu":
        return plain_jv(A, Bm, v, sl)
    lanes, cd = A.shape[0], A.shape[-1]
    _check_blocks("A", A, lanes, sl, 2, cd, A.dtype)
    _check_blocks("Bm", Bm, lanes, sl, 2, 3, A.dtype)
    v = v.contiguous()
    if tuple(v.shape) != (lanes, cd * sl.n_cams + 3 * sl.n_pts):
        raise ValueError(f"obs_products.jv: v must be {(lanes, cd * sl.n_cams + 3 * sl.n_pts)}; got {tuple(v.shape)}")
    out = torch.empty((lanes, 2 * sl.n_obs), dtype=A.dtype, device=A.device)
    _launch("jv", A, Bm, v, out, None, sl)
    return out


def jtw(A, Bm, w, sl: SegmentLists):
    """Jᵀw (B, cd·C + 3P) of w (B, 2·n_obs): the plain version on the CPU,
    one launch on a card."""
    spans.count(("obs_products", "jtw"))
    if A.device.type == "cpu":
        return plain_jtw(A, Bm, w, sl)
    lanes, cd = A.shape[0], A.shape[-1]
    _check_blocks("A", A, lanes, sl, 2, cd, A.dtype)
    _check_blocks("Bm", Bm, lanes, sl, 2, 3, A.dtype)
    w = w.contiguous()
    if tuple(w.shape) != (lanes, 2 * sl.n_obs):
        raise ValueError(f"obs_products.jtw: w must be {(lanes, 2 * sl.n_obs)}; got {tuple(w.shape)}")
    out = torch.empty((lanes, cd * sl.n_cams + 3 * sl.n_pts), dtype=A.dtype, device=A.device)
    _launch("jtw", A, Bm, w, out, None, sl)
    return out


def reduce(X, bp, sl: SegmentLists):
    """Σ_{o∈obs(c)} X_o b[p_o] (B, C, cd) of b (B, P, 3): the plain version
    on the CPU, one launch on a card."""
    spans.count(("obs_products", "reduce"))
    if X.device.type == "cpu":
        return plain_reduce(X, bp, sl)
    lanes, cd = X.shape[0], X.shape[-2]
    _check_blocks("X", X, lanes, sl, cd, 3, X.dtype)
    bp = bp.contiguous()
    if tuple(bp.shape) != (lanes, sl.n_pts, 3):
        raise ValueError(f"obs_products.reduce: b must be {(lanes, sl.n_pts, 3)}; got {tuple(bp.shape)}")
    out = torch.empty((lanes, sl.n_cams, cd), dtype=X.dtype, device=X.device)
    _launch("reduce", X, None, bp, out, None, sl)
    return out


def lift(W, zc, sl: SegmentLists):
    """Σ_{o∈obs(p)} W_oᵀ z[c_o] (B, P, 3) of z (B, C, cd): the plain version
    on the CPU, one launch on a card."""
    spans.count(("obs_products", "lift"))
    if W.device.type == "cpu":
        return plain_lift(W, zc, sl)
    lanes, cd = W.shape[0], W.shape[-2]
    _check_blocks("W", W, lanes, sl, cd, 3, W.dtype)
    zc = zc.contiguous()
    if tuple(zc.shape) != (lanes, sl.n_cams, cd):
        raise ValueError(f"obs_products.lift: z must be {(lanes, sl.n_cams, cd)}; got {tuple(zc.shape)}")
    out = torch.empty((lanes, sl.n_pts, 3), dtype=W.dtype, device=W.device)
    _launch("lift", W, None, zc, out, None, sl)
    return out


def uv(A, Bm, sl: SegmentLists):
    """(U (B, C, cd, cd), V (B, P, 3, 3)): the plain version on the CPU, one
    launch on a card."""
    spans.count(("obs_products", "uv"))
    if A.device.type == "cpu":
        return plain_uv(A, Bm, sl)
    lanes, cd = A.shape[0], A.shape[-1]
    _check_blocks("A", A, lanes, sl, 2, cd, A.dtype)
    _check_blocks("Bm", Bm, lanes, sl, 2, 3, A.dtype)
    U = torch.empty((lanes, sl.n_cams, cd, cd), dtype=A.dtype, device=A.device)
    V = torch.empty((lanes, sl.n_pts, 3, 3), dtype=A.dtype, device=A.device)
    _launch("uv", A, Bm, None, U, V, sl)
    return U, V
