"""The per-observation Jacobian blocks of the camera-Schur engine's list
route: the CUDA kernel and its plain version.

On an observation list (``core/ba.py``) every product and the Schur
assembly at an iterate x read, for each observation o of camera c_o and
point p_o, the blocks of the projection u = project(cam, pt):

* A_o = ∂u/∂cam (2, cd), its columns times the solver's frozen-coordinate
  mask of camera c_o where it has one;
* Bm_o = ∂u/∂pt (2, 3);
* W_o = A_oᵀ Bm_o (cd, 3), from the masked A_o;

as (B, n_obs, 2, cd), (B, n_obs, 2, 3) and (B, n_obs, cd, 3), which
:func:`blocks` returns.

No TPU kernel is replaced: the JAX package has no observation-list route.
With the library's own Snavely projection (``models.bal.snavely_project``,
cd = 9) on a card, :func:`blocks` is one launch of ``csrc/obs_blocks.cu``:
a thread per observation reads its camera and point from x by their
offsets, forms A, Bm and W in registers from the projection's derivatives
written out in closed form, and stores them through shared memory as
coalesced 16-byte writes, with no atomics, so the blocks repeat bit for
bit; the design note is at the top of that file.  Every other projection
(a user's own, the 6-parameter pinhole) and every CPU tensor take the plain
version, :func:`plain_blocks`: forward-mode ``jacfwd`` of the projection
vmapped over the observations, the mask, and W by an einsum, so the CPU's
bits are the ones the list route had before the kernel.  The library is
built at the first launch, not with the other kernels (``ops/_native.py``
``library``).

Counters (``core.segments.counters()``): ``"obs_blocks"`` the kernel's
launches that succeeded, ``("obs_blocks", "calls")`` the list route's block
evaluations on any device.  On a card with Snavely's projection each call
is one launch, so the engagement, launches over calls, is 1; on the CPU 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.func import jacfwd, vmap

from ..models.bal import CAM, snavely_project
from ..utils import spans
from .obs_products import SegmentLists

__all__ = ["blocks", "plain_blocks", "jacfwd_blocks"]

spans.declare("obs_blocks", ("obs_blocks", "calls"))
# the kernel's grid takes the lanes as its y
_MAX_LANES = 65_535


def jacfwd_blocks(project, x, C: int, P: int, cd: int, cam_idx, pt_idx):
    """Per-observation Jacobian blocks on a list, x (B, cd·C + 3P):
    A = ∂u/∂cam (B, n_obs, 2, cd) and Bm = ∂u/∂pt (B, n_obs, 2, 3), from one
    forward-mode pass over each observation's camera and point."""
    Bt = x.shape[0]
    cams = x[:, : cd * C].reshape(Bt, C, cd)[:, cam_idx]
    pts = x[:, cd * C:].reshape(Bt, P, 3)[:, pt_idx]

    def jac_one(cam, pt):
        J = jacfwd(lambda v: project(v[:cd], v[cd:]))(torch.cat([cam, pt]))
        return J[:, :cd], J[:, cd:]

    A, Bm = vmap(vmap(jac_one))(cams, pts)
    return A.to(x.dtype), Bm.to(x.dtype)


def plain_blocks(project, x, sl: SegmentLists, cd: int, cam_mask=None):
    """(A, Bm, W) at x (B, cd·C + 3P) by ``jacfwd``, the mask (C, cd) and
    an einsum."""
    A, Bm = jacfwd_blocks(project, x, sl.n_cams, sl.n_pts, cd, sl.cam_idx, sl.pt_idx)
    if cam_mask is not None:
        A = A * cam_mask[sl.cam_idx][None, :, None, :]
    W = torch.einsum("boki,bokj->boij", A, Bm)
    return A, Bm, W


@functools.lru_cache(maxsize=None)
def _function(dtype):
    from . import _native

    lib = _native.library("obs_blocks.cu")
    return _native.function(lib, f"cannoles_obs_blocks_{'f32' if dtype == torch.float32 else 'f64'}",
                            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                            + [ctypes.c_void_p] * 5)


def blocks(project, x, sl: SegmentLists, cd: int, cam_mask=None):
    """(A (B, n_obs, 2, cd), Bm (B, n_obs, 2, 3), W (B, n_obs, cd, 3)) at x
    (B, cd·C + 3P): one launch on a card where ``project`` is
    ``snavely_project``, the plain version otherwise.  Raises where the
    kernel's inputs are not what it takes or the launch is refused."""
    spans.count(("obs_blocks", "calls"))
    if x.device.type == "cpu" or project is not snavely_project:
        return plain_blocks(project, x, sl, cd, cam_mask)
    lanes, dtype, dev = x.shape[0], x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"obs_blocks takes float32 or float64; got {dtype}")
    if cd != CAM or x.dim() != 2 or x.shape[1] != CAM * sl.n_cams + 3 * sl.n_pts:
        raise ValueError(f"obs_blocks: x must be (B, {CAM}·{sl.n_cams} + 3·{sl.n_pts}); got {tuple(x.shape)}, "
                         f"cd = {cd}")
    if not 1 <= lanes <= _MAX_LANES:
        raise ValueError(f"obs_blocks takes 1 to {_MAX_LANES} lanes; got {lanes}")
    if cam_mask is not None and (cam_mask.dtype != dtype or tuple(cam_mask.shape) != (sl.n_cams, CAM)):
        raise ValueError(f"obs_blocks: the mask must be ({sl.n_cams}, {CAM}) {dtype}; got "
                         f"{tuple(cam_mask.shape)} {cam_mask.dtype}")
    mask = None if cam_mask is None else cam_mask.contiguous()
    for t in (sl.cam, sl.pt, mask):
        if t is not None and t.device != dev:
            raise ValueError("obs_blocks takes x, the mask and the lists on one device")
    x = x if x.stride(1) == 1 else x.contiguous()
    n = sl.n_obs
    A = torch.empty((lanes, n, 2, CAM), dtype=dtype, device=dev)
    Bm = torch.empty((lanes, n, 2, 3), dtype=dtype, device=dev)
    W = torch.empty((lanes, n, CAM, 3), dtype=dtype, device=dev)
    rc = _function(dtype)(lanes, n, sl.n_cams, sl.cam.data_ptr(), sl.pt.data_ptr(), x.data_ptr(), x.stride(0),
                          None if mask is None else mask.data_ptr(), A.data_ptr(), Bm.data_ptr(), W.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"obs_blocks launch failed (code {rc}): {n} observations, {lanes} lanes")
    spans.count("obs_blocks")
    return A, Bm, W
