"""The pair accumulation of the camera-Schur system on an observation list:
the CUDA kernel and its plain version.

For a BA problem given as an observation list, the reduced camera system is

    S = blockdiag(U) + Dc − Σ_p Σ_{i, j ∈ obs(p)} X_i W_jᵀ,

X_i = W_i V_p⁻¹ and W_i = A_iᵀ B_i (cd × 3 each, cd the camera's
parameters).  :func:`plan` lists, once per scene, every pair (i, j) of
observations of one point whose cameras satisfy cam_i ≥ cam_j, sorted by
their target block (cam_i, cam_j) of the lower triangle; :func:`accumulate`
sums each block's products T_b = Σ X_i W_jᵀ, returning the (n_blocks, cd, cd)
lower blocks, which ``core/ba.py`` places into S and mirrors.

No TPU kernel is replaced: the JAX package has no observation-list route
(its Schur engine takes the dense (C, P) grid).  On a card
:func:`accumulate` launches ``csrc/schur_pairs.cu``: one thread block per
target block sums its pairs' products in a fixed order, in registers, and
writes the block once, with no float atomics, so a solve repeats bit for bit
(the plain route's ``index_add_`` would sum by atomics in no fixed order).
The design note is at the top of that file.  On the CPU it runs the plain
version, :func:`plain`: chunked ``bmm`` of the pairs' products and a
segment sum in the pairs' sorted order (``index_put_`` with
``accumulate=True``, which sums duplicates in a fixed order on a card and
on one CPU thread).  The library is built at the first launch, not with the other
kernels (``ops/_native.py`` ``library``).

``core.segments.counters()["schur_pairs"]`` counts the kernel's launches
that succeeded.
"""

from __future__ import annotations

import functools
from ctypes import c_int, c_void_p
from typing import NamedTuple

import torch

from ..utils import spans

__all__ = ["PairPlan", "plan", "accumulate", "plain", "segment_sum"]

spans.declare("schur_pairs")
# pairs of one bmm of the plain version
CHUNK = 1 << 18


class PairPlan(NamedTuple):
    """The pairs of one observation structure, sorted by target block."""

    pair_i: torch.Tensor  # (n_pairs,) int32: the observation of the later camera
    pair_j: torch.Tensor  # (n_pairs,) int32: the observation of the earlier camera
    block_start: torch.Tensor  # (n_blocks + 1,) int32: each block's first pair
    block_of_pair: torch.Tensor  # (n_pairs,) int64
    block_cam: torch.Tensor  # (n_blocks, 2) int64: (cam_i, cam_j), cam_i ≥ cam_j

    @property
    def n_pairs(self) -> int:
        return int(self.pair_i.shape[0])

    @property
    def n_blocks(self) -> int:
        return int(self.block_cam.shape[0])


def segment_sum(values: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of the rows of ``values`` (k, ...) with ``index`` (k,) equal to
    each of 0..n−1, (n, ...).  ``index_put_`` with ``accumulate=True`` sums
    duplicates in the order of the rows on a card (after a stable sort of
    the indices, with no float atomics) and on one CPU thread, so the sums
    repeat bit for bit there; the CPU's threads may split them in other
    orders."""
    out = values.new_zeros((n, *values.shape[1:]))
    return out.index_put_((index,), values, accumulate=True)


def plan(cam_idx: torch.Tensor, pt_idx: torch.Tensor, n_cams: int) -> PairPlan:
    """The sorted pairs of the observations (``cam_idx``, ``pt_idx``), on
    their device.  Raises where a camera sees a point twice."""
    dev = cam_idx.device
    C = int(n_cams)
    n_obs = int(cam_idx.shape[0])
    if n_obs >= 1 << 31:
        raise ValueError(f"{n_obs} observations: the pair indices are 32-bit")
    # observations by point, then camera: within a track the later camera comes later
    order = torch.argsort(pt_idx * C + cam_idx)
    key = (pt_idx * C + cam_idx)[order]
    if n_obs > 1 and bool((key[1:] == key[:-1]).any()):
        raise ValueError("a camera observes a point twice; the observation list needs distinct (camera, point)")
    _, track = torch.unique_consecutive(pt_idx[order], return_counts=True)
    first = torch.repeat_interleave(torch.cumsum(track, 0) - track, track)  # each sorted obs' track start
    pos = torch.arange(n_obs, device=dev) - first
    count = pos + 1  # a sorted obs pairs with itself and every earlier obs of its track
    src = torch.repeat_interleave(torch.arange(n_obs, device=dev), count)
    offs = torch.arange(src.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    pi, pj = order[src], order[first[src] + offs]
    target = cam_idx[pi] * C + cam_idx[pj]
    perm = torch.argsort(target, stable=True)
    pi, pj, target = pi[perm], pj[perm], target[perm]
    blocks, per_block = torch.unique_consecutive(target, return_counts=True)
    if pi.shape[0] >= 1 << 31:
        raise ValueError(f"{pi.shape[0]} pairs: the pair indices are 32-bit")
    start = torch.cat([per_block.new_zeros(1), torch.cumsum(per_block, 0)]).to(torch.int32)
    return PairPlan(
        pair_i=pi.to(torch.int32),
        pair_j=pj.to(torch.int32),
        block_start=start,
        block_of_pair=torch.repeat_interleave(torch.arange(blocks.shape[0], device=dev), per_block),
        block_cam=torch.stack([blocks // C, blocks % C], -1),
    )


def plain(X: torch.Tensor, W: torch.Tensor, pp: PairPlan) -> torch.Tensor:
    """The plain version: T_b = Σ X_i W_jᵀ over block b's pairs,
    (n_blocks, cd, cd); X and W (n_obs, cd, 3)."""
    cd = X.shape[-2]
    out = X.new_zeros((pp.n_blocks, cd, cd))
    for s in range(0, pp.n_pairs, CHUNK):
        i, j = pp.pair_i[s:s + CHUNK].long(), pp.pair_j[s:s + CHUNK].long()
        prod = torch.bmm(X[i], W[j].transpose(1, 2))
        out.index_put_((pp.block_of_pair[s:s + CHUNK],), prod, accumulate=True)
    return out


@functools.lru_cache(maxsize=None)
def _function(dtype):
    from . import _native

    lib = _native.library("schur_pairs.cu")
    return _native.function(lib, f"cannoles_schur_pairs_{'f32' if dtype == torch.float32 else 'f64'}",
                            [c_void_p] * 5 + [c_int, c_int, c_void_p, c_void_p])


def accumulate(X: torch.Tensor, W: torch.Tensor, pp: PairPlan) -> torch.Tensor:
    """T (n_blocks, cd, cd) of :func:`plain`: on a card one launch of the
    kernel (raises if it is refused), on the CPU the plain version."""
    if X.device.type == "cpu":
        return plain(X, W, pp)
    cd = X.shape[-2]
    if X.dtype not in (torch.float32, torch.float64) or W.dtype != X.dtype:
        raise TypeError(f"schur_pairs takes float32 or float64 X and W of one dtype; got {X.dtype}, {W.dtype}")
    if cd not in (6, 9) or X.shape[1:] != (cd, 3) or W.shape != X.shape:
        raise ValueError(f"schur_pairs takes X and W (n_obs, 6 or 9, 3); got {tuple(X.shape)}, {tuple(W.shape)}")
    for t in (X, W, pp.pair_i, pp.pair_j, pp.block_start):
        if t.device != X.device or not t.is_contiguous():
            raise ValueError("schur_pairs takes contiguous tensors on one device")
    out = torch.empty((pp.n_blocks, cd, cd), dtype=X.dtype, device=X.device)
    if pp.n_blocks == 0:
        return out
    rc = _function(X.dtype)(X.data_ptr(), W.data_ptr(), pp.pair_i.data_ptr(), pp.pair_j.data_ptr(),
                            pp.block_start.data_ptr(), pp.n_blocks, cd, out.data_ptr(),
                            torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"schur_pairs launch failed (code {rc}) at {pp.n_blocks} blocks, cd = {cd}")
    spans.count("schur_pairs")
    return out
