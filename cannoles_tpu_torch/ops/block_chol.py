"""Blocked Cholesky of the condensed KKT system: the CUDA kernel, its
plain versions, the driver and the block solves.

Port of ``cannoles_tpu/ops/pallas_chol.py``.  Its two Pallas TPU kernels
become two wrappers of the hand-written CUDA kernel in
``csrc/block_chol.cu`` (design note at the top of that file):

* :func:`chol_block` (``_chol_block_kernel``): factor one (nb, nb) SPD
  block per lane, with L⁻¹ and the raw pivots.  Plain version
  :func:`chol_block_reference`.
* :func:`chol_fused` (``_chol_fused_kernel``): the whole (N, N) matrix in
  place, panel by panel.  Plain version :func:`chol_fused_reference`.

Both wrappers launch the same persistent cooperative kernel, once per
call (a block is the case N = nb).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.  ``"chol_block"`` and
``"chol_fused"`` (``core.segments.counters()``) count the wrappers'
launches.  The caller's matrix is
never changed: the kernel works in place on the L output, which the wrapper
allocates and fills.

:func:`block_cholesky` (``pallas_cholesky``) keeps the JAX package's rules:
nb clamped to [128, 512], N padded with identity to a multiple of nb, the
fused kernel while N²·itemsize ≤ 1280²·4 and the blocked driver above it,
``ok = all finite(L) & all d[:n0] > tol``.  In the driver the panel solve
and the trailing update are ``torch.matmul``, as they are plain XLA
matmuls in JAX.  The block solves are ``torch.matmul`` too.

Everything is batch-leading: A (B, N, N); the factorization holds L
(B, N, N), Linv (B, K, nb, nb), d (B, N) and ok (B,).  Float32 products run
in full float32 (TF32 is off, PyTorch's default), the TPU kernels'
``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
from ctypes import c_double, c_int, c_void_p
from typing import NamedTuple

import torch

from ..utils import spans

__all__ = [
    "BlockCholFactorization",
    "block_cholesky",
    "block_cholesky_reference",
    "block_forward_solve",
    "block_backward_solve",
    "block_cho_solve",
    "chol_block",
    "chol_block_reference",
    "chol_fused",
    "chol_fused_reference",
    "uses_fused",
]

spans.declare("chol_block", "chol_fused")

_FUSED_MAX_BYTES = 1280 * 1280 * 4  # the TPU kernel's VMEM budget (pallas_chol.py:252)


class BlockCholFactorization(NamedTuple):
    """A = L Lᵀ with the inverses of L's diagonal blocks (counterpart of
    ``pallas_chol.BlockCholFactorization``, batch-leading).

    ``L``: (B, N, N) lower triangular, padded rows/columns identity;
    ``Linv``: (B, K, nb, nb); ``d``: (B, N) raw pivots (Schur diagonals
    before the square root); ``ok``: (B,) every original pivot above tol and
    L finite; ``n0``: the unpadded N; ``nb``: the panel width."""

    L: torch.Tensor
    Linv: torch.Tensor
    d: torch.Tensor
    ok: torch.Tensor
    n0: int
    nb: int


def chol_block_reference(A: torch.Tensor, tol: float):
    """Plain version of the block kernel, ``_factor_block_inline`` step for
    step: A (B, nb, nb) → (L, Linv, d).  A pivot d ≤ tol gets a zero column
    (diagonal included) and no update; d is recorded raw; a zero diagonal
    of L gives a zero row of L⁻¹."""
    _, nb, _ = A.shape
    P = A.clone()
    L = torch.zeros_like(A)
    D = A.new_zeros(A.shape[:2])
    r = torch.arange(nb, device=A.device)
    zero = A.new_zeros(())
    for t in range(nb):
        col = P[:, :, t]
        dt = col[:, t]
        ok = dt > tol
        piv = torch.sqrt(torch.where(ok, dt, torch.ones_like(dt)))
        inv = torch.where(ok, 1.0 / piv, zero)
        lcol = torch.where(r > t, col * inv[:, None], zero)
        lcol[:, t] = torch.where(ok, piv, zero)
        L[:, :, t] = lcol
        D[:, t] = dt
        tail = lcol[:, t + 1:]
        P[:, t + 1:, t + 1:] -= tail[:, :, None] * tail[:, None, :]
    Minv = torch.zeros_like(A)
    for t in range(nb):
        Lrow = L[:, t, :]
        acc = (torch.where(r < t, Lrow, zero)[:, None, :] @ Minv).squeeze(1)
        piv = Lrow[:, t]
        okt = piv > 0
        inv_t = torch.where(okt, 1.0 / torch.where(okt, piv, torch.ones_like(piv)), zero)
        Minv[:, t, :] = ((r == t).to(A.dtype) - acc) * inv_t[:, None]
    return L, Minv, D


def chol_fused_reference(A: torch.Tensor, tol: float, nb: int):
    """Plain version of the fused kernel, ``_chol_fused_kernel`` step for
    step: A (B, N, N) with N a multiple of nb → (L, Linv (B, K, nb, nb),
    d (B, N))."""
    B, N, _ = A.shape
    K = N // nb
    L = A.clone()
    Linv = A.new_empty((B, K, nb, nb))
    d = A.new_empty((B, N))
    for k in range(K):
        j0, j1 = k * nb, (k + 1) * nb
        Lkk, Minv, Dk = chol_block_reference(L[:, j0:j1, j0:j1], tol)
        L[:, j0:j1, j0:j1] = Lkk
        Linv[:, k] = Minv
        d[:, j0:j1] = Dk
        if j1 < N:
            L21 = L[:, j1:, j0:j1] @ Minv.mT
            L[:, j1:, j0:j1] = L21
            L[:, j1:, j1:] -= L21 @ L21.mT
    return torch.tril(L), Linv, d


def _check(name, A):
    if A.device.type != "cuda":
        raise ValueError(f"{name}: A on {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {A.dtype}, need float32 or float64")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"{name}: shape {tuple(A.shape)}, need (B, N, N)")
    if not 0 < A.shape[0] < 2 ** 31:
        raise ValueError(f"{name}: B={A.shape[0]} outside 1..2**31-1 (the kernel's int batch)")


@functools.lru_cache(maxsize=None)
def _function(dtype):
    """The kernel's C function for ``dtype``, bound on the first call (which
    builds the library)."""
    from . import _native

    lib = _native.library("block_chol.cu")
    return _native.function(lib, f"cannoles_chol_{'f32' if dtype == torch.float32 else 'f64'}",
                            [c_void_p] * 4 + [c_int, c_int, c_int, c_double, c_void_p])


def _launch(name, A, N, nb, tol):
    """Copy A into the L output and run the cooperative kernel on it:
    returns (L, Linv (B, N/nb, nb, nb), d (B, N))."""
    B = A.shape[0]
    L = torch.empty_like(A, memory_format=torch.contiguous_format)
    L.copy_(A)
    Linv = A.new_empty((B, N // nb, nb, nb))
    d = A.new_empty((B, N))
    scratch = A.new_empty((B, max(N * nb, 32 * 32)))  # the kernel's staging and products
    fn = _function(A.dtype)
    with torch.cuda.device(A.device):
        err = fn(L.data_ptr(), Linv.data_ptr(), d.data_ptr(), scratch.data_ptr(), B, N, nb,
                 float(tol), torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    return L, Linv, d


def chol_block(A: torch.Tensor, tol: float):
    """Factor + invert B blocks A (B, nb, nb): returns (L, Linv, d)
    (counterpart of ``_chol_block``, the call of ``_chol_block_kernel``).  CPU
    tensors take the plain version; CUDA tensors launch the kernel, and
    anything it does not take raises."""
    if A.device.type == "cpu":
        return chol_block_reference(A, tol)
    _check("chol_block", A)
    B, nb, _ = A.shape
    if nb > 1024:
        raise ValueError(f"chol_block: nb={nb} outside 1..1024")
    L, Linv, d = _launch("chol_block", A, nb, nb, tol)
    spans.count("chol_block")
    return L, Linv[:, 0], d


def chol_fused(A: torch.Tensor, tol: float, nb: int):
    """Whole-matrix blocked Cholesky of A (B, N, N), N a multiple of nb:
    returns (L, Linv (B, K, nb, nb), d (B, N)) (counterpart of the call
    built by ``_build_fused_call``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything it does not take
    raises."""
    if A.device.type == "cpu":
        return chol_fused_reference(A, tol, nb)
    _check("chol_fused", A)
    B, N, _ = A.shape
    if not (0 < nb <= 1024 and N % nb == 0):
        raise ValueError(f"chol_fused: N={N} is not a multiple of nb={nb} in 1..1024")
    out = _launch("chol_fused", A, N, nb, tol)
    spans.count("chol_fused")
    return out


def uses_fused(N: int, dtype: torch.dtype) -> bool:
    """The route rule of ``pallas_cholesky`` (``pallas_chol.py:252``): the
    fused kernel while the padded (N, N) matrix takes at most 1280²·4
    bytes."""
    return N * N * (torch.finfo(dtype).bits // 8) <= _FUSED_MAX_BYTES


def block_cholesky(A: torch.Tensor, tol: float, nb: int = 256) -> BlockCholFactorization:
    """Blocked Cholesky of symmetric A (B, N, N), lower part used
    (counterpart of ``pallas_cholesky``).  ``fac.ok`` is the positive-
    definiteness test; pivots ≤ tol are recorded raw and skipped, so the
    caller's ρ ladder can retry.  CUDA tensors go through the kernels."""
    return _factor(A, tol, nb, chol_block, chol_fused)


def block_cholesky_reference(A: torch.Tensor, tol: float, nb: int = 256) -> BlockCholFactorization:
    """:func:`block_cholesky` with the kernels' plain versions, on any
    device: what the kernels are checked against on the card."""
    return _factor(A, tol, nb, chol_block_reference, chol_fused_reference)


def _factor(A, tol, nb, block_fn, fused_fn) -> BlockCholFactorization:
    B, N0, _ = A.shape
    nb = max(128, min(nb, 512))
    N = -(-N0 // nb) * nb
    if N != N0:
        P = torch.eye(N, dtype=A.dtype, device=A.device).repeat(B, 1, 1)
        P[:, :N0, :N0] = A
        A = P
    K = N // nb
    if uses_fused(N, A.dtype):
        L, Linv, d = fused_fn(A, tol, nb)
    else:
        L = torch.zeros_like(A)
        Linv = A.new_empty((B, K, nb, nb))
        d = A.new_empty((B, N))
        M = A.clone()
        for k in range(K):
            j0, j1 = k * nb, (k + 1) * nb
            Lkk, Minv, dk = block_fn(M[:, j0:j1, j0:j1], tol)
            L[:, j0:j1, j0:j1] = Lkk
            Linv[:, k] = Minv
            d[:, j0:j1] = dk
            if j1 < N:
                L21 = M[:, j1:, j0:j1] @ Minv.mT
                L[:, j1:, j0:j1] = L21
                M[:, j1:, j1:] -= L21 @ L21.mT
    ok = torch.isfinite(L).flatten(1).all(-1) & (d[:, :N0] > tol).all(-1)
    return BlockCholFactorization(L, Linv, d, ok, N0, nb)


def _pad_rhs(fac: BlockCholFactorization, b: torch.Tensor) -> torch.Tensor:
    N = fac.L.shape[-1]
    if b.shape[1] == N:
        return b
    pad = b.new_zeros((b.shape[0], N - b.shape[1]) + tuple(b.shape[2:]))
    return torch.cat([b, pad], 1)


def block_forward_solve(fac: BlockCholFactorization, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b by blocks with matmuls only (counterpart of
    ``block_forward_solve``); b (B, n) or (B, n, k), returns the padded y
    (B, N[, k])."""
    nb, N = fac.nb, fac.L.shape[-1]
    b = _pad_rhs(fac, b)
    vec = b.dim() == 2
    R = b[:, :, None] if vec else b
    ys = []
    for k in range(N // nb):
        j0 = k * nb
        rhs = R[:, j0:j0 + nb]
        if k > 0:
            rhs = rhs - fac.L[:, j0:j0 + nb, :j0] @ torch.cat(ys, 1)
        ys.append(fac.Linv[:, k] @ rhs)
    y = torch.cat(ys, 1)
    return y[:, :, 0] if vec else y


def block_backward_solve(fac: BlockCholFactorization, b: torch.Tensor) -> torch.Tensor:
    """Solve Lᵀ x = b by blocks with matmuls only (counterpart of
    ``block_backward_solve``); returns the padded x."""
    nb, N = fac.nb, fac.L.shape[-1]
    b = _pad_rhs(fac, b)
    vec = b.dim() == 2
    R = b[:, :, None] if vec else b
    K = N // nb
    xs = [None] * K
    for k in range(K - 1, -1, -1):
        j0 = k * nb
        rhs = R[:, j0:j0 + nb]
        if k < K - 1:
            rhs = rhs - fac.L[:, j0 + nb:, j0:j0 + nb].mT @ torch.cat(xs[k + 1:], 1)
        xs[k] = fac.Linv[:, k].mT @ rhs
    x = torch.cat(xs, 1)
    return x[:, :, 0] if vec else x


def block_cho_solve(fac: BlockCholFactorization, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given A = L Lᵀ (counterpart of ``block_cho_solve``);
    b (B, n) or (B, n, k), returns the unpadded x."""
    return block_backward_solve(fac, block_forward_solve(fac, b))[:, :fac.n0]
