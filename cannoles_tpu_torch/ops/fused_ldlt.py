"""Fused batched LDLᵀ factor + solve: the CUDA kernel and its plain version.

Port of ``cannoles_tpu/ops/pallas_ldlt.py``.  The TPU kernel ``_fused_kernel``
becomes the hand-written CUDA kernel ``csrc/fused_ldlt.cu`` (design note at
the top of that file: one thread per system for small N, one block per
system above :func:`thread_max_n`).  The public layout is the one of
``batched_ldlt_solve_pallas``: W (B, N, N) and rhs (B, N) in, x (B, N) and
the raw pivots d (B, N) out.  The kernel keeps the TPU's lanes-last layout
in shared memory for small N; the 128-lane identity padding and the Mosaic
compile-time size gates are not carried over.

* :func:`fused_ldlt_solve` is the wrapper the solver calls.  A CPU tensor
  runs :func:`fused_ldlt_solve_reference`; a CUDA tensor launches the kernel
  or raises.  It counts the kernel's launches as ``"fused_ldlt"`` and
  ``("fused_ldlt", (N, B))`` (``core.segments.counters()``).
* :func:`fused_ldlt_solve_reference` is the same elimination in batched
  tensor ops, step for step as the TPU kernel body (``pallas_ldlt.py:98-125``).
  It is what the CPU tests run and what the kernel is checked against.  It
  is not ``torch.linalg.ldl_factor``, which pivots and so changes the
  inertia signal.

There is no refinement step, also at B = 1: the JAX package's unbatched
path refines once in float32 (``ops/ldlt.py:208-212``), the port follows the
batched semantics everywhere.
"""

from __future__ import annotations

import functools
import math
from ctypes import c_double, c_int, c_void_p

import torch

from ..utils import spans
from .ldlt import safe_inverse

__all__ = [
    "fused_ldlt_solve",
    "fused_ldlt_solve_reference",
    "max_n",
    "thread_max_n",
]

spans.declare("fused_ldlt")

_SMEM_BYTES = 232_448  # shared memory a block may use on sm_90 (227 KB)


@functools.lru_cache(maxsize=None)
def max_n(dtype: torch.dtype) -> int:
    """Largest N the kernel takes: N·(N | 1) + N values of shared memory per
    block, at most (N² + 2N)·itemsize bytes, must fit in 227 KB (240 in
    float32, 169 in float64)."""
    # (N² + 2N)·item ≤ S  ⇔  (N + 1)² ≤ S // item + 1
    return math.isqrt(_SMEM_BYTES // (torch.finfo(dtype).bits // 8) + 1) - 1


def fused_ldlt_solve_reference(W: torch.Tensor, rhs: torch.Tensor, eig_tol: float):
    """Plain batched version of the kernel: returns (x, raw pivots d)."""
    Bt, N, _ = W.shape
    Wk = W.clone()
    d = W.new_empty((Bt, N))
    rows = torch.arange(N, device=W.device)
    for k in range(N):
        row = Wk[:, k, :].clone()  # symmetric ⇒ row k == column k
        dk = row[:, k]
        col = torch.where(rows > k, row * safe_inverse(dk, eig_tol)[:, None], 0.0)
        d[:, k] = dk
        Wk[:, k, :] = col  # row k now holds the strict L column k
        Wk = Wk - dk[:, None, None] * col[:, :, None] * col[:, None, :]
    x = rhs.clone()
    for k in range(N):
        x = x - Wk[:, k, :] * x[:, k : k + 1]
    x = x * safe_inverse(d, eig_tol)
    for k in range(N - 1, -1, -1):
        s = (Wk[:, k, :] * x).sum(-1)
        x[:, k] = x[:, k] - s
    return x, d


def fused_ldlt_solve(W: torch.Tensor, rhs: torch.Tensor, eig_tol: float):
    """Solve W x = rhs for B symmetric systems by unpivoted LDLᵀ; returns
    (x, raw pivots d).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and anything it does not take raises."""
    if W.device.type == "cpu" and rhs.device.type == "cpu":
        return fused_ldlt_solve_reference(W, rhs, eig_tol)
    return _launch(W, rhs, eig_tol, 0)


def thread_max_n() -> int:
    """Largest N the kernel solves with one thread per system; above it, one
    block per system (the kernel's own constant, read from the library)."""
    from . import _native

    return _native.function(_native.library("fused_ldlt.cu"), "cannoles_fused_ldlt_thread_max_n", [])()


@functools.lru_cache(maxsize=None)
def _function(dtype):
    """The kernel's C function for ``dtype``, bound on the first call (which
    builds the library)."""
    from . import _native

    lib = _native.library("fused_ldlt.cu")
    return _native.function(lib, f"cannoles_fused_ldlt_{'f32' if dtype == torch.float32 else 'f64'}",
                            [c_void_p] * 4 + [c_int, c_int, c_double, c_int, c_void_p])


def _launch(W: torch.Tensor, rhs: torch.Tensor, eig_tol: float, route: int):
    """Launch the kernel on CUDA tensors.  ``route`` 0 takes the mapping for
    N; 32, 64 or 128 force one thread per system with that many systems per
    block, -1 one block per system (``chip_smoke.py`` measures the threshold
    with them)."""
    if W.device.type != "cuda" or rhs.device != W.device:
        raise ValueError(f"fused_ldlt_solve: W on {W.device}, rhs on {rhs.device}")
    if W.dtype not in (torch.float32, torch.float64) or rhs.dtype != W.dtype:
        raise TypeError(f"fused_ldlt_solve: dtypes {W.dtype}/{rhs.dtype}, need float32 or float64")
    if W.dim() != 3 or W.shape[1] != W.shape[2] or rhs.shape != W.shape[:2]:
        raise ValueError(f"fused_ldlt_solve: shapes {tuple(W.shape)} and {tuple(rhs.shape)}")
    if not (W.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("fused_ldlt_solve: W and rhs must be contiguous")
    B, N = rhs.shape
    if N > max_n(W.dtype):
        raise ValueError(f"fused_ldlt_solve: N={N} above the kernel's cap {max_n(W.dtype)}")
    if B >= 2**31:
        raise ValueError(f"fused_ldlt_solve: B={B} exceeds the grid")
    x = torch.empty_like(rhs)
    d = torch.empty_like(rhs)
    if B == 0 or N == 0:
        return x, d
    fn = _function(W.dtype)
    args = (W.data_ptr(), rhs.data_ptr(), x.data_ptr(), d.data_ptr(), B, N, float(eig_tol), route)
    if W.device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(W.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ldlt_solve: kernel launch failed with CUDA error {err}")
    spans.count("fused_ldlt")
    spans.count(("fused_ldlt", (N, B)))
    return x, d
