"""The solver's float32 matmul precision (``matmul_precision``).

PyTorch counterpart of the JAX package's mode (``CaNNOLeSSolver(
matmul_precision=...)``, which wraps every compiled entry point in
``jax.default_matmul_precision``).  The modes, on the card:

* ``None``, ``'highest'``, ``'float32'``: every float32 matmul in IEEE
  float32.  (JAX's ``None`` is the TPU matrix unit's default, bf16 passes on
  the unpinned matmuls; here it stays IEEE, so that results taken at the
  default do not move.)
* ``'tensorfloat32'``: every float32 matmul of the solve in TF32, the
  condensation JᵀJ included.
* ``'bfloat16'``: the condensation JᵀJ is one bf16 pass with float32
  accumulation and a float32 result (``critical_matmul``); the other
  unpinned float32 matmuls run in TF32, the nearest that PyTorch's flag
  offers on CUDA (it has no one-pass bf16 setting for float32 matmuls).

The contractions that the JAX package pins to ``precision='highest'`` (the
quality-gate residual, the Schur block S = δI + ZᵀZ, the triangular and
Cholesky solves) run inside ``matmul_mode('highest')`` under every mode.

On the CPU every matmul stays IEEE under every mode (XLA:CPU ignores the
precision too); only ``gate_eps`` changes.  float64 matmuls are IEEE
float64 everywhere: TF32 and bf16 apply to float32 only.

The mode is scoped: ``matmul_mode`` sets the card's flags for one solve and
restores the caller's on exit, exception or not.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = [
    "MODES",
    "check_mode",
    "gate_eps",
    "matmul_mode",
    "scoped",
    "critical_matmul",
    "bf16_pass_reference",
]

MODES = (None, "highest", "float32", "bfloat16", "tensorfloat32")
_TF32_MODES = ("tensorfloat32", "bfloat16")


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown matmul_precision {mode!r}")
    return mode


def gate_eps(mode, dtype: torch.dtype) -> float:
    """Unit roundoff of the committed arithmetic, which the quality gate's
    tolerance scales with: bf16's for ``'bfloat16'``, 2⁻¹⁰ (TF32's 10-bit
    mantissa) for ``'tensorfloat32'``, the solve dtype's otherwise, float64
    included (as the JAX package's ``_gate_eps``)."""
    if mode == "tensorfloat32":
        return 2.0**-10
    return float(torch.finfo(torch.bfloat16 if mode == "bfloat16" else dtype).eps)


def _flags():
    m = torch.backends.cuda.matmul
    # PyTorch ≥ 2.9 has fp32_precision ('ieee' | 'tf32' | 'none'); saving and
    # restoring it through the same API keeps the caller's setting exactly
    key = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    return m, key


@contextlib.contextmanager
def matmul_mode(mode):
    """Run the block with the card's float32 matmuls at ``mode``: TF32 for
    ``'tensorfloat32'`` and ``'bfloat16'``, IEEE otherwise; bf16 products
    reduce in float32.  The caller's flags come back on exit."""
    m, key = _flags()
    tf32 = mode in _TF32_MODES
    saved = (getattr(m, key), m.allow_bf16_reduced_precision_reduction)
    setattr(m, key, ("tf32" if tf32 else "ieee") if key == "fp32_precision" else tf32)
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        setattr(m, key, saved[0])
        m.allow_bf16_reduced_precision_reduction = saved[1]


def scoped(method):
    """A solver method run inside the solver's ``_matmul_scope()``."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._matmul_scope():
            return method(self, *args, **kwargs)

    return run


def critical_matmul(a: torch.Tensor, b: torch.Tensor, mode) -> torch.Tensor:
    """``a @ b`` at the condensation's precision (the JAX package's
    ``_critical_precision``): one bf16 pass with float32 accumulation and a
    float32 result for float32 operands on the card under ``'bfloat16'``
    (cuBLAS through ``torch.mm``/``torch.bmm(..., out_dtype=float32)``; a
    plain matmul of bf16 operands would round the result to bf16), TF32
    under ``'tensorfloat32'``, IEEE otherwise and on the CPU (JAX's None
    is 'high', about float32 grade).  2-D or 3-D (batched) operands."""
    if mode == "bfloat16" and a.is_cuda and a.dtype == torch.float32:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        with matmul_mode(mode):
            return mm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    with matmul_mode(mode):
        return a @ b


def bf16_pass_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the one-pass bf16 product: the operands rounded
    to bf16, then an IEEE float32 product.  A bf16 × bf16 product is exact
    in float32, so this is the card's arithmetic up to the summation order."""
    with matmul_mode("highest"):
        return a.bfloat16().float() @ b.bfloat16().float()
