"""The stated precision of the products, read from the card's operations.

A configuration that states IEEE float32 products lists the check
``tensor_core_ops``: the number of device operations of the profiled slice
whose kernel names carry tensor-core arithmetic below float32 (TF32,
bfloat16, float16, fp8 or int8 operands).  cuBLAS names its float32 GEMMs by
their arithmetic: ``..._f32f32_f32f32_f32_..._ffma_...`` in IEEE float32,
``..._f32f32_tf32f32_f32_...`` (or CUTLASS's ``tensorop_s1688...``) in TF32,
``..._bf16bf16_bf16f32_...`` in bfloat16.  A sound run reads 0, the limit.
The program's own TF32 path (``matmul_precision="tensorfloat32"``) gives the
same answers to float32 grade where Gauss-Newton corrects its rounded JtJ,
so no comparison of answers can tell it apart; its kernels can.

Off the card there are no tensor cores, and the number is 0.
"""

from __future__ import annotations

import re

__all__ = ["PATTERN", "reduced_precision_ops"]

PATTERN = re.compile(r"tf32|bf16|f16|half|e4m3|e5m2|fp8|hmma|imma|i8i8|s1688|s16816|h1688|h16816|tensorop_[shi]",
                     re.IGNORECASE)


def reduced_precision_ops(sl, device) -> "int | None":
    """The device operations of ``sl`` (a ``trace.Slice``) in reduced
    precision: 0 off the card, None where the card's slice was not traced."""
    if device.type != "cuda":
        return 0
    if sl is None or not sl.device_ops:
        return None
    return sum(1 for name, _, _ in sl.device_ops if PATTERN.search(name))
