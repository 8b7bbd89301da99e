"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates outside the tensor cores: 67
TFLOP/s in float32 (the solver's IEEE float32 arithmetic) and 34 TFLOP/s in
float64; 3.35 TB/s of HBM3.  The rates assume the card's full 700 W; the
harness prints the power limit beside every run.
"""

from __future__ import annotations

__all__ = ["PEAKS", "for_device"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flop_s": 67e12, "float64_flop_s": 34e12, "hbm_bytes_s": 3.35e12},
}


def for_device(name: str):
    """The card's peaks, or None for a card not in the table (its roofline
    shares are then not read)."""
    return PEAKS.get(name)
