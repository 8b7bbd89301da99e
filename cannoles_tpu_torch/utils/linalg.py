"""Small linear-algebra helpers over the last axis, safe for size 0.

PyTorch counterpart of ``cannoles_tpu/utils/linalg.py``.  Every function
reduces the last axis and keeps the leading (batch) axes, so a (B, n) input
gives a (B,) result; an empty last axis gives 0 (Julia's ``norm`` of an empty
vector) and ``check_nan_inf`` False.
"""

from __future__ import annotations

import torch

__all__ = ["norm_inf", "norm_1", "norm_2", "check_nan_inf"]


def _zeros(v):
    return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)


def norm_inf(v):
    if v.shape[-1] == 0:
        return _zeros(v)
    return v.abs().amax(dim=-1)


def norm_1(v):
    if v.shape[-1] == 0:
        return _zeros(v)
    return v.abs().sum(dim=-1)


def norm_2(v):
    if v.shape[-1] == 0:
        return _zeros(v)
    return torch.sqrt((v * v).sum(dim=-1))


def check_nan_inf(v):
    """True where the last axis holds a NaN or Inf."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=torch.bool, device=v.device)
    return ~torch.isfinite(v).all(dim=-1)
