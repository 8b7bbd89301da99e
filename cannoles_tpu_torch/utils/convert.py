"""Carry problem data and solver state across from numpy (and so from JAX).

The port never imports JAX: a caller turns JAX arrays into numpy arrays
(``np.asarray``) and hands them over here.

* :func:`tree_to_torch` turns a pytree (dict / list / tuple / None) of
  numpy arrays or scalars into tensors: floating leaves take ``dtype``,
  integer and boolean leaves keep their kind.
* :func:`state_from_numpy` builds the port's batched ``SolverState`` from
  the fields of a JAX ``SolverState`` (``state._asdict()`` with each leaf
  through ``np.asarray``), adding the batch axis when the fields are
  unbatched.  This lets a JAX iterate resume in the port.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.solver import TENSOR_FIELDS, SolverState, _add_batch_axis

__all__ = ["tree_to_torch", "state_from_numpy"]

_INT_FIELDS = {"iter", "inner_iter", "neval_F", "neval_c", "nbk", "nfact", "nlinsolve", "status", "msg"}
_BOOL_FIELDS = {"broken", "first_order", "small_residual"}


def _leaf(v, device, dtype):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
    t = torch.as_tensor(np.array(v), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def tree_to_torch(tree: Any, *, device, dtype: torch.dtype) -> Any:
    """Numpy leaves of ``tree`` as tensors on ``device``; floats as ``dtype``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device=device, dtype=dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device=device, dtype=dtype) for v in tree)
    return _leaf(tree, device, dtype)


def state_from_numpy(fields: Dict[str, Any], *, device, dtype: torch.dtype) -> SolverState:
    """A batched ``SolverState`` from numpy fields named as the JAX
    ``SolverState``'s (``data`` optional).  Unbatched fields (``x`` of
    rank 1) get a batch axis of 1."""
    batched = np.ndim(fields["x"]) == 2
    out = {}
    for name in TENSOR_FIELDS:
        a = np.array(fields[name])  # a writable copy
        if name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int32), device=device)
        elif name in _BOOL_FIELDS:
            t = torch.as_tensor(a.astype(bool), device=device)
        else:
            t = torch.as_tensor(a, device=device).to(dtype)
        out[name] = t if batched else t.unsqueeze(0)
    data = tree_to_torch(fields.get("data"), device=device, dtype=dtype)
    out["data"] = data if batched else _add_batch_axis(data, device)
    return SolverState(**out)
