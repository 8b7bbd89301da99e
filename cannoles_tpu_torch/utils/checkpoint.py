"""Checkpoint / resume for solver state, in the JAX package's file format.

Port of ``cannoles_tpu/utils/checkpoint.py``.  ``save_state`` writes one
``.npz``: each state field under its name, the data pytree's leaves as
``data__{i}`` (dicts in sorted-key order, sequences in order: JAX's
flattening order), and ``__meta__``, a JSON string with ``kind``
(``SolverState`` or ``MFState``), ``fields``, ``has_data``,
``n_data_leaves`` and ``data_treedef``.  ``data_treedef`` is descriptive
only: neither package reads it back, so a ``data_template`` rebuilds the
data on load in both.

Batch axis.  The port's states carry a leading batch axis; the JAX
package's single-solve states do not, and its solver cannot resume from a
state with one.  So a port state with B = 1 is saved without the batch
axis (a JAX ``solve(resume_from=...)`` reads it as its own), and a state
with B > 1 (a batch, as from ``vsolve``) keeps it.  On load, a file whose
``x`` has rank 1 (a single solve of either package) gains the batch axis
back.

Files written before the dense state's Jacobian became ``JxT`` (n, m)
stored ``Jx`` (m, n); ``load_state`` transposes such a leaf.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..core.matfree import MFState
from ..core.solver import SolverState
from ..problem import default_device

__all__ = ["save_state", "load_state"]

_KINDS = {"SolverState": SolverState, "MFState": MFState}


def _flatten(tree):
    """Leaves of a pytree of tensors/arrays in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _treedef(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ("," if len(tree) == 1 else "") + ")"
    return "*"


def _unflatten(template, leaves):
    """Rebuild ``template``'s structure from ``leaves`` (consumed in order)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return leaves.pop(0)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_state(path, state) -> None:
    """Write a ``SolverState`` or ``MFState`` to ``path`` (.npz); see the
    module docstring for the batch axis."""
    path = pathlib.Path(path)
    kind = type(state).__name__
    if kind not in _KINDS:
        raise TypeError(f"save_state handles SolverState and MFState, got {kind}")
    single = state.x.dim() == 2 and state.x.shape[0] == 1

    def arr(v):
        a = _np(v)
        return a[0] if single else a

    leaves = {}
    meta = {"kind": kind, "fields": [], "has_data": state.data is not None}
    for name in type(state)._fields:
        val = getattr(state, name)
        if name == "data":
            if val is None:
                continue
            data_leaves = _flatten(val)
            meta["data_treedef"] = f"PyTreeDef({_treedef(val)})"
            meta["n_data_leaves"] = len(data_leaves)
            for i, leaf in enumerate(data_leaves):
                leaves[f"data__{i}"] = arr(leaf)
            continue
        leaves[name] = arr(val)
        meta["fields"].append(name)
    np.savez(path, __meta__=json.dumps(meta), **leaves)


def load_state(path, data_template=None, *, device=None):
    """Load a saved state (``SolverState`` or ``MFState``, by the file's
    kind) with a leading batch axis, on ``device`` (default: the card; pass
    ``device="cpu"`` without one).  If the file carries problem data, a
    ``data_template`` pytree of the same structure rebuilds it; without
    one a single leaf comes back as itself and several as a tuple."""
    dev = default_device(device)
    path = pathlib.Path(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        cls = _KINDS[meta.get("kind", "SolverState")]
        arrays = {name: np.array(z[name]) for name in meta["fields"]}
        if "Jx" in arrays and cls is SolverState:
            arrays["JxT"] = np.swapaxes(arrays.pop("Jx"), -2, -1)
        single = arrays["x"].ndim == 1

        def tensor(a):
            t = torch.as_tensor(np.array(a), device=dev)
            return t.unsqueeze(0) if single else t

        kw = {name: tensor(a) for name, a in arrays.items()}
        kw["data"] = None
        if meta.get("has_data"):
            data_leaves = [tensor(z[f"data__{i}"]) for i in range(meta["n_data_leaves"])]
            if data_template is not None:
                kw["data"] = _unflatten(data_template, data_leaves)
            elif len(data_leaves) == 1:
                kw["data"] = data_leaves[0]
            else:
                kw["data"] = tuple(data_leaves)
    return cls(**kw)
