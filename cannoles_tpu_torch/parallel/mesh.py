"""The port's device mesh: one axis of SPMD processes over ``torch.distributed``.

The JAX package lays data out over a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives.  PyTorch has no GSPMD: the port runs one process per
rank, and every reduction across the mesh axis is an explicit collective
called through a :class:`Mesh`.  ``torch.distributed.device_mesh.DeviceMesh``
builds with gloo on two ranks that share one H100 (checked there), but it
needs a process group (``init_device_mesh`` starts the default one from
``env://``), so it cannot be the one-rank mesh of a plain single-process
call; it would only hold the group that :class:`Mesh` holds.

Device rule: rank ``r`` of a mesh on the card uses ``cuda:{local_rank %
torch.cuda.device_count()}`` (``LOCAL_RANK`` when the launcher sets it, else
the rank in the default group), so k ranks on one card share ``cuda:0``;
``device="cpu"`` puts every rank on the CPU.  Backend rule
(:func:`backend_for`): ``cpu:gloo,cuda:nccl`` when every rank of the host has
a card of its own (CUDA tensors over NCCL, CPU tensors over gloo, in one
group), else ``gloo`` (ranks that share a card, or no card): NCCL refuses two
ranks on one device, and gloo reduces CUDA tensors through the host.

Without an initialised process group the builders give a one-rank mesh whose
collectives return their input: a plain single-process call behaves as the
JAX package on one device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_row_mesh", "make_batch_mesh", "backend_for", "rank_device", "row_block"]


def backend_for(local_world: int) -> str:
    """``cpu:gloo,cuda:nccl`` when each of ``local_world`` ranks on this
    host can have a card of its own, else ``gloo``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """This process's device under the rule above; ``device`` overrides it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device=\"cpu\""
        )
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis over a process group.

    ``group`` is None for the default group; ``ranks`` are the global ranks
    of the axis, ``rank`` this process's index among them.  ``size == 1``
    makes every collective the identity."""

    axis_name: str
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size > 1:
            t = t.contiguous()
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce SUM of a freshly computed tensor, in place; returned."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce MAX of a floating tensor, NaN wherever a rank holds
        one (as ``torch.amax`` over the whole axis; gloo's MAX may drop a
        NaN).  One collective: the values and their NaN flags together."""
        if self.size == 1:
            return t
        nan = torch.isnan(t)
        both = torch.stack([torch.where(nan, torch.full_like(t, float("-inf")), t), nan.to(t.dtype)])
        self._reduce(both, dist.ReduceOp.MAX)
        return torch.where(both[1] > 0, torch.full_like(t, float("nan")), both[0])

    def any(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise OR of a boolean tensor over the ranks."""
        if self.size == 1:
            return t
        return self._reduce(t.to(torch.int32), dist.ReduceOp.MAX).bool()

    def block(self, n: int, what: str) -> slice:
        """This rank's contiguous block of an axis of length ``n``; raises
        where ``n`` does not split evenly (as the JAX package's
        ``device_put`` does for a sharded axis)."""
        if n % self.size:
            raise ValueError(
                f"{what}: the global size of axis 0 should be divisible by {self.size} "
                f"(the ranks of mesh axis {self.axis_name!r}), but it is equal to {n}"
            )
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _make(axis_name: str, group, device) -> Mesh:
    if not dist.is_initialized():
        return Mesh(axis_name, (0,), 0, rank_device(device), None)
    ranks = tuple(dist.get_process_group_ranks(group) if group is not None
                  else range(dist.get_world_size()))
    return Mesh(axis_name, ranks, ranks.index(dist.get_rank()), rank_device(device), group)


def make_row_mesh(group=None, *, device=None) -> Mesh:
    """A ``"rows"`` mesh over ``group``'s ranks (default: every rank)."""
    return _make("rows", group, device)


def make_batch_mesh(group=None, *, device=None) -> Mesh:
    """A ``"batch"`` mesh over ``group``'s ranks (default: every rank)."""
    return _make("batch", group, device)


# ---------------------------------------------------------------------------
# a problem's row block: the local view a rank of a row mesh solves
# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to(device, copy=False):
    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device, copy=copy)
        return (torch.tensor if copy else torch.as_tensor)(np.asarray(a), device=device)

    return leaf


def _on_whole(fn, full, rows=None):
    """``fn`` (its last argument the data) called on the whole data, and
    cut to the rank's ``rows`` when given."""
    if fn is None:
        return None
    if rows is None:
        return lambda *a: fn(*a[:-1], full)
    return lambda *a: fn(*a[:-1], full)[rows]


def _rows_agree(F_local, F_rows) -> bool:
    """Whether the residual on the rank's rows of the data gave the rank's
    rows of the whole residual: the same shape, and values within 256 ulps
    of the largest |F| (a matmul over fewer rows may round otherwise)."""
    if F_local.shape != F_rows.shape:
        return False
    tol = 256 * torch.finfo(F_rows.dtype).eps * F_rows.abs().amax()
    return bool(((F_local - F_rows).abs() <= tol).all())


def row_block(problem, mesh: Mesh):
    """The rank's view of ``problem`` on a row mesh: ``nequ`` is the rank's
    row count m/k, and the data leaves whose leading axis is ``nequ`` hold
    the rank's rows (scene constants stay whole), all on ``mesh.device``.

    A residual whose row i reads row i of the data alone (the per-residual
    data the JAX package's ``solve_row_sharded`` asks for) runs on the local
    data.  Every rank tells which at ``x0``: it evaluates the residual on the
    whole data and on its rows, and the local path is taken only where every
    rank's local F equals its rows of the whole F.  Any other residual (one
    that reads whole-scene data, as the bundle adjustment's projection of
    every point, or a sum over the rows) runs on the whole data and keeps
    the rank's rows of F, as GSPMD computes the global residual in JAX.  An
    error of the residual on the whole data is raised; one on the rows alone
    only means "not row-local".  Constraints always see the whole data, as
    they do in JAX."""
    if problem.data is None:
        raise ValueError(
            "row-sharded solve needs per-residual `data` (leading axis = nequ) "
            "to define the row partition"
        )
    m = problem.nequ
    rows = mesh.block(m, "row-sharded solve")
    dev = mesh.device
    # the rank's rows are copies: the whole data stays on the device only
    # where a residual or the constraints need it
    local = _tree_map(lambda a: _to(dev, copy=True)(a[rows] if np.ndim(a) >= 1 and np.shape(a)[0] == m else a),
                      problem.data)
    full = _tree_map(_to(dev), problem.data)
    x0 = problem.x0.to(dev)
    F_rows = problem.residual(x0, full)[rows]
    try:
        separable = _rows_agree(problem.residual(x0, local), F_rows)
    except (RuntimeError, IndexError, ValueError):
        separable = False
    separable = not bool(mesh.any(torch.tensor([not separable], device=dev))[0])
    if separable and problem.ncon == 0:
        full = None
    mloc = rows.stop - rows.start
    res, jac, hrw = problem.residual, problem.jac_residual, problem.hess_residual_weighted
    if not separable:
        # the derivatives of the rank's rows by autodiff of the cut residual
        res, jac, hrw = _on_whole(res, full, rows), None, None

    def on(t):
        return None if t is None else t.to(dev)

    return dataclasses.replace(
        problem, residual=res, nequ=mloc, x0=x0, data=local, y0=on(problem.y0),
        lcon=on(problem.lcon), ucon=on(problem.ucon), jac_residual=jac,
        hess_residual_weighted=hrw, cons=_on_whole(problem.cons, full),
        jac_cons=_on_whole(problem.jac_cons, full),
        hess_cons_weighted=_on_whole(problem.hess_cons_weighted, full),
    )
