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

:func:`make_mesh_2d` lays nb × nr ranks out as JAX's ``devs.reshape(nb,
nr)`` with axes ``("batch", "rows")``: rank r sits at (r // nr, r % nr).
Its ``batch`` axis joins the ranks with the same row index (they hold
different instance lanes), its ``rows`` axis the ranks with the same batch
index (they hold the row blocks of the same lanes).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh", "Mesh2D", "make_row_mesh", "make_batch_mesh", "make_mesh_2d", "backend_for", "rank_device",
    "row_block", "row_block_batch",
]


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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's two axes of an nb × nr mesh: ``batch`` splits instance
    lanes, ``rows`` splits each instance's residual rows."""

    batch: Mesh
    rows: Mesh

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.batch.size, self.rows.size)

    @property
    def device(self) -> torch.device:
        return self.rows.device


def make_mesh_2d(nb: int = 1, nr: int = 1, *, device=None) -> Optional[Mesh2D]:
    """The (batch × rows) mesh over the first nb·nr ranks of the default
    group, rank r at (r // nr, r % nr).  Every rank of the group must call
    it (each makes every axis group, in the same order); a rank beyond the
    first nb·nr gets None.  Without a process group only nb = nr = 1 is
    possible: a 1 × 1 mesh whose collectives are the identity."""
    nb, nr = int(nb), int(nr)
    if nb < 1 or nr < 1:
        raise ValueError(f"make_mesh_2d: nb and nr must be positive, got {nb} x {nr}")
    if not dist.is_initialized():
        if nb * nr != 1:
            raise ValueError(f"make_mesh_2d({nb}, {nr}) needs {nb * nr} ranks: no process group is initialised")
        return Mesh2D(_make("batch", None, device), _make("rows", None, device))
    world, me = dist.get_world_size(), dist.get_rank()
    if nb * nr > world:
        raise ValueError(f"make_mesh_2d({nb}, {nr}) needs {nb * nr} ranks, the group has {world}")
    # collectives: every rank makes every group, the row groups first
    rows = [dist.new_group([b * nr + r for r in range(nr)]) for b in range(nb)]
    batch = [dist.new_group([b * nr + r for b in range(nb)]) for r in range(nr)]
    if me >= nb * nr:
        return None
    b, r = divmod(me, nr)
    return Mesh2D(_make("batch", batch[r], device), _make("rows", rows[b], device))


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


def _rows_of(fn, rows):
    """``fn`` on the data it is given (the whole data), cut to ``rows``."""
    return lambda *a: fn(*a)[rows]


def _on_cut(fn, cut):
    """``fn`` (its last argument the data) on ``cut`` of the data it is given."""
    if fn is None:
        return None
    return lambda *a: fn(*a[:-1], cut(a[-1]))


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
    they do in JAX: with constraints the problem keeps the whole data, and a
    row-local residual (with its derivatives) takes its rows of the data it
    is handed."""
    if problem.data is None:
        raise ValueError(
            "row-sharded solve needs per-residual `data` (leading axis = nequ) "
            "to define the row partition"
        )
    m = problem.nequ
    rows = mesh.block(m, "row-sharded solve")
    dev = mesh.device
    def cut(data):
        return _tree_map(lambda a: a[rows] if np.ndim(a) >= 1 and np.shape(a)[0] == m else a, data)

    # the rank's rows are copies: the whole data stays on the device only
    # where a residual or the constraints need it
    local = _tree_map(_to(dev, copy=True), cut(problem.data))
    full = _tree_map(_to(dev), problem.data)
    x0 = problem.x0.to(dev)
    F_rows = problem.residual(x0, full)[rows]
    try:
        separable = _rows_agree(problem.residual(x0, local), F_rows)
    except (RuntimeError, IndexError, ValueError):
        separable = False
    separable = not bool(mesh.any(torch.tensor([not separable], device=dev))[0])
    mloc = rows.stop - rows.start
    res, jac, hrw = problem.residual, problem.jac_residual, problem.hess_residual_weighted
    # the constraints always read the whole data the solver hands them
    if separable and problem.ncon == 0:
        data = local
    elif separable:
        data, res, jac, hrw = full, _on_cut(res, cut), _on_cut(jac, cut), _on_cut(hrw, cut)
    else:
        # the derivatives of the rank's rows by autodiff of the cut residual
        data, res, jac, hrw = full, _rows_of(res, rows), None, None

    def on(t):
        return None if t is None else t.to(dev)

    return dataclasses.replace(
        problem, residual=res, nequ=mloc, x0=x0, data=data, y0=on(problem.y0),
        lcon=on(problem.lcon), ucon=on(problem.ucon), jac_residual=jac,
        hess_residual_weighted=hrw,
    )


def row_block_batch(data_batch, problem, block, mesh: Mesh):
    """A batch of ``problem``'s data (leaves with a leading lane axis) as
    ``block = row_block(problem, mesh)`` reads it: each leaf whose template
    leaf ``row_block`` cut to the rank's rows is cut on its row axis (axis
    1); the others, and every leaf where ``row_block`` chose the whole data,
    stay whole.  Cutting a leaf ``row_block`` kept whole would hand the
    residual or the constraints a part of the data they read whole."""
    rows = mesh.block(problem.nequ, "row-sharded solve")

    def walk(batch, whole, local):
        if batch is None:
            return None
        if isinstance(batch, dict):
            return {k: walk(batch[k], whole[k], local[k]) for k in batch}
        if isinstance(batch, (list, tuple)):
            return type(batch)(walk(*t) for t in zip(batch, whole, local))
        if np.shape(local) == np.shape(whole):
            return batch
        if np.shape(batch)[1:] != np.shape(whole):
            raise ValueError(f"data_batch leaf of shape {tuple(np.shape(batch))} is not a batch of the "
                             f"problem's leaf of shape {tuple(np.shape(whole))}")
        return batch[:, rows].contiguous()

    return walk(data_batch, problem.data, block.data)
