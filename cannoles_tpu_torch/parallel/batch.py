"""Instance-batch solves: ``vsolve`` and the rescue of unsolved lanes.

Port of ``cannoles_tpu/parallel/batch.py``.  The batch runs through the
batch-native solver (``CaNNOLeSSolver.run``), in sequential chunks when
``chunk_size`` asks for them, or chunk by chunk against a wall-clock
budget (``max_time``).  A diverging lane cannot stall or kill the batch:
every lane carries its own status.

``mesh=`` (a batch mesh, ``parallel/mesh.py``) splits the lanes over the
ranks: every rank is given the whole batch, as JAX's global array, solves
its B/k lanes on its own device through the same path (rescue included)
and gets the whole ``BatchResult`` back, the same on every rank
(``_gather_lanes``).

``mesh=`` may also be a 2-D mesh (``make_mesh_2d``): the lanes split over
its ``batch`` axis as above, and each lane's residual rows over its
``rows`` axis.  The solver holds the rank's row block
(``CaNNOLeSSolver(mesh=rows)``, the condensed KKT, eagerly) and reduces
each lane's sums over the row group; the data batch is cut to the rank's
rows only where ``row_block`` chose the local residual
(``row_block_batch``).  The gather runs over the batch axis alone.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import time
import warnings
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.solver import (
    TENSOR_FIELDS,
    CaNNOLeSSolver,
    SolverState,
    _check_available_method,
    resolve_auto,
)
from ..core.status import Status
from ..ops.fused_ldlt import max_n
from ..problem import NLSProblem
from ..utils.convert import tree_to_torch
from ..utils.spans import count, span
from .mesh import Mesh, Mesh2D, make_batch_mesh, make_mesh_2d, row_block_batch

__all__ = ["vsolve", "BatchResult", "make_batch_mesh", "make_mesh_2d"]


@dataclasses.dataclass
class BatchResult:
    """Batched terminal states + host-side summary accessors."""

    states: SolverState  # every tensor has a leading batch axis
    solver: Optional[CaNNOLeSSolver] = None

    @property
    def solution(self):
        return self.states.x.cpu().numpy()

    @property
    def multipliers(self):
        return self.states.lam.cpu().numpy()

    @property
    def status(self):
        return self.states.status.cpu().numpy()

    @property
    def objective(self):
        return self.states.fx.cpu().numpy()

    @property
    def iterations(self):
        return self.states.iter.cpu().numpy()

    @property
    def dual_feas(self):
        return self.states.normdual.cpu().numpy()

    def solved_mask(self) -> np.ndarray:
        return _solved(self.status)

    def summary(self) -> Dict[str, Any]:
        st = self.status
        return {
            "n": int(st.shape[0]),
            "solved": int(self.solved_mask().sum()),
            "first_order": int((st == Status.FIRST_ORDER).sum()),
            "small_residual": int((st == Status.SMALL_RESIDUAL).sum()),
            "exception": int((st == Status.EXCEPTION).sum()),
            "mean_iter": float(self.iterations.mean()),
            "max_iter": int(self.iterations.max()),
        }


def _tree_index(tree, idx):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_index(v, idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_index(v, idx) for v in tree)
    return tree[idx]


def _concat_states(parts, data):
    return SolverState(
        **{f: torch.cat([getattr(s, f) for s in parts], 0) for f in TENSOR_FIELDS}, data=data
    )


# vsolve calls since the process started: each call's number
_CALLS = itertools.count()


def _spanned(fn):
    """``vsolve`` as the span ``cannoles.vsolve``, with B, the requested
    ``chunk_size`` and the call's number in the process."""
    @functools.wraps(fn)
    def call(problem, x0_batch, *args, **kwargs):
        with span("cannoles.vsolve", {"call": next(_CALLS), "B": len(x0_batch),
                                      "chunk_size": kwargs.get("chunk_size") or 0}):
            return fn(problem, x0_batch, *args, **kwargs)

    return call


@_spanned
def vsolve(
    problem: NLSProblem,
    x0_batch,
    lam0_batch=None,
    data_batch=None,
    *,
    solver: Optional[CaNNOLeSSolver] = None,
    method: str = "newton",
    linsolve: str = "auto",
    kkt: str = "auto",
    mesh: Optional[Union[Mesh, Mesh2D]] = None,
    max_iter: int = 100,
    chunk_size: Optional[int] = None,
    max_time: Optional[float] = None,
    rescue: bool = False,
    dtype: Optional[torch.dtype] = None,
    device=None,
    **numeric,
) -> BatchResult:
    """Solve a batch of instances of one problem family.

    ``x0_batch``: (B, nvar).  ``data_batch``: optional pytree whose leaves
    carry a leading B axis.  ``dtype``/``device`` place the solver built
    here (default: those of ``problem.x0``, or ``mesh.device`` with a
    mesh); with ``solver`` given, its own are used.  Inputs are moved
    there; numpy data leaves become tensors.

    ``mesh``: a batch mesh; every rank calls ``vsolve`` with the whole batch
    (B must divide evenly over the ranks), solves its own contiguous B/k
    lanes and returns the whole result.  ``chunk_size`` is ignored under a
    mesh (with a warning), and ``max_time`` requires ``mesh=None``.  With
    a 2-D mesh the ranks of a row group solve the same lanes, each on its
    rows (m must divide evenly too), under a solver on the row axis
    (``kkt='auto'`` means the condensed system there; a given solver
    without a mesh is rebuilt on it); the result's row-sized fields (``Fx``,
    ``JxT``, ``r``, the residual part of ``primal``) hold the rank's rows.

    ``linsolve='auto'`` takes the fused LDLᵀ kernel ('pallas') where the
    KKT size fits the kernel's cap (``ops.fused_ldlt.max_n``), else the
    JAX package's fallbacks ('chol' on a condensed Gauss–Newton/LM system,
    or 'ldlt').  ``chunk_size``: run the batch in
    sequential chunks of this many lanes (it must divide B).

    ``max_time``: wall-clock budget in seconds, checked between chunks
    (``chunk_size`` lanes each, default ``min(B, 1024)``, the last chunk
    may be shorter): after each chunk the card is synchronized and the
    clock read, and once the budget is spent the lanes of the chunks not
    dispatched are initialized in one batch and stamped ``max_time``
    (unless the initialization already ended them).  Accuracy is ± one
    chunk's solve time.

    ``rescue``: re-solve the unsolved lanes from their original starts and
    merge them back: stage 0 re-runs budget-limited lanes (stalled,
    max_iter, max_eval) on the same solver, stage 1 re-runs the rest with
    the backward-error gate forced on (skipped when the solver already runs
    gated), stage 2 sends what is still unsolved to the exact-inertia
    ``eigh`` backend.  Every rescue pass lifts the eval and inner budgets
    to the reference's (max_eval=100000, max_inner=10000).  Under
    ``max_time`` the rescue runs only while budget remains, and only on
    lanes that were dispatched.

    Each call is a span ``cannoles.vsolve`` (``utils/spans.py``) with B,
    ``chunk_size`` and the call's number in the process; the spans of its
    chunks (``cannoles.chunk``, k of K), runs and rescue lie inside it.
    """
    problem.validate_for_solve()
    rows = None
    if isinstance(mesh, Mesh2D):
        mesh, rows = mesh.batch, mesh.rows
        if kkt == "auto":
            kkt = "condensed"
    if mesh is not None and device is None:
        device = mesh.device
    if solver is None:
        method_r = _check_available_method(method)
        if kkt == "auto":
            _, kkt, _ = resolve_auto(problem, method_r, "auto", "auto")
        if linsolve == "auto":
            n, m, p = problem.nvar, problem.nequ, problem.ncon
            N = (n + p) if kkt == "condensed" else (n + m + p)
            if N <= max_n(problem.x0.dtype if dtype is None else dtype):
                linsolve = "pallas"
            elif kkt == "condensed" and method_r in ("gauss_newton", "lm"):
                linsolve = "chol"
            else:
                linsolve = "ldlt"
        solver = CaNNOLeSSolver(
            problem, method=method, linsolve=linsolve, kkt=kkt, dtype=dtype,
            device=None if rows is not None else device, mesh=rows,
        )
    elif rows is not None and solver.mesh != rows:
        solver = solver._rebuilt(problem, rows)
    dev, dt = solver.device, solver.dtype
    x0_batch = torch.as_tensor(x0_batch).to(dtype=dt, device=dev)
    B = x0_batch.shape[0]
    if lam0_batch is None:
        lam0_batch = problem.y0.to(dtype=dt, device=dev).expand(B, problem.ncon)
    lam0_batch = torch.as_tensor(lam0_batch).to(dtype=dt, device=dev)
    data_batch = tree_to_torch(data_batch, device=dev, dtype=dt)
    whole = data_batch
    if rows is not None:
        data_batch = row_block_batch(data_batch, problem, solver.problem, rows)
    cfg = solver.make_config(max_iter=max_iter, **numeric)

    if max_time is not None:
        if mesh is not None:
            raise ValueError(
                "vsolve(max_time=...) requires mesh=None: the budget is "
                "enforced by host-driven chunk dispatch"
            )
        result, remaining = _vsolve_deadline(
            solver, x0_batch, lam0_batch, data_batch, cfg, chunk_size, max_time
        )
        if rescue and remaining > 0:
            # lanes stamped max_time were never run: the budget spoke for them
            result = _rescue_unsolved(
                solver, result, x0_batch, lam0_batch, data_batch, cfg,
                skip_stage1=solver.quality_gate, eligible=result.status != Status.MAX_TIME,
            )
        return result

    use_chunks = (
        chunk_size is not None and mesh is None and B % chunk_size == 0 and B > chunk_size
    )
    if chunk_size is not None and not use_chunks and not (mesh is None and chunk_size == B):
        why = "mesh is set" if mesh is not None else (
            f"chunking requires chunk_size < B dividing B, B={B}"
        )
        warnings.warn(
            f"vsolve: chunk_size={chunk_size} ignored ({why}); running the whole batch at once",
            stacklevel=2,
        )
    if mesh is not None:
        lanes = mesh.block(B, "vsolve(mesh=...)")
        x0_l, lam0_l = x0_batch[lanes], lam0_batch[lanes]
        data_l = _tree_index(data_batch, lanes)
        part = BatchResult(states=solver.run(x0_l, lam0_l, cfg, data_l), solver=solver)
        if rescue:
            part = _rescue_unsolved(
                solver, part, x0_l, lam0_l, data_l, cfg, skip_stage1=solver.quality_gate,
                problem=problem if solver.mesh is not None else None,
            )
        states = _gather_lanes(part.states, mesh, B, lanes, whole)
        return BatchResult(states=states, solver=solver)
    if use_chunks:
        parts = []
        for lo in range(0, B, chunk_size):
            sl = slice(lo, lo + chunk_size)
            with span("cannoles.chunk", {"k": lo // chunk_size, "of": B // chunk_size, "lanes": chunk_size}):
                parts.append(
                    solver.run(x0_batch[sl], lam0_batch[sl], cfg, _tree_index(data_batch, sl))
                )
        states = _concat_states(parts, data_batch)
    else:
        states = solver.run(x0_batch, lam0_batch, cfg, data_batch)
    result = BatchResult(states=states, solver=solver)
    if rescue:
        result = _rescue_unsolved(
            solver, result, x0_batch, lam0_batch, data_batch, cfg,
            skip_stage1=solver.quality_gate,
        )
    return result


def _gather_lanes(part: SolverState, mesh: Mesh, B: int, lanes: slice, data) -> SolverState:
    """The whole batch's state on every rank from each rank's ``lanes``: one
    all-reduce SUM of a zero-filled (B, ·) int64 buffer into which each rank
    writes the bits of its own lanes (float32 and int32 fields widened from
    their int32 bits, float64 fields as their int64 bits, booleans as 0/1).
    A sum of one lane's bits and zeros is those bits, so the gather is exact
    (NaN payloads and the sign of zero included) and needs no all_gather,
    which gloo does not offer on CUDA tensors."""
    cols = []
    for f in TENSOR_FIELDS:
        t = getattr(part, f)
        flat = t.reshape(t.shape[0], -1)
        if t.dtype == torch.float64:
            flat = flat.view(torch.int64)
        elif t.dtype == torch.float32:
            flat = flat.view(torch.int32)
        cols.append(flat.to(torch.int64))
    local = torch.cat(cols, 1)
    buf = local.new_zeros((B, local.shape[1]))
    buf[lanes] = local
    buf = mesh.sum(buf)
    out, lo = {}, 0
    for f, c in zip(TENSOR_FIELDS, cols):
        t = getattr(part, f)
        v = buf[:, lo:lo + c.shape[1]]
        lo += c.shape[1]
        if t.dtype == torch.bool:
            v = v != 0
        elif t.dtype == torch.float64:
            v = v.contiguous().view(torch.float64)
        elif t.dtype == torch.float32:
            v = v.to(torch.int32).view(torch.float32)
        else:
            v = v.to(t.dtype)
        out[f] = v.reshape((B,) + t.shape[1:])
    return SolverState(**out, data=data)


def _rescue_unsolved(
    solver, result, x0_batch, lam0_batch, data_batch, cfg, skip_stage1=False, eligible=None,
    problem=None,
):
    """Three-stage re-solve of the unsolved lanes, merged back in place.

    Stage 0: budget-limited lanes (stalled / max_iter / max_eval) on the
    primary solver: they need budget, not another backend.  Stage 1: the
    same backend with the backward-error gate forced on (skipped when the
    solver already runs gated).  Stage 2: the exact-inertia ``eigh``
    backend.  The eval/inner budgets are lifted to the reference's in every
    stage.  ``eligible``: an optional boolean lane mask restricting which
    unsolved lanes may be rescued (deadline dispatch excludes lanes never
    run).  The siblings keep the primary solver's options (its
    ``matmul_precision`` and row mesh too) and are cached on it; a solver
    on a row mesh passes the whole ``problem``, which its siblings cut as
    it was cut.  The JAX package
    pads each subset to a power of two to bound its compiled shapes; here
    the subset runs at its own size, and the merge is an ``index_copy``
    into the full state."""
    dev = solver.device
    cfg = cfg._replace(
        max_eval=torch.tensor(100000, dtype=torch.int32, device=dev),
        max_inner=torch.tensor(10000, dtype=torch.int32, device=dev),
    )

    def _pass(res, sibling, stage, only=None):
        bad = ~_solved(_status(res))
        if eligible is not None:
            bad &= eligible
        if only is not None:
            bad &= only
        idx_np = np.nonzero(bad)[0]
        if idx_np.size == 0:
            return res
        count(("rescue_lanes", stage), idx_np.size)
        with span(_STAGE_SPANS[stage], {"lanes": idx_np.size}):
            idx = torch.as_tensor(idx_np, device=dev)
            sub = sibling.run(
                x0_batch[idx], lam0_batch[idx], cfg, _tree_index(data_batch, idx)
            )
            full = res.states
            merged = full._replace(
                **{f: getattr(full, f).index_copy(0, idx, getattr(sub, f)) for f in TENSOR_FIELDS}
            )
        return BatchResult(states=merged, solver=res.solver)

    cache = solver.__dict__.setdefault("_rescue_siblings", {})

    def _sibling(kind):
        sib = cache.get(kind)
        if sib is None:
            common = dict(
                method=solver.method,
                kkt=solver.kkt,
                use_initial_multiplier=solver.use_initial_multiplier,
                always_accept_extrapolation=solver.always_accept_extrapolation,
                lm_damping=solver.lm_damping,
                multiplier_refit=solver.multiplier_refit,
                block_size=solver.block_size,
                params=solver.params,
                matmul_precision=solver.matmul_precision,
                dtype=solver.dtype,
                device=solver.device,
                mesh=solver.mesh,
            )
            whole = solver.problem if problem is None else problem
            if kind == "gated":
                sib = CaNNOLeSSolver(
                    whole,
                    linsolve=solver.linsolve,
                    quality_gate=True,
                    robust_fallback=solver.robust_fallback,
                    **common,
                )
            else:
                sib = CaNNOLeSSolver(whole, linsolve="eigh", **common)
            if solver.route == "eager":  # a solver put on the eager route keeps its siblings there
                sib.route, sib.route_reason = solver.route, solver.route_reason
            cache[kind] = sib
        return sib

    with span("cannoles.rescue", {"B": len(x0_batch)}):
        budget_lanes = np.isin(
            _status(result), (int(Status.STALLED), int(Status.MAX_ITER), int(Status.MAX_EVAL))
        )
        if budget_lanes.any():
            result = _pass(result, solver, "stage0", only=budget_lanes)
        if not skip_stage1:
            result = _pass(result, _sibling("gated"), "stage1")
        if (~_solved(_status(result))).any():
            result = _pass(result, _sibling("eigh"), "stage2")
    return result


_STAGE_SPANS = {"stage0": "cannoles.rescue.stage0", "stage1": "cannoles.rescue.stage1",
                "stage2": "cannoles.rescue.stage2"}


def _status(res: BatchResult) -> np.ndarray:
    """The lanes' statuses read on the host for the rescue: one sync, a span
    ``cannoles.host_read`` counted at ``rescue.status``."""
    with span("cannoles.host_read"):
        count(("host_syncs", "rescue.status"))
        return res.status


def _solved(status: np.ndarray) -> np.ndarray:
    return (status == Status.FIRST_ORDER) | (status == Status.SMALL_RESIDUAL)


def _vsolve_deadline(solver, x0_batch, lam0_batch, data_batch, cfg, chunk_size, max_time):
    """Chunks dispatched from the host, with the wall-clock deadline read
    between them (after a ``torch.cuda.synchronize()`` on the card).  The
    lanes of the chunks never dispatched get one batched ``_init_state`` (one
    residual and constraint evaluation, for an honest terminal state) and
    ``Status.MAX_TIME`` unless the initialization already ended them.
    Returns ``(BatchResult, remaining budget in seconds)``."""
    B = x0_batch.shape[0]
    chunk = min(B, 1024 if chunk_size is None else int(chunk_size))
    on_card = solver.device.type == "cuda"
    t0 = time.perf_counter()
    parts, lo = [], 0
    while lo < B:
        sl = slice(lo, min(lo + chunk, B))
        parts.append(solver.run(x0_batch[sl], lam0_batch[sl], cfg, _tree_index(data_batch, sl)))
        lo = sl.stop
        if on_card:
            torch.cuda.synchronize(solver.device)
        if time.perf_counter() - t0 > max_time:
            break
    if lo < B:
        sl = slice(lo, B)
        with solver._matmul_scope():
            st = solver._init_state(x0_batch[sl], lam0_batch[sl], cfg, _tree_index(data_batch, sl))
        unknown = st.status == Status.UNKNOWN
        parts.append(st._replace(
            status=torch.where(unknown, torch.full_like(st.status, int(Status.MAX_TIME)), st.status)
        ))
    if on_card:
        torch.cuda.synchronize(solver.device)
    remaining = max_time - (time.perf_counter() - t0)
    return BatchResult(states=_concat_states(parts, data_batch), solver=solver), remaining
