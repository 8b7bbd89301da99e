"""Multi-process execution: distributed init, the global mesh, batch
statistics and the scaling harness (BASELINE config 5).

Port of ``cannoles_tpu/parallel/multihost.py`` on ``torch.distributed``: one
process per rank (SPMD), every rank calling the same functions.  The JAX
package's psum over a sharded batch becomes an explicit all-reduce of each
rank's lanes.  Rows of :func:`scaling_bench` taken with several ranks on one
card are labelled ``"mesh": "one_card_shared"`` by their caller: they check
the sharded program, they do not measure scaling.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.solver import CaNNOLeSSolver
from ..core.status import Status
from ..problem import NLSProblem
from ..utils.convert import tree_to_torch
from .batch import _tree_index
from .launch import TIMEOUT_S
from .mesh import Mesh, backend_for, make_batch_mesh

__all__ = [
    "init_distributed",
    "global_batch_mesh",
    "batch_convergence_stats",
    "scaling_bench",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the default process group: ``tcp://coordinator_address`` with
    ``num_processes`` ranks, this one ``process_id``; with no address,
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` sets them).  A no-op when the group is already up or
    the process runs alone (no address and ``WORLD_SIZE`` unset or 1).  The
    backend follows ``parallel.mesh.backend_for``."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return
        init, rank = "env://", None
    else:
        world, rank = int(num_processes), int(process_id)
        init = f"tcp://{coordinator_address}"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dist.init_process_group(
        backend_for(local), init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )


def global_batch_mesh(axis_name: str = "batch", *, device=None) -> Mesh:
    """1-D mesh over every rank of the default group."""
    mesh = make_batch_mesh(device=device)
    return mesh if axis_name == mesh.axis_name else Mesh(axis_name, mesh.ranks, mesh.rank, mesh.device)


def batch_convergence_stats(states, mesh: Mesh) -> Dict:
    """Batch-level convergence statistics as the JAX package's psum pattern:
    each rank sums ``solved``, ``n`` and ``total_iters`` and takes the max of
    ``normdual`` over its own lanes of ``states`` (the whole batch, as
    ``vsolve(mesh=...)`` returns it on every rank), then one all-reduce SUM
    and one all-reduce MAX.  Returns the same dict on every rank."""
    lanes = mesh.block(states.status.shape[0], "batch_convergence_stats")
    status, iters, nd = states.status[lanes], states.iter[lanes], states.normdual[lanes]
    solved = (status == Status.FIRST_ORDER) | (status == Status.SMALL_RESIDUAL)
    counts = torch.stack([solved.sum(), torch.tensor(status.shape[0], device=status.device),
                          iters.to(torch.int64).sum()]).to(torch.int64)
    mesh.sum(counts)
    worst = mesh.max(nd.amax().reshape(1))
    return {
        "solved": int(counts[0]),
        "n": int(counts[1]),
        "total_iters": int(counts[2]),
        "max_dual_feas": float(worst[0]),
    }


def scaling_bench(
    problem: NLSProblem,
    x0_batch,
    data_batch=None,
    device_counts: Optional[Sequence[int]] = None,
    *,
    method: str = "lm",
    kkt: str = "condensed",
    max_iter: int = 50,
    reps: int = 3,
    device=None,
) -> List[Dict]:
    """Throughput of the batch solve over the first k ranks of the default
    group, for each k in ``device_counts`` (default: 1, 2, 4, ... up to the
    world size), against the one-rank run.  Every rank calls it; the ranks
    of a k-rank row solve B/k lanes each (``solver.run``, no rescue, as the
    JAX package's vmapped run), the others wait.  A 1-rank baseline row is
    inserted when ``device_counts`` does not start at 1, so efficiency =
    (throughput_k / k) / throughput_1 is always absolute; each row carries
    ``baseline_devices``.  Each time is the slowest rank's, read between a
    ``torch.cuda.synchronize()`` and a barrier on each side; every rank
    returns the same rows."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    device_counts = list(device_counts)
    if device_counts and device_counts[0] != 1:
        device_counts.insert(0, 1)
    if device_counts[-1] > world:
        raise ValueError(f"scaling_bench: {device_counts[-1]} ranks asked, {world} in the group")
    dev = make_batch_mesh(device=device).device
    solver = CaNNOLeSSolver(problem, method=method, kkt=kkt, device=dev)
    x0_batch = torch.as_tensor(np.asarray(x0_batch)).to(dtype=solver.dtype, device=dev)
    B = x0_batch.shape[0]
    lam0 = torch.zeros((B, problem.ncon), dtype=solver.dtype, device=dev)
    data_batch = tree_to_torch(data_batch, device=dev, dtype=solver.dtype)
    cfg = solver.make_config(max_iter=max_iter)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if world > 1:
            dist.barrier()

    results: List[Dict] = []
    base = None
    for k in device_counts:
        args = None
        if rank < k:
            lanes = Mesh("batch", tuple(range(k)), rank, dev).block(B, "scaling_bench")
            args = (x0_batch[lanes], lam0[lanes], cfg, _tree_index(data_batch, lanes))
            solver.run(*args)  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(reps if args else 0):
            solver.run(*args)
        sync()
        dt = torch.tensor([(time.perf_counter() - t0) / reps], dtype=torch.float64, device=dev)
        if world > 1:
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
        dt = float(dt[0])
        thr = B / dt
        if base is None:
            base = thr
        results.append({
            "devices": k,
            "throughput": thr,
            "time": dt,
            "speedup": thr / base,
            "efficiency": (thr / k) / (base / device_counts[0]),
            "baseline_devices": device_counts[0],
        })
    return results
