"""A minimal launcher of k SPMD ranks on one host.

The counterpart of the JAX tests' virtual devices: :func:`launch` starts k
processes (``torch.multiprocessing``, start method ``spawn``), joins them in
one process group through a ``file://`` rendezvous in a temporary directory,
runs the same picklable callable on each and returns each rank's picklable
result, rank 0 first.  The backend follows ``parallel.mesh.backend_for``:
``cpu:gloo,cuda:nccl`` when each rank can have a card of its own, else
``gloo``; either reduces CPU tensors too, so a rank may solve on the CPU.

Each rank runs with one intra-op thread (k ranks share the host's cores) and
``LOCAL_RANK`` set to its rank; where CUDA is available its current device is
``parallel.mesh.rank_device()``, ``cuda:{r % device count}``.  Where a rank
solves is its program's choice (``make_row_mesh(device=...)``).  A rank that raises fails the launch with its
traceback (the other ranks are stopped); a collective that waits longer than
``TIMEOUT_S`` raises in its rank, so ranks that disagree fail instead of
hanging.  A rank never imports JAX: the
callable must live in a module that does not import it at top level, and
each rank checks ``sys.modules`` before and after the call.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import sys
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for, rank_device

__all__ = ["launch", "TIMEOUT_S"]

TIMEOUT_S = 600.0


def _no_jax(rank: int, when: str):
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} has jax in sys.modules ({when}): the port's ranks never import JAX")


def _rank_main(rank, nprocs, fn, args, tmp):
    _no_jax(rank, "after unpickling the callable")
    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    backend = backend_for(nprocs)
    card = rank_device() if torch.cuda.is_available() else None
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend,
        init_method=(pathlib.Path(tmp) / "rendezvous").as_uri(),
        world_size=nprocs,
        rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        # NCCL binds each rank to its card (else it guesses one at a barrier)
        device_id=card if "nccl" in backend else None,
    )
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    _no_jax(rank, "after the call")
    out = pathlib.Path(tmp) / f"rank{rank}.pkl"
    out.with_suffix(".tmp").write_bytes(pickle.dumps(result))
    os.replace(out.with_suffix(".tmp"), out)


def launch(fn: Callable, nprocs: int, *args) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` ranks; returns their results in rank
    order."""
    with tempfile.TemporaryDirectory(prefix="cannoles_ranks_") as tmp:
        mp.spawn(_rank_main, args=(nprocs, fn, args, tmp), nprocs=nprocs, join=True)
        return [pickle.loads((pathlib.Path(tmp) / f"rank{r}.pkl").read_bytes()) for r in range(nprocs)]
