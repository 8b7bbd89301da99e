"""A cell on k > 1 cards: k ranks, one process and one card each, in lockstep.

The process that ``run.py`` starts has built or loaded the program's kernels
(``harness.main``), so that no two ranks build into one directory.  It then
starts k processes (``multiprocessing``, start method ``spawn``); each joins
the program's process group through the program's own
``parallel.multihost.init_distributed`` (``tcp://localhost:<port>``, a free
port), whose backend rule takes NCCL between cards where each rank has a card
of its own, gloo where ranks share one or run on the CPU.  Rank r solves on
``cuda:r`` (the program's ``rank_device``).

Every rank draws the same bank from the same seeds on its own card, builds
its solver, and runs the same warm pass, window and slice
(``harness.measure``): rank 0 decides at each pass's end whether the window
closes and every rank follows, so that every rank makes as many calls (a rank
with one call more would wait in the program's gather for ever).  The small
messages that keep the ranks in step go over gloo in CPU tensors.
``setup_s`` runs from the start of the process that ``run.py`` started to the
first timed call, after every rank's warm pass; the walls are rank 0's.
``--trace 1`` profiles every rank's slice: the per-layer metrics and the
breakdown read rank 0's, ``device.busy_s`` is the mean over the ranks.

Once the ranks have ended, every rank's outputs must equal rank 0's, by a
digest of every bit (``harness.checksum``), and no rank's process may hold
JAX or the JAX package; else the run prints no result and exits nonzero.
Rank 0's result is printed with the peak memory of the fullest card.  A rank
that raises or dies ends the run at once: the others are killed and the run
exits nonzero; so do ranks that are not done by the deadline
(``deadline_s``).  A rank whose traced slice captured a graph also ends the
run without a result (``harness.report``).
"""

from __future__ import annotations

import multiprocessing
import os
import socket
import sys
import time
import traceback
from multiprocessing.connection import wait

from .harness import EXIT_CAPTURED, EXIT_FORBIDDEN, log, measure, report

__all__ = ["run_ranks", "Team", "deadline_s", "EXIT_RANKS", "EXIT_DIFFER"]

# The ranks' time beside the window: set-up (four ranks of the 102,400-lane
# mix: 33-34 s to the window, H100), the traced slice (under 60 s), the
# judgement (seconds).  Mostly margin: a hang is the only thing it ends.
RANKS_MARGIN_S = 200.0
EXIT_RANKS = 6
EXIT_DIFFER = 7


class Team:
    """This rank's place among the ranks (``harness.Solo`` for one)."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def _flag(self, flag: bool):
        import torch

        return torch.tensor([int(bool(flag))], dtype=torch.int32)  # a CPU tensor: gloo

    def first(self, flag: bool) -> bool:
        import torch.distributed as dist

        t = self._flag(flag)
        dist.broadcast(t, 0)
        return bool(t[0])

    def all(self, flag: bool) -> bool:
        import torch.distributed as dist

        t = self._flag(flag)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t[0])

    def barrier(self):
        self.all(True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, job: dict, prepare, conn):
    """One rank: join the group, set up, measure, send the outcome."""
    os.environ["LOCAL_RANK"] = str(rank)
    import torch
    import torch.distributed as dist

    from . import card
    from .manifest import Manifest

    size, start, phases = job["size"], job["start"], dict(job["phases"])
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))  # the ranks share the host's cores
    device = torch.device("cpu")
    if job["device_type"] == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    from cannoles_tpu_torch.parallel.multihost import init_distributed

    init_distributed(f"localhost:{job['port']}", size, rank)
    try:
        phases["ranks and process group"] = card.since(start)
        args = job["args"]
        cell = Manifest(job["root"]).cell(args.workload)
        if prepare is not None:
            prepare()
        if device.type == "cuda":
            from cannoles_tpu_torch.ops import _native

            _native.load()  # built by the process that started the ranks
        if rank == 0:
            log(f"# cell {cell.name}, seed {args.seed}, {args.seconds} s, trace {args.trace}; "
                f"{size} ranks, backend {dist.get_backend()}, card {card.kind(device)}; torch {torch.__version__}")
        outcome = measure(args, cell, device, job["control"], start, phases, Team(rank, size))
    except BaseException:
        # leave at once, the group untouched: its peers may wait in a
        # collective, and the process that started the ranks ends them
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    conn.send(outcome)
    conn.close()
    dist.destroy_process_group()


def deadline_s(seconds: float) -> float:
    """The seconds the ranks of a run with a window of ``seconds`` may take:
    the window may run a pass over (a pass is under ``seconds`` in every
    cell), so twice the window and the margin."""
    return RANKS_MARGIN_S + 2.0 * seconds


def _wait(procs, conns, deadline: float, limit: float):
    """The ranks' outcomes by rank, or (None, why) once a rank has failed
    or the deadline has passed; every rank has ended when it returns."""
    outcomes, why = {}, None
    readers = {c: r for r, c in enumerate(conns)}
    alive = {p.sentinel: r for r, p in enumerate(procs)}
    while (readers or alive) and why is None:
        ready = wait(list(readers) + list(alive), timeout=max(0.0, deadline - time.monotonic()))
        if not ready:
            why = f"the ranks were not done within {limit:.0f} s"
        for obj in ready:
            if obj in readers:
                r = readers.pop(obj)
                try:
                    outcomes[r] = obj.recv()
                except EOFError:
                    pass
            elif obj in alive:
                r = alive.pop(obj)
                procs[r].join()
                if procs[r].exitcode != 0:
                    why = why or f"rank {r} ended with exit code {procs[r].exitcode}"
    for p in procs:  # a failed run ends every rank at once
        if p.is_alive():
            p.kill()
        p.join()
    if why is None and len(outcomes) < len(procs):
        why = f"ranks {sorted(set(range(len(procs))) - set(outcomes))} ended without an outcome"
    return (None, why) if why else (outcomes, None)


def run_ranks(args, root, cell, device, control, prepare, start: float, phases: dict) -> int:
    """The run of ``cell`` as ``cell.chips`` ranks; returns the exit code."""
    size = cell.chips
    ctx = multiprocessing.get_context("spawn")
    job = dict(args=args, root=str(root), device_type=device.type, control=control, start=start,
               phases=phases, port=_free_port(), size=size)
    procs, conns = [], []
    for r in range(size):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, args=(r, job, prepare, send), name=f"portbench-rank{r}")
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    limit = deadline_s(args.seconds)
    outcomes, why = _wait(procs, conns, time.monotonic() + limit, limit)
    if outcomes is None:
        log(f"# no result: {why}")
        return EXIT_RANKS
    bad = {r: o["forbidden"] for r, o in outcomes.items() if o["forbidden"]}
    if bad:
        log("# no result: " + "; ".join(f"rank {r} holds {', '.join(b)}" for r, b in bad.items()))
        return EXIT_FORBIDDEN
    differ = [r for r, o in outcomes.items() if o["checksum"] != outcomes[0]["checksum"]]
    if differ:
        log(f"# no result: the outputs of ranks {differ} differ from rank 0's "
            f"({', '.join(outcomes[r]['checksum'][:12] for r in sorted(outcomes))})")
        return EXIT_DIFFER
    log(f"# {size} ranks hold the same outputs (sha256 {outcomes[0]['checksum'][:16]})")
    captured = {r: o["slice_capture_s"] for r, o in sorted(outcomes.items()) if o["slice_capture_s"] > 0}
    if captured:
        log("# no result: graph captures inside the traced slice, "
            + ", ".join(f"rank {r} {c:.3f} s" for r, c in captured.items()))
        return EXIT_CAPTURED
    lead = outcomes[0]
    dev = lead["result"]["device"]
    dev["memory_peak_bytes"] = max(o["peak"] for o in outcomes.values())
    if "busy_s" in dev:
        dev["busy_s"] = sum(o["busy_s"] for o in outcomes.values()) / size
    return report(lead)
