"""BASELINE config 4: one large dense NLS, Gauss–Newton with the condensed
(Schur) reduction.

Port of ``benchmarks/bench_large.py``.  The problem is its draw
(``models.families.large_rung_problem``: ``default_rng(0)``, B1 and B2
float32 draws over √n, F(x) = B1 x + 0.1 sin(B2 x) − y with y at x_true,
x0 = 0), float32, solved with its settings: ``method="gauss_newton"``,
``kkt="condensed"``, ``linsolve="chol"``, ``block_size=128``,
``max_iter=30``.  The JAX script times its jitted run twice (compile + run,
then run); here the batch-native ``CaNNOLeSSolver.run`` runs twice on one
solver, the first with its one-time costs (graph captures on the card),
each ended by a ``torch.cuda.synchronize()``.

``--shard K`` runs ``solve_row_sharded`` over K spawned ranks
(``parallel.launch``; gloo where ranks share a card), twice on one solver
per rank; each wall is the slowest rank's, between barriers.  With K
ranks on one card this checks the sharded program, not scaling.

    python -m cannoles_tpu_torch.bench_large [-m M] [-n N] [--shard K] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["run", "run_sharded", "main"]

SETTINGS = dict(method="gauss_newton", kkt="condensed", linsolve="chol", block_size=128)
MAX_ITER = 30


def _sync(dev, group=None):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def _row(st, x_true, walls) -> dict:
    """Counters, error and walls of a solve's batch-of-one state."""
    from .core.status import status_name

    x = st.x[0].cpu().numpy()
    return dict(status=status_name(int(st.status[0])), iter=int(st.iter[0]), nfact=int(st.nfact[0]),
                nlinsolve=int(st.nlinsolve[0]), err=float(np.abs(x - x_true).max()),
                cold_s=walls[0], warm_s=walls[1], x=x)


def run(m: int = 10_240, n: int = 1024, device=None) -> dict:
    """The one-process solve, twice (cold, warm) on one solver; ``device``
    None is the card."""
    from .core.solver import CaNNOLeSSolver, _add_batch_axis
    from .models.families import large_rung_problem

    pb, x_true, _ = large_rung_problem(m, n, dtype=torch.float32, device=device)
    dev = pb.x0.device
    s = CaNNOLeSSolver(pb, dtype=torch.float32, **SETTINGS)
    cfg = s.make_config(max_iter=MAX_ITER)
    data = _add_batch_axis(pb.data, dev)
    walls = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        st = s.run(pb.x0[None], pb.y0[None], cfg, data)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    return dict(m=m, n=n, ranks=1, device=str(dev), route=s.route, **_row(st, x_true, walls))


def _shard_rank(m: int, n: int, device=None) -> dict:
    """One rank of :func:`run_sharded`."""
    import torch.distributed as dist

    from .core.solver import CaNNOLeSSolver
    from .models.families import large_rung_problem
    from .parallel.mesh import make_row_mesh
    from .parallel.schur import solve_row_sharded

    mesh = make_row_mesh(device=device)
    dev = mesh.device
    pb, x_true, _ = large_rung_problem(m, n, dtype=torch.float32, device=dev)
    s = CaNNOLeSSolver(pb, dtype=torch.float32, mesh=mesh, **SETTINGS)
    walls = []
    for _ in range(2):
        _sync(dev, mesh.group if dist.is_initialized() else None)
        t0 = time.perf_counter()
        st = solve_row_sharded(pb, mesh, solver=s, max_iter=MAX_ITER)
        _sync(dev, mesh.group if dist.is_initialized() else None)
        walls.append(time.perf_counter() - t0)
    x = np.asarray(st.solution)
    ss = st.solver_specific
    return dict(status=st.status, iter=st.iter, nfact=ss["nfact"], nlinsolve=ss["nlinsolve"],
                err=float(np.abs(x - x_true).max()), cold_s=walls[0], warm_s=walls[1], x=x, device=str(dev))


def run_sharded(k: int, m: int = 10_240, n: int = 1024, device=None) -> dict:
    """``solve_row_sharded`` over k spawned ranks, twice on one solver per
    rank; the walls are the slowest rank's.  Raises where the ranks
    disagree."""
    from .parallel.launch import launch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_large runs on the card by default; pass device=\"cpu\"")
    ranks = launch(_shard_rank, int(k), m, n, None if device is None else str(device))
    r0 = ranks[0]
    keys = ("status", "iter", "nfact", "nlinsolve")
    for r in ranks[1:]:
        if [r[q] for q in keys] != [r0[q] for q in keys] or not np.array_equal(r["x"], r0["x"]):
            raise AssertionError(f"bench_large --shard {k}: rank results differ")
    shared = r0["device"].startswith("cuda") and int(k) > torch.cuda.device_count()
    return dict(r0, m=m, n=n, ranks=int(k), cold_s=max(r["cold_s"] for r in ranks),
                warm_s=max(r["warm_s"] for r in ranks), ranks_share_card=shared)


def _line(r) -> str:
    what = f"sharded over {r['ranks']} ranks" if r["ranks"] > 1 else "one process"
    return (f"{r['m']}x{r['n']} ({what}, {r['device']}): cold={r['cold_s']:.3f}s warm={r['warm_s'] * 1e3:.1f}ms "
            f"status={r['status']} iters={r['iter']} nfact={r['nfact']} err={r['err']:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-m", type=int, default=10_240)
    ap.add_argument("-n", type=int, default=1024)
    ap.add_argument("--shard", type=int, default=0, metavar="K", help="row-shard over K spawned ranks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_large: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = None if args.device == "cuda" else "cpu"
    if args.shard:
        r = run_sharded(args.shard, args.m, args.n, device)
    else:
        r = run(args.m, args.n, device)
    if args.device == "cuda":
        r["device_name"] = torch.cuda.get_device_name(0)
    print(_line(r), flush=True)
    print(json.dumps({k: v for k, v in r.items() if k != "x"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
