"""Stage attribution for the batched bundle-adjustment rung.

The counterpart of ``benchmarks/profile_ba_rung.py``.  The BA rung (256
scenes of 3 cameras and 16 points, condensed KKT N = 73, float32,
Gauss–Newton, the fused LDLᵀ kernel) is solved once through ``vsolve``;
its counts (outer iterations, ``nlinsolve``, ``nfact``, ``neval_F``, mean
and max over the lanes) scale the stages, each timed alone at the solved
iterates:

* ``kernel``: one fused LDLᵀ attempt at (N, B) = (73, 256);
* ``jacobian``: ``F_and_Jt`` (the Jacobian build, init and one per trial);
* ``condensation``: JᵀJ and the condensed KKT assembly;
* ``residual``: one batched residual evaluation (trial and line search).

As in the JAX script the batch runs in lockstep to its slowest lane, so a
stage's total is its time per call times the largest count.  The stage sum
is set against the full solve; the rest (``other_ms``) is what no stage
measures: the ρ ladder's shift, inertia test and gate, the state selects,
the line-search and acceptance arithmetic, CGLS at init and the copies of
the graph route's bank.  On a card a stage's time is device time (CUDA
events around calls queued behind a spin kernel that outlasts the host's
queueing) beside its host time, and the full solve is set against the
device's busy time over one solve (the union of the kernels
``torch.profiler`` records), beside its wall.  What the JAX script cannot
see, per stage and for the solve: the host operations (top-level aten calls
the host dispatches), the device operations (kernels and copies the
profiler records; a kernel launched from a ctypes library shows in the
events, not always in the profiler) and the solve's host checks.  On the
CPU the times are host times and the device columns are ``None``.

    python -m cannoles_tpu_torch.profile_ba_rung [--json OUT] [--device {cuda,cpu}]
        [--scenes 256] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .core.solver import CaNNOLeSSolver
from .models.families import bundle_adjustment_batch
from .ops.fused_ldlt import fused_ldlt_solve
from .parallel.batch import vsolve

__all__ = ["profile", "main"]

N_CAMS, N_PTS, MAX_ITER = 3, 16, 40
# device operations queued behind the spin kernel at most
QUEUED = 500


def _timer(dev):
    """ms per call of ``fn`` over ``reps`` calls: (device, host).  The host
    time is the wall of the calls up to a synchronize.  On a card the device
    time comes from CUDA events around the calls queued behind a spin
    kernel that outlasts the host's queueing, so that it is the device's
    and not the host's; on the CPU it is ``None``."""

    def ms(fn, reps):
        for _ in range(2):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        host = time.perf_counter() - t0
        if dev.type != "cuda":
            return None, host / reps * 1e3
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1_000_000 + 3e9 * host))  # ~1.5x the host's time at ~2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / reps, host / reps * 1e3

    return ms


def _busy_ms(intervals):
    """Length of the union of [start, end) intervals given in µs, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _ops(fn, dev) -> dict:
    """Host operations (top-level aten calls), device operations (kernels,
    copies, memsets) and the device's busy ms (their union) in one call of
    ``fn``, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    fn()
    with tprofile(activities=acts) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    events = prof.events()
    host = sum(1 for e in events if e.name.startswith("aten::") and e.cpu_parent is None)
    if dev.type != "cuda":
        return dict(host_ops=host, device_ops=None, device_busy_ms=None)
    dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
    return dict(host_ops=host, device_ops=len(dev_ev),
                device_busy_ms=_busy_ms([(e.time_range.start, e.time_range.end) for e in dev_ev]))


def profile(device=None, scenes: int = 256, reps: int = 20) -> dict:
    """The rung's counts, the full solve and the four stages; returns the
    JSON object the CLI prints."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    dtype = torch.float32
    pb, x0s, datas, _ = bundle_adjustment_batch(scenes, N_CAMS, N_PTS, dtype=dtype, device=dev)
    n, m, p = pb.nvar, pb.nequ, pb.ncon
    N = n + p
    solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas",
                            dtype=dtype, device=dev)

    def full():
        return vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=MAX_ITER)

    res = full()  # the first call builds the kernel and captures the graphs
    st = res.states
    lanes = {k: getattr(st, a).double().cpu().numpy() for k, a in
             (("outer", "iter"), ("nlinsolve", "nlinsolve"), ("nfact", "nfact"), ("neval_F", "neval_F"))}
    counts = {f"mean_{k}": float(v.mean()) for k, v in lanes.items()}
    solved = int(res.summary()["solved"])

    # the full solve: walls, host checks, operations and the device's busy time
    syncs0 = solver.host_syncs
    walls = []
    for _ in range(3):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        full()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    syncs = (solver.host_syncs - syncs0) // 3
    ms = _timer(dev)
    full_ops = _ops(full, dev)

    xs = st.x
    rng = np.random.default_rng(0)
    G = torch.as_tensor(rng.normal(size=(scenes, N, N)).astype(np.float32), device=dev)
    W = G @ G.transpose(-1, -2) + 10.0 * torch.eye(N, dtype=dtype, device=dev)
    rhs = torch.as_tensor(rng.normal(size=(scenes, N)).astype(np.float32), device=dev)
    _, JTs = pb.F_and_Jt(xs, datas)
    Jcs = pb.Jc(xs, datas)
    H = torch.zeros((scenes, n, n), dtype=dtype, device=dev)
    delta = torch.full((scenes,), 1e-3, dtype=dtype, device=dev)
    stages = {
        "kernel": lambda: fused_ldlt_solve(W, rhs, 1e-7),
        "jacobian": lambda: pb.F_and_Jt(xs, datas),
        "condensation": lambda: solver._assemble_condensed(H, JTs, Jcs, delta),
        "residual": lambda: pb.F(xs, datas),
    }
    mult = dict(
        kernel=float(lanes["nfact"].max()),
        jacobian=float(lanes["nlinsolve"].max()) + 1.0,  # init + one per trial
        condensation=float(lanes["nlinsolve"].max()),
        residual=float(lanes["neval_F"].max()),
    )
    with solver._matmul_scope():
        ops = {k: _ops(fn, dev) for k, fn in stages.items()}
        # no more calls than keep the queued launches within the card's
        # launch queue (about a thousand), or the host would wait for the spin
        timed = {k: ms(fn, max(1, min(reps, QUEUED // max(1, ops[k]["device_ops"] or 1))))
                 for k, fn in stages.items()}
    on_card = dev.type == "cuda"
    unit = {k: (d if on_card else h) for k, (d, h) in timed.items()}
    total = {k: unit[k] * mult[k] for k in stages}
    # what the stages are set against: the device's busy time over one
    # solve on a card, the solve's wall on the CPU
    full_ms = full_ops["device_busy_ms"] if on_card else float(np.median(walls)) * 1e3
    accounted = sum(total.values())
    return dict(
        device=torch.cuda.get_device_name(dev) if on_card else "cpu",
        route=solver.route,
        B=scenes, N=N, n=n, m=m, p=p, solved=solved,
        counts=counts,
        max_counts=mult,
        full_solve_wall_ms=[w * 1e3 for w in walls],
        full_solve_ms=full_ms,
        full_solve_host_syncs=syncs,
        full_solve_ops=full_ops,
        graph_replays=solver.graph_replays(),
        stage_unit_ms=unit,
        stage_host_ms=({k: h for k, (d, h) in timed.items()}),
        stage_ops_per_call=ops,
        stage_total_ms=total,
        accounted_ms=accounted,
        other_ms=full_ms - accounted,
        scenes_per_s=scenes / (float(np.median(walls))),
        timing=("stages: device ms from CUDA events behind a spin kernel; full_solve_ms: the "
                "device's busy time over one solve (torch.profiler); scenes_per_s: by the wall"
                if on_card else "host clock"),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--scenes", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_ba_rung: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    out = profile(args.device, args.scenes, args.reps)
    text = json.dumps(out, indent=1)
    print(text)
    if args.json:
        pathlib.Path(args.json).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
