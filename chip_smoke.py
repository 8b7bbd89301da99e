#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cannoles_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases, in order; a failed phase raises and the script exits nonzero:

1. card: requires ``torch.cuda.is_available()``; prints the torch version,
   the device name and ``nvidia-smi``'s name and power limit;
2. build: builds the CUDA kernels from ``cannoles_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build seconds and ptxas's report;
3. kernel vs plain: the fused LDLᵀ kernel against its plain PyTorch version
   on the card, N ∈ {1, 5, 34, 73, cap}, B ∈ {1, 257} (and 16,384 at N = 5),
   float64 and float32, with lanes whose pivots are skipped; times both
   with CUDA events at the two main-path shapes;
4. headline rung: the bench family through ``vsolve`` as ``bench.py``
   configures its top rung (float32, LM, full KKT, B = 65,536 in chunks of
   16,384, max_iter=50, max_eval=48, rescue=True); at least 99% solved;
5. BA rung: 256 bundle-adjustment scenes (3 cameras, 16 points), float32,
   Gauss–Newton, condensed KKT (N = 73), max_iter=40; at least 99% solved;
6. card vs CPU: the bench family in float64 at B = 64, on the card with the
   kernel and on the CPU with the plain version; per-lane status and
   counters equal, solutions within 1e-10.

The launch counter of the kernel is set to 0 just before phase 4 and read
after phase 5; each rung must launch it.  The last lines are the card's
``nvidia-smi`` line, a JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F64_REL = 1e-12
# float32: the elimination is the plain version's operation for operation
# (the kernel is built with --fmad=false), so the pivots agree exactly; the
# backward substitution sums in another order, which moves x by at most
# ~N·eps·κ relative (N ≤ 240, κ ≲ 30 for these matrices): 1e-4.
F32_REL = 1e-4


def _log(*a):
    print(*a, flush=True)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: unavailable"


def _events_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _inertia(d, tol):
    return torch.stack([(d > tol).sum(-1), (d.abs() <= tol).sum(-1), (d < -tol).sum(-1)], -1)


def phase_kernel(dev):
    from cannoles_tpu_torch.ops import fused_ldlt as fl
    from cannoles_tpu_torch.params import Params
    from cannoles_tpu_torch.utils.testing import quasi_definite

    def inputs(B, N, dtype):
        W, rhs, _ = quasi_definite(B, N, seed=B + N)
        return torch.as_tensor(W, dtype=dtype, device=dev), torch.as_tensor(rhs, dtype=dtype, device=dev)

    worst = 0.0
    for dtype, bar in ((torch.float64, F64_REL), (torch.float32, F32_REL)):
        tol = Params.for_dtype(dtype).eig_tol
        cap = fl.max_n(dtype)
        for N in (1, 5, 34, 73, cap):
            for B in ((1, 257, 16384) if N == 5 else (1, 257)):
                W, rhs = inputs(B, N, dtype)
                x, d = fl.fused_ldlt_solve(W, rhs, tol)
                torch.cuda.synchronize()
                xr, dr = fl.fused_ldlt_solve_reference(W, rhs, tol)
                ex = float((x - xr).abs().max())
                ed = float((d - dr).abs().max())
                rx = ex / max(float(xr.abs().max()), 1e-300)
                rd = ed / max(float(dr.abs().max()), 1e-300)
                same = bool((_inertia(d, tol) == _inertia(dr, tol)).all())
                worst = max(worst, ex, ed)
                _log(f"  kernel {str(dtype)[6:]} N={N} B={B}: rel err x {rx:.3e} d {rd:.3e}, "
                     f"abs {ex:.3e}/{ed:.3e}, inertia equal {same}")
                if not (rx <= bar and rd <= bar and same and torch.isfinite(x).all()):
                    raise AssertionError(f"kernel disagrees with plain version at {dtype} N={N} B={B}")
    times = {}
    for N, B in ((5, 16384), (73, 256)):
        W, rhs = inputs(B, N, torch.float32)
        tol = Params.for_dtype(torch.float32).eig_tol
        t_plain1 = _events_ms(lambda: fl.fused_ldlt_solve_reference(W, rhs, tol))
        t_k1 = _events_ms(lambda: fl.fused_ldlt_solve(W, rhs, tol))
        t_k2 = _events_ms(lambda: fl.fused_ldlt_solve(W, rhs, tol))
        t_plain2 = _events_ms(lambda: fl.fused_ldlt_solve_reference(W, rhs, tol))
        times[(N, B)] = (min(t_k1, t_k2), min(t_plain1, t_plain2))
        _log(f"  time f32 N={N} B={B}: kernel {t_k1:.4f}/{t_k2:.4f} ms, "
             f"plain {t_plain1:.4f}/{t_plain2:.4f} ms (CUDA events, mean of 20)")
    return worst, times


def phase_headline(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.core.status import MSG, status_name
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    dtype = torch.float32
    B, chunk = 65536, 16384
    pb = lm_bench_family(dtype, dev)
    solver = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=dtype, device=dev)
    x0, d = lm_bench_batch(B, seed=0)
    x0s = torch.as_tensor(x0, dtype=dtype, device=dev)
    datas = torch.as_tensor(d, dtype=dtype, device=dev)
    kw = dict(data_batch=datas, solver=solver, max_iter=50, chunk_size=chunk, max_eval=48)

    # as bench.py: first the pre-rescue failure breakdown, then the timed
    # call with the rescue pass
    h0 = solver.host_syncs
    pre = vsolve(pb, x0s, rescue=False, **kw)
    pre_syncs = solver.host_syncs - h0
    bad = ~pre.solved_mask()
    breakdown = {}
    for s, m in zip(pre.status[bad], pre.states.msg.cpu().numpy()[bad]):
        key = status_name(int(s)) + (f":{MSG[int(m)]}" if int(m) else "")
        breakdown[key] = breakdown.get(key, 0) + 1

    l0, h0 = fl.LAUNCHES, solver.host_syncs
    t0 = time.perf_counter()
    res = vsolve(pb, x0s, rescue=True, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.LAUNCHES - l0
    syncs = solver.host_syncs - h0 + sum(
        s.host_syncs for s in solver.__dict__.get("_rescue_siblings", {}).values()
    )
    summ = res.summary()
    _log(f"  headline: solved {summ['solved']}/{B}, wall {wall:.3f} s (rescue included), "
         f"kernel launches {launches}, host syncs {syncs} (pre-rescue pass alone {pre_syncs}), "
         f"pre-rescue failures {breakdown or 'none'}, mean_iter {summ['mean_iter']:.3f}")
    if launches <= 0:
        raise AssertionError("headline rung did not launch the fused LDLT kernel")
    x = res.states.x
    if x.shape != (B, 2) or not bool(torch.isfinite(x[torch.as_tensor(res.solved_mask(), device=dev)]).all()):
        raise AssertionError("headline rung: non-finite solutions on solved lanes")
    if summ["solved"] < 0.99 * B:
        raise AssertionError(f"headline rung solved {summ['solved']}/{B} < 99%")
    return dict(solved=summ["solved"], B=B, wall_s=wall, launches=launches, host_syncs=syncs,
                pre_rescue=breakdown)


def phase_ba(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import bundle_adjustment_batch
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    dtype = torch.float32
    B = 256
    pb, x0s, datas, x_true = bundle_adjustment_batch(B, 3, 16, dtype=dtype, device=dev)
    solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas",
                            dtype=dtype, device=dev)
    l0 = fl.LAUNCHES
    t0 = time.perf_counter()
    res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.LAUNCHES - l0
    summ = res.summary()
    ok = res.solved_mask()
    err = float(np.abs(res.solution[ok] - x_true[ok]).max()) if ok.any() else float("nan")
    _log(f"  BA: N={pb.nvar + pb.ncon}, solved {summ['solved']}/{B}, wall {wall:.3f} s, "
         f"kernel launches {launches}, host syncs {solver.host_syncs}, "
         f"max |x - x_true| on solved lanes {err:.3e}, mean_iter {summ['mean_iter']:.3f}")
    if launches <= 0:
        raise AssertionError("BA rung did not launch the fused LDLT kernel")
    if summ["solved"] < 0.99 * B:
        raise AssertionError(f"BA rung solved {summ['solved']}/{B} < 99%")
    return dict(solved=summ["solved"], B=B, wall_s=wall, launches=launches,
                host_syncs=solver.host_syncs)


def phase_parity(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    B = 64
    x0, d = lm_bench_batch(B, seed=1)
    out = {}
    for where in (dev, torch.device("cpu")):
        pb = lm_bench_family(torch.float64, where)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full")
        out[where.type] = vsolve(pb, x0, data_batch=d, solver=s, max_iter=50, rescue=True).states
    g, c = out["cuda"], out["cpu"]
    for f in ("status", "iter", "nfact", "nbk", "nlinsolve", "msg"):
        a, b = getattr(g, f).cpu(), getattr(c, f)
        if not torch.equal(a, b):
            lanes = torch.nonzero(a != b).flatten().tolist()
            raise AssertionError(f"card vs CPU: {f} differs on lanes {lanes}")
    err = float((g.x.cpu() - c.x).abs().max())
    _log(f"  card vs CPU (f64, B={B}): counters equal, max |x_gpu - x_cpu| {err:.3e}")
    if not err <= 1e-10:
        raise AssertionError(f"card vs CPU solutions differ by {err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from cannoles_tpu_torch.ops import _native
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), device {kind}, "
         f"count {torch.cuda.device_count()}")
    _log(f"  nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _native.load()
    _log(f"phase 2: build {time.perf_counter() - t0:.2f} s ({_native.BUILD_INFO.get('path')})")
    for line in str(_native.BUILD_INFO.get("ptxas", "")).splitlines():
        _log(f"  {line}")

    _log("phase 3: kernel vs plain version on the card")
    worst, times = phase_kernel(dev)
    fl.LAUNCHES = 0
    _log("phase 4: headline rung")
    head = phase_headline(dev)
    _log("phase 5: BA rung")
    ba = phase_ba(dev)
    launches = fl.LAUNCHES
    _log("phase 6: solver on the card vs on the CPU")
    phase_parity(dev)

    kt, kp = times[(5, 16384)]
    bt, bp = times[(73, 256)]
    _log(smi)
    _log(json.dumps({"kernels": [{
        "name": "fused_ldlt_solve",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/fused_ldlt.cu",
        "replaces": "cannoles_tpu/ops/pallas_ldlt.py:79",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kt,
        "plain_ms": kp,
        "shape": "f32 N=5 B=16384",
        "ms_ba": bt,
        "plain_ms_ba": bp,
        "shape_ba": "f32 N=73 B=256",
        "headline": head,
        "ba": ba,
    }]}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
