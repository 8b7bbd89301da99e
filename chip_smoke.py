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
   counters equal, solutions within 1e-10;
7. Cholesky kernels vs plain: ``block_cholesky`` (fused kernel, or the
   blocked driver around the block kernel, by the JAX route rule) against
   the same driver with the plain versions on the card, float32 at
   N ∈ {100, 300, 1024, 1100, 1536} and float64 at N ∈ {300, 1024},
   B ∈ {1, 3} (B = 3 adds an indefinite and a tiny-pivot lane), nb ∈ {256,
   128}: equal ``ok``, finite outputs, L/Linv/d and ``block_cho_solve``'s x
   within tolerance; times at float32 N = 1024 and float64 N = 1024;
8. large rung: ``bench.py``'s 8192×1024 problem, float32, Gauss–Newton,
   condensed, ``chol``, ``max_iter=30``, through ``CaNNOLeSSolver.solve()``
   with the kernels (``pallas_chol_min=0``) and at the default seam;
   ``first_order`` and max |x − x_true| ≤ 1e-3 on both;
9. BA scene: ``large_bundle_adjustment(16, 300)`` (n = 996, m = 9,600,
   p = 7), float32, LM, condensed, ``chol`` at both seams; ``first_order``;
10. card vs CPU on that scene in float64 with the kernels
   (``pallas_chol_min=0``; float64 at padded N = 1024 takes the blocked
   route, so the block kernel): status and counters equal, solutions within
   1e-10.

The launch counter of the LDLᵀ kernel is set to 0 just before phase 4 and
read after phase 5; each rung must launch it.  The Cholesky kernels'
counters are set to 0 just before phase 8 and read after phase 10: the
fused kernel must run in phases 8-9 and the block kernel in phase 10.  The
last lines are the card's ``nvidia-smi`` line, a JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.
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
    for _ in range(min(reps, 3)):
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


def _rel(got, ref):
    """Largest |got − ref| over a lane, relative to that lane's largest
    |ref|; the worst lane, and the absolute error."""
    g, r = got.flatten(1).double(), ref.flatten(1).double()
    err = (g - r).abs().amax(-1)
    scale = r.abs().amax(-1).clamp_min(1e-300)
    return float((err / scale).max()), float(err.max())


def phase_chol_kernels(dev):
    from cannoles_tpu_torch.ops import block_chol as bc
    from cannoles_tpu_torch.params import Params

    # float32 to 1e-4 relative: a block's elimination is the plain version's
    # operation for operation (--fmad=false), but the panel products and the
    # substitution sums run in another order than torch.matmul; with
    # κ(A) ≲ 10 for these inputs the factors agree to ~N·eps ≈ 1.8e-4 at
    # worst, 1e-4 holds with margin in practice (measured on an H100:
    # ≤ 3.1e-7).  float64 to 1e-12 for the same reason (measured ≤ 5.8e-16).
    bars = {torch.float32: 1e-4, torch.float64: 1e-12}
    worst = {"fused": 0.0, "block": 0.0}
    routes = set()
    for dtype, sizes in ((torch.float32, (100, 300, 1024, 1100, 1536)), (torch.float64, (300, 1024))):
        tol = Params.for_dtype(dtype).eig_tol
        for N in sizes:
            for B in (1, 3):
                rng = np.random.default_rng(N + B)
                G = rng.normal(size=(B, N, N))
                A = G @ G.transpose(0, 2, 1) + N * np.eye(N)
                if B == 3:
                    A[1] -= 3 * N * np.eye(N)  # indefinite
                    A[2] = np.eye(N)
                    A[2, 7, 7] = tol / 100  # positive pivot below tol
                A = torch.as_tensor(A, dtype=dtype, device=dev)
                rhs = torch.as_tensor(rng.normal(size=(B, N)), dtype=dtype, device=dev)
                for nb in (256, 128):
                    Np = -(-N // nb) * nb
                    route = "fused" if bc.uses_fused(Np, dtype) else "block"
                    l0 = (bc.FUSED_LAUNCHES, bc.BLOCK_LAUNCHES)
                    fac = bc.block_cholesky(A, tol, nb)
                    x = bc.block_cho_solve(fac, rhs)
                    torch.cuda.synchronize()
                    grew = (bc.FUSED_LAUNCHES - l0[0], bc.BLOCK_LAUNCHES - l0[1])
                    ref = bc.block_cholesky_reference(A, tol, nb)
                    xr = bc.block_cho_solve(ref, rhs)
                    errs = [_rel(a, b) for a, b in ((fac.L, ref.L), (fac.Linv, ref.Linv),
                                                    (fac.d, ref.d), (x, xr))]
                    rel = max(e[0] for e in errs)
                    worst[route] = max(worst[route], max(e[1] for e in errs))
                    finite = all(bool(torch.isfinite(t).all()) for t in (fac.L, fac.Linv, fac.d, x))
                    same_ok = fac.ok.tolist() == ref.ok.tolist()
                    want_ok = [True] + [False] * (B - 1)
                    _log(f"  chol {str(dtype)[6:]} N={N} B={B} nb={nb} ({route}): worst rel err "
                         f"L/Linv/d/x {' '.join(f'{e[0]:.2e}' for e in errs)}, ok {fac.ok.tolist()}")
                    if not (rel <= bars[dtype] and finite and same_ok and fac.ok.tolist() == want_ok):
                        raise AssertionError(f"Cholesky kernel disagrees with its plain version at "
                                             f"{dtype} N={N} B={B} nb={nb}")
                    if grew != ((1, 0) if route == "fused" else (0, Np // nb)):
                        raise AssertionError(f"route {route} launched {grew} (fused, block)")
                    routes.add(route)
    if routes != {"fused", "block"}:
        raise AssertionError(f"routes covered: {routes}")

    def rounds(name, kernel, plain, reps_k=10, reps_p=3):
        p1 = _events_ms(plain, reps_p)
        k1 = _events_ms(kernel, reps_k)
        k2 = _events_ms(kernel, reps_k)
        p2 = _events_ms(plain, reps_p)
        _log(f"  time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
             f"(CUDA events)")
        return min(k1, k2), min(p1, p2)

    def torch_chol(A, b):
        return lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A))

    times = {}
    for dtype, key in ((torch.float32, "fused"), (torch.float64, "blocked")):
        tol = Params.for_dtype(dtype).eig_tol
        rng = np.random.default_rng(0)
        G = rng.normal(size=(1, 1024, 1024))
        A = torch.as_tensor(G @ G.transpose(0, 2, 1) + 1024 * np.eye(1024), dtype=dtype, device=dev)
        b = torch.as_tensor(rng.normal(size=(1, 1024)), dtype=dtype, device=dev)
        k, p = rounds(f"{str(dtype)[6:]} N=1024 nb=256 ({key} route), factor",
                      lambda: bc.block_cholesky(A, tol, 256),
                      lambda: bc.block_cholesky_reference(A, tol, 256))
        ks, tchol = rounds(f"{str(dtype)[6:]} N=1024 ({key} route), factor + block_cho_solve "
                           f"(kernel) vs torch.linalg.cholesky + torch.cholesky_solve (plain)",
                           lambda: bc.block_cho_solve(bc.block_cholesky(A, tol, 256), b),
                           torch_chol(A, b), reps_p=10)
        times[key] = dict(ms=k, plain_ms=p, ms_with_solve=ks, torch_cholesky_solve_ms=tchol)
        if dtype == torch.float64:
            Ab = A[:, :256, :256].contiguous()
            k, p = rounds("f64 one block nb=256 (block kernel alone)",
                          lambda: bc.chol_block(Ab, tol), lambda: bc.chol_block_reference(Ab, tol))
            times["block"] = dict(ms=k, plain_ms=p)
    return worst, times


def _solve_summary(st):
    ss = st.solver_specific
    return (f"{st.status}, iter {st.iter}, nfact {ss['nfact']}, nlinsolve {ss['nlinsolve']}, "
            f"nbk {ss['nbk']}, msg '{ss['internal_msg']}'")


def phase_large_rung(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.families import large_rung_problem
    from cannoles_tpu_torch.ops import block_chol as bc

    dtype = torch.float32
    pb, x_true, _ = large_rung_problem(dtype=dtype, device=dev)
    xt = torch.as_tensor(x_true, device=dev)
    out = {}
    # kernel seam first (the cold call of the process), then the default
    # seam, then both again warm
    for rep, pcm in ((0, 0), (0, None), (1, 0), (1, None)):
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol",
                           block_size=256, pallas_chol_min=pcm, dtype=dtype, device=dev)
        l0 = bc.FUSED_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.solve(max_iter=30, max_time=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = float((torch.as_tensor(st.solution, device=dev) - xt).abs().max())
        seam = "kernel" if pcm == 0 else "default"
        launches = bc.FUSED_LAUNCHES - l0
        _log(f"  large rung 8192x1024 f32 ({seam} seam, {'cold' if rep == 0 else 'warm'}): "
             f"{_solve_summary(st)}, wall {wall:.3f} s, max |x - x_true| {err:.3e}, "
             f"fused kernel launches {launches}, host syncs {s.host_syncs}")
        if st.status != "first_order" or not err <= 1e-3:
            raise AssertionError(f"large rung ({seam} seam): {st.status}, error {err}")
        if (launches > 0) != (pcm == 0):
            raise AssertionError(f"large rung ({seam} seam): {launches} fused kernel launches")
        out.setdefault(seam, dict(iter=st.iter, nfact=st.solver_specific["nfact"],
                                  nlinsolve=st.solver_specific["nlinsolve"], err=err,
                                  launches=launches, walls_s=[]))["walls_s"].append(wall)
    return out


def phase_ba_large(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment
    from cannoles_tpu_torch.ops import block_chol as bc

    dtype = torch.float32
    pb, x_true = large_bundle_adjustment(16, 300, dtype=dtype, device=dev)
    out = {}
    for pcm in (0, None):
        s = CaNNOLeSSolver(pb, method="lm", kkt="condensed", linsolve="chol", pallas_chol_min=pcm,
                           dtype=dtype, device=dev)
        l0 = bc.FUSED_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.solve(max_time=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seam = "kernel" if pcm == 0 else "default"
        err = float(np.abs(st.solution - x_true).max())
        launches = bc.FUSED_LAUNCHES - l0
        _log(f"  BA 16x300 f32 LM ({seam} seam): {_solve_summary(st)}, wall {wall:.3f} s, "
             f"max |x - x_true| {err:.3e}, fused kernel launches {launches}")
        if st.status != "first_order":
            raise AssertionError(f"BA 16x300 f32 ({seam} seam): {st.status}")
        if (launches > 0) != (pcm == 0):
            raise AssertionError(f"BA 16x300 ({seam} seam): {launches} fused kernel launches")
        out[seam] = dict(iter=st.iter, nfact=st.solver_specific["nfact"], wall_s=wall, err=err,
                         launches=launches)
    return out


def phase_ba_parity(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment
    from cannoles_tpu_torch.ops import block_chol as bc

    out = {}
    for where in (dev, torch.device("cpu")):
        pb, _ = large_bundle_adjustment(16, 300, dtype=torch.float64, device=where)
        s = CaNNOLeSSolver(pb, method="lm", kkt="condensed", linsolve="chol", pallas_chol_min=0)
        l0 = bc.BLOCK_LAUNCHES
        t0 = time.perf_counter()
        out[where.type] = s.solve(max_time=1200.0)
        wall = time.perf_counter() - t0
        _log(f"  BA 16x300 f64 LM on {where.type}: {_solve_summary(out[where.type])}, "
             f"wall {wall:.3f} s, block kernel launches {bc.BLOCK_LAUNCHES - l0}")
    g, c = out["cuda"], out["cpu"]
    if (g.status, g.iter) != (c.status, c.iter):
        raise AssertionError(f"card vs CPU (f64 BA): {g.status}/{g.iter} vs {c.status}/{c.iter}")
    for key in ("nfact", "nbk", "nlinsolve", "internal_msg"):
        if g.solver_specific[key] != c.solver_specific[key]:
            raise AssertionError(f"card vs CPU (f64 BA): {key} {g.solver_specific[key]} "
                                 f"vs {c.solver_specific[key]}")
    err = float(np.abs(g.solution - c.solution).max())
    _log(f"  card vs CPU (f64 BA 16x300): status and counters equal, max |x_gpu - x_cpu| {err:.3e}")
    if not err <= 1e-10:
        raise AssertionError(f"card vs CPU (f64 BA) solutions differ by {err}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from cannoles_tpu_torch.ops import _native
    from cannoles_tpu_torch.ops import block_chol as bc
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), device {kind}, "
         f"count {torch.cuda.device_count()}")
    _log(f"  nvidia-smi: {smi}")

    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 in the plain versions
    t0 = time.perf_counter()
    _native.load()
    _log(f"phase 2: build {time.perf_counter() - t0:.2f} s (nvcc processes in parallel)")
    for name, info in _native.BUILD_INFO.items():
        if isinstance(info, dict):
            _log(f"  {name}: {info['seconds']:.2f} s, {info['path']}")
            for line in str(info["ptxas"]).splitlines():
                _log(f"    {line}")

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

    _log("phase 7: Cholesky kernels vs plain versions on the card")
    chol_worst, chol_times = phase_chol_kernels(dev)
    bc.FUSED_LAUNCHES = bc.BLOCK_LAUNCHES = 0
    _log("phase 8: large rung (linsolve='chol')")
    large = phase_large_rung(dev)
    _log("phase 9: BA scene 16x300 (linsolve='chol')")
    ba_large = phase_ba_large(dev)
    _log("phase 10: BA scene 16x300 in float64, card vs CPU")
    phase_ba_parity(dev)
    fused_launches, block_launches = bc.FUSED_LAUNCHES, bc.BLOCK_LAUNCHES
    if fused_launches <= 0 or block_launches <= 0:
        raise AssertionError(f"the chol path launched the fused kernel {fused_launches} and the "
                             f"block kernel {block_launches} times")

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
    }, {
        "name": "chol_fused",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/block_chol.cu",
        "replaces": "cannoles_tpu/ops/pallas_chol.py:117",
        "launches": fused_launches,
        "max_abs_err": chol_worst["fused"],
        **chol_times["fused"],
        "shape": "f32 N=1024 nb=256 B=1 (factor)",
        "large_rung": large,
        "ba_16x300": ba_large,
    }, {
        "name": "chol_block",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/block_chol.cu",
        "replaces": "cannoles_tpu/ops/pallas_chol.py:56",
        "launches": block_launches,
        "max_abs_err": chol_worst["block"],
        **chol_times["block"],
        "shape": "f64 nb=256 B=1 (one block)",
        "blocked_route": chol_times["blocked"],
        "blocked_route_shape": "f64 N=1024 nb=256 B=1 (factor; 4 block launches + torch.matmul)",
    }]}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
