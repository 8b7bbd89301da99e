#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cannoles_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --against DIR    # phases 3, 4, 7, 21's times and 23, DIR's package, then this

Phases, in order; a failed phase raises and the script exits nonzero:

1. card: requires ``torch.cuda.is_available()``; prints the torch version,
   the device name and ``nvidia-smi``'s name and power limit;
2. build: builds the CUDA kernels from ``cannoles_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build seconds and ptxas's report;
3. kernel vs plain: the fused LDLᵀ kernel against its plain PyTorch version
   on the card over both of its mappings, N ∈ {1, 5, t, t + 1, 34, 73, 96,
   97, cap} (t = ``thread_max_n()``), B ∈ {1, 257} (and 16,384 at N = 5),
   float64 and float32, with lanes whose pivots are skipped: raw pivots bit
   for bit equal (every forced mapping too at N = 5 and t), x within
   1e-12/1e-4, inertia equal; the two mappings timed against each other at
   even N ≤ 16, B = 256 and 16,384, and 32/64/128 systems per block; kernel
   and plain version timed with CUDA events at the two main-path shapes
   (and, after phase 5, at the rescue's most frequent shape), and the
   wrapper's host time per call;
4. headline rung: the bench family through ``vsolve`` as ``bench.py``
   configures its top rung (float32, LM, full KKT, B = 65,536 in chunks of
   16,384, max_iter=50, max_eval=48, rescue=True); at least 99% solved; the
   solver's LDLᵀ calls counted by (N, B), the rescue's apart;
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
   128, 512}, and one ill-conditioned input per type (κ = 1e6, N = 1024,
   nb ∈ {256, 512}): equal ``ok``, finite outputs, L/Linv/d and
   ``block_cho_solve``'s x within tolerance; times (kernel, plain version,
   ``torch.linalg.cholesky``, and ``torch.linalg.cholesky`` +
   ``torch.cholesky_solve``) and bounds at float32 N = 1024 and float64
   N = 1024, and the wrapper launches and device operations of one
   factorization there, counted under ``torch.profiler``;
8. large rung: ``bench.py``'s 8192×1024 problem, float32, Gauss–Newton,
   condensed, ``chol``, ``max_iter=30``, through ``CaNNOLeSSolver.solve()``
   with the kernels (``pallas_chol_min=0``) and at the default seam, one
   solver per seam, four solves each (the first with the solver's one-time
   costs) and a fifth under ``torch.profiler`` (device busy time and
   the kernels with the most of it); ``first_order`` and max |x − x_true|
   ≤ 1e-3 on every solve;
9. BA scene: ``large_bundle_adjustment(16, 300)`` (n = 996, m = 9,600,
   p = 7), float32, LM, condensed, ``chol`` at both seams, solved and
   profiled as phase 8; ``first_order``;
10. card vs CPU on that scene in float64 with the kernels
   (``pallas_chol_min=0``; float64 at padded N = 1024 takes the blocked
   route, so the block kernel): status and counters equal, solutions within
   1e-10.

Phase 20 (``matmul_precision``) runs next, before the pool, so that its
walls are not shared with the pool's workers:

20. the large rung of phase 8 under each mode (None, 'highest', 'float32',
   'bfloat16', 'tensorfloat32') at the default seam, in ``bench.py``'s bf16
   commit setting (``quality_gate=False``) and under 'bfloat16' at the
   kernel seam: per run status, iter, nfact, max |x − x_true| (``first_order``
   and ≤ ``PREC_LARGE_BAR`` in every run), three warm walls, their CUDA-event
   spans, and the GEMM and busy device time of a profiled solve; the BA rung
   of phase 5 under each mode and under 'bfloat16' with the gate off (at
   least 99% solved under the IEEE modes, the others recorded); the
   one-pass bf16 product of the condensation against its plain version
   ``bf16_pass_reference`` at both rungs' JᵀJ shapes (every entry within
   2·K·u·(|a|·|b|)), with its times beside the IEEE and TF32 GEMMs'; the
   sites pinned to IEEE bit-equal inside a TF32 scope, and an unpinned
   product not; phase 6 in float64 under 'bfloat16' and 'tensorfloat32'.

Phase 21 (the solver's routes, ``core/segments.py``) runs after phase 20,
also before the pool, whose workers would share the host it measures:

21. ``biggs_exp6_24`` in float64 with the battery's uniform protocol
   (``linsolve="ldlt"``, ``atol=0``, ``rtol=1e-5``, no time budget) on the
   graph route to its end (``first_order``), then both routes capped at
   ``HOST_PATH_CAP`` outer iterations: states, statuses and counters equal
   bit for bit; and phase 4's headline with its rescue on both routes, two
   reps each, every lane's state equal bit for bit.  Per route: host
   checks, ms per check (the solve's clock over its checks), device
   operations the host launches per check and kernels per check
   (``torch.profiler``, ``HOST_PATH_PROFILED`` outer iterations), walls
   (the headline's rung and rescue apart), the graphs captured and their
   replays per segment; then the exp-fit batch of the 2-D mesh's tests
   (B = 4, m = 32, Gauss–Newton, condensed, ``linsolve="chol"``) in float32
   and float64, at the default seam and through the Cholesky kernel
   (``pallas_chol_min=0``), on both routes: captured and replayed, states
   equal bit for bit, kernel launches equal, statuses the CPU run's, every
   lane ``first_order``.  The LDLᵀ kernel's and the fused Cholesky
   kernel's counts over the phase must rise.

Phase 25 (the bank store's batched copy, ``ops/bank_copy.py``) runs after
phase 21, before the pool, since it times the card:

25. the kernel against its plain version on ``COPY_LAYOUTS``'s random
   stores (``utils.testing.copy_layout``: six dtypes, offsets off 16-byte
   alignment, sources sharing memory with destinations, strided sources;
   the one-block path, the grid path, staging, more entries than a launch
   takes): the card's pool equal bit for bit to the CPU's and to the
   expected bytes, one launch counted per launch of the plan on the card;
   the counts over a fresh headline-family
   graph-route ``vsolve`` at each B of ``COPY_SOLVE_B`` (the rescue on):
   launches counted, and at least ``COPY_ENGAGEMENT_BAR`` of the pairs
   folded; the first ``outer_post`` store of a headline-family ``vsolve``
   at each B of ``COPY_STORE_B`` (``bench_copy.store_row``): the kernel,
   the plain version and PyTorch's multi-tensor copy leave the same bytes
   on copies of the pairs' storages, and each is timed inside a captured
   graph (device ms a store, CUDA events).  The size sweep behind
   ``CUT_BYTES`` is ``python -m cannoles_tpu_torch.bench_copy --cut``.

Phase 26 (the camera-Schur pair kernel, ``ops/schur_pairs.py``) runs after
phase 25, before the pool, since it times the card:

26. the kernel on BAL Dubrovnik-356's pair plan (``SCHUR_PAIRS_SCENE``:
   ``models.bal.draw_scene`` at seed 0, 5.94M pairs in 17,088 lower camera
   blocks, built on the card) with random X and W, float32 at cd = 9 and 6
   and float64 at cd = 9: every entry within ``SCHUR_PAIRS_BAR`` of the sum
   of its terms' magnitudes from the plain version, bit-equal across two
   launches, each launch counted; at
   float32, cd = 9 the kernel, its plain version and the library route
   (``bmm`` + ``index_add_``) timed with CUDA events, beside the bound.

Phase 27 (the list route's products over observations,
``ops/obs_products.py``) runs after phase 26, before the pool, since it
times the card:

27. the kernel on BAL Dubrovnik-356's lists (``SCHUR_PAIRS_SCENE``, built
   on the card), each kind (``jv``, ``jtw``, ``reduce``, ``lift``, ``uv``)
   with random blocks in the forward-mode Jacobian's layout, float32 at
   cd = 9 and 6 and float64 at cd = 9: every entry within ``OBS_BAR`` of the
   sum of its terms' magnitudes from the plain version, bit-equal across
   two launches, each launch counted; at float32, cd = 9 each kind's
   kernel, plain version (the einsum + ``index_put_`` chain) and library
   route (the einsums + ``index_add_``, float atomics) timed with CUDA
   events, beside the kind's byte bound; then one float32 LM solve of the
   scene (``bal_scene`` at seed 0): every product call of every kind a
   launch (engagement 1).

Phase 28 (the list route's per-observation Jacobian blocks,
``ops/obs_blocks.py``) runs after phase 27, before the pool, since it times
the card:

28. the kernel on BAL Dubrovnik-356's lists (``SCHUR_PAIRS_SCENE``, built
   on the card) at the scene's true cameras and points (``draw_scene`` at
   seed 0), a frozen-coordinate mask on camera 0, float32 and float64:
   A, Bm and W within ``OBS_BLOCKS_BAR`` of each observation's block
   magnitude from the plain version (``jacfwd`` and an einsum), bit-equal
   across two launches, each launch counted; at float32 the kernel and the
   plain version timed with CUDA events, beside the byte bound; then one
   float32 LM solve of the scene (``bal_scene`` at seed 0): every block
   evaluation a launch (engagement 1).

Phase 23 (the routes' peak device memory) runs after phase 28, before the
pool:

23. ``large_rung_problem(m, 1024)`` (float32, Gauss–Newton, condensed,
   ``chol``) at each m of ``MEMORY_ROWS`` (J of 33.5 MB, 268 MB and
   1.07 GB), three solves on one solver per route: every solve
   ``first_order``; the peak allocated and reserved memory of each route;
   the graph route's peak allocated at most ``MEMORY_RATIO_BAR`` times the
   eager route's.

Phase 24 (the repo's headline benchmark on the card) runs after phase 23,
before the pool, alone on the card, since its walls are timing:

24. ``python -m cannoles_tpu_torch.bench`` (the port of the repo-root
   ``bench.py``: the headline ladder, the BA rung and the large rung) in a
   process of its own: it must exit 0, and the last line of its standard
   output must carry every key of the JAX script's line, none null; the
   best rung's ``headline_solved`` at least 99% of its B (read from the
   rung's line on the bench's standard error), ``ba_solved`` at least
   ``BENCH_BA_SOLVED``/256, and the large rung ``first_order`` with
   max |x − x_true| ≤ ``BENCH_LARGE_ERR`` (from its line on standard
   error).  The line and the phase's wall are printed.

Phases 11 and 12 share one pool of worker processes (``battery.solve_index``,
four processes) that solves the battery's 90 problems in three
settings, the longest rows first: the uniform pass (no rescues and no
time budget, so that host speed cannot move a result) in float64 on the
card and on the CPU, and the whole runner with its rescues in float32 on
the card (``max_time=60``, the runner's default).

11. battery parity: per problem, status equal and ``iter``, ``nfact``,
   ``nlinsolve`` equal, except for the problems named in
   ``BATTERY_STATUS`` and ``BATTERY_COUNTERS``; solutions within 1e-10
   where the counters agree, except for the ill-conditioned problems named
   in ``BATTERY_DX`` with their own bars; ``multistart`` on
   ``freudenstein_roth`` (64 starts) on the card and on the CPU picks the
   same lane with the same status;
12. battery on the card: solved and solved-uniform counts by family and by
   rescue, the slowest rows and the multistart rows' host syncs; at least
   86/90 solved; one uniform solve (``beale``, float32) profiled on a warm
   solver for the device's busy share;
13. deadline: the headline family through ``vsolve(max_time=...)`` at
   B = 65,536 (float32, ``chunk_size=16,384``, ``linsolve="auto"``, phase
   4's other settings): with ``max_time=0`` chunk 0's statuses equal phase
   4's before its rescue and every later lane is ``max_time``; with
   ``max_time=600`` every status equals phase 4's; the LDLᵀ kernel's
   count over this phase must rise;
14. BA scene at full width: ``bench_ba_large.run_scene`` on
   ``large_bundle_adjustment(100, 10_000)`` (n = 30,600, m = 2,000,000),
   float32, through ``SchurBASolver`` and ``MatrixFreeSolver(cg_maxiter=600,
   precond=ba_block_jacobi(100, 10_000))``, with the frozen gauge (one
   Gauss–Newton phase) and the constrained gauge (LM with the multiplier
   refit, then two ``solve(resume_from=...)`` continuations); every run
   ``first_order`` with max |x − x_true| ≤ ``BA_SCENE_RECOVERY_BAR``; per
   run iter, nfact, ncg, objective, recovery error, wall, the CUDA-event
   span, the device's busy share of a profiled window, host syncs and peak
   device memory;
15. BA engines card vs CPU: ``BA_PARITY_CASES`` in float64 through both
   engines on the card and on the CPU under the benchmark protocol, status
   and iter/nfact/ncg/nlinsolve equal and solutions within 1e-10 (the runs
   named in ``BA_PARITY_NAMED`` with their own bars); then checkpoints on
   the card: a ``SchurBASolver``
   solve and a dense ``CaNNOLeSSolver`` solve of ``rosenbrock+linear``
   saved at ``max_iter=2``, loaded and resumed, bit for bit equal to the
   straight-through solve.

16. huge separable fit: ``bench_matfree.run_fit``, the JAX script
   ``benchmarks/bench_matfree.py``'s problem at its widths (m = 2,097,152,
   n = 4,096, float32: residual sin(t fᵀ) @ w − y through the tiled
   ``SinFeatureMatvec``) and recipe (``MatrixFreeSolver(cg_maxiter=100)``,
   ``max_iter=30``, ``max_time=600``); status ``first_order`` or
   ``small_residual``, objective at most 1e-3 of its value at w = 0 and
   within ``FIT_OBJECTIVE_FACTOR`` of its first H100 reading, peak device
   memory at most ``FIT_PEAK_GB``, max |w − w_true| at most
   ``FIT_PARAM_ERR_BAR``; per run iter, nfact, ncg, objective, the error,
   wall, the CUDA-event span, tiled products and ms per product, host
   syncs, peak memory and the device's busy share of a profiled first
   outer iteration;
17. card vs CPU in float64: the fit at ``FIT_PARITY`` (status equal; iter,
   nfact, nlinsolve, neval_residual equal, ncg within ``FIT_PARITY_NCG``
   and solutions within ``FIT_PARITY_DX``, or the named knife edge of the
   first-order test after the first outer step: see ``phase_fit_parity``);
   and a dense solve with ``linsolve="cpp"`` (the host C++ LDLᵀ, a host
   round trip from the card) equal to ``linsolve="ldlt"`` on the card:
   status, iter and nfact equal, solutions within 1e-12;
18. examples: ``examples/torch_01_basics.py``, ``torch_02_batched_sweep.py``
   and ``torch_04_bundle_adjustment.py`` on the card, each in a process of
   its own, all started when the pool starts; each must exit 0;
19. the multi-device layer with k gloo ranks sharing the card
   (``parallel.launch``; after the pool, so that no rank slows its rows):
   BASELINE config 4 (``benchmarks/bench_large.py``'s 10,240 × 1,024 problem,
   float32, Gauss–Newton, condensed, ``chol``, ``block_size=128``,
   ``max_iter=30``) through ``solve_row_sharded`` over k = 1, 2, 4 at both
   seams against the one-process solve (status, iter, nfact, nlinsolve
   equal, x within ``SHARD_DX_BAR``, every rank the same bits, the Cholesky
   kernel launched on every rank at the kernel seam only), with the warm
   wall, each rank's peak memory and launches; the row-sharded
   ``MatrixFreeSolver`` at k = 4 against its one-process run; BASELINE
   config 5 (``benchmarks/scaling.py``'s family and draw, B = 102,400)
   through ``vsolve(mesh=...)`` over 4 ranks against the one-process run
   lane by lane (statuses equal but for ``SHARD_CFG5_NAMED``, x within
   ``SHARD_CFG5_DX_BAR``), ``batch_convergence_stats`` equal to the
   result's own counts, the LDLᵀ kernel launched on every rank;
   ``scaling_bench`` rows at k = 1, 2, 4 (printed, labelled
   ``one_card_shared``: not scaling); the 8,192-row curve fit in float64
   over 4 ranks on the card against 4 ranks on the CPU.
22. the entry points (after phase 19, alone on the card), each through its
   Python entry function, ranks spawned in fresh processes and sharing the
   card: ``dryrun.dryrun_multichip(4)`` (the three mesh axes; 2 × 2 on the
   2-D axis); ``bench_large.run()`` and ``run_sharded(2)`` (config 4 at
   10,240 × 1,024: ``first_order``, max |x − x_true| ≤ 1e-3, the sharded
   iter and nfact equal to the one-process run's); ``scaling.run(4096, 2)``
   (rows at k = 1, 2 labelled ``one_card_shared``); ``bench_chol.run()``
   (N = 256 … 4,096 in float32, nb = 128: both Cholesky kernels' counts
   over it must rise; every row ``ok`` with ``rel_err`` ≤ 1e-4;
   the kernel against ``torch.linalg.cholesky_ex`` with CUDA events, and
   the bound); ``perf_profile.run`` on six problems in float64 (six spawned
   processes, one per problem, started at the phase's start): solved per
   problem and configuration equal to JAX's CPU record but for
   ``ENTRY_PROFILE_NAMED``;
   ``mgh_battery.run(constrained=True, linsolve="auto")``: 14/14.  The
   phase's wall and each piece's are printed.

Phases 14 and 15 run in this process while the pool's workers solve the
battery of phases 11-12 (no custom kernel runs in them: the Schur system
is ``torch.linalg.cholesky``'s, as the JAX package's is XLA's), and the
examples of phase 18 run beside them.  Phase 16, the one phase that keeps
the card busy for seconds on end, runs after the pool.  No custom kernel
runs in phases 16-17: the tiled product is plain PyTorch, as the JAX
script's is plain ``jnp``, and the cpp backend is host C++.

Every count is read from ``core.segments.counters()`` before and after
what it counts.  The LDLᵀ kernel's launches over phases 4-5: each rung
must launch it.  The Cholesky kernels' over phases 8-10: the fused kernel
must run in phases 8-9 and the block kernel in phase 10.  The LDLᵀ and
fused Cholesky kernels' over phase 20's two rungs: the BA rung must launch
the one in every run, the large rung's kernel seam the other.  Both over
phase 21: the headline must launch the one and the chol batch the other.
On the graph route a kernel launched inside a captured segment counts once
per replay (``core/segments.py``).  The Cholesky kernels' over phase 22's
``bench_chol``: both must rise.  The
last lines are the card's ``nvidia-smi`` line, a JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.

``--against DIR`` runs phase 4, then phase 3 and phase 7's times (without
the plain versions; the LDLᵀ kernel at the two main-path shapes and the
rescue's, and its host time per call), then phase 21's two workloads capped
so that a package without the graph route fits (``biggs_exp6_24`` at
``HOST_PATH_CAP`` outer iterations on the package's default route, the
headline with its rescue), then the peak device memory of the large rung
and of repeated ``vsolve`` calls whose rescues differ in size, and phase
23's ladder of both routes (without its bar), for the
``cannoles_tpu_torch`` under DIR (for example a ``git archive`` of another
commit) and for this one, each in a fresh process, DIR first, and prints
one JSON line for each.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import re
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


_T0 = time.perf_counter()


def _phase(title):
    """A phase's heading, with the seconds since the script started."""
    _log(f"{title} (at {time.perf_counter() - _T0:.1f} s)")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: unavailable"


def _events_ms(fn, reps=20, ahead=False):
    """Mean ms of ``reps`` calls of ``fn`` between two CUDA events.  With
    ``ahead``, a spin kernel (~0.1 ms per call) holds the card first while
    the host queues the calls, so that a kernel shorter than its wrapper's
    host time is timed on the device and not at the host's launch rate."""
    for _ in range(min(reps, 3)):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(1_000_000 + 200_000 * reps)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _inertia(d, tol):
    return torch.stack([(d > tol).sum(-1), (d.abs() <= tol).sum(-1), (d < -tol).sum(-1)], -1)


def _ldlt_inputs(B, N, dtype, dev):
    from cannoles_tpu_torch.utils.testing import quasi_definite

    W, rhs, _ = quasi_definite(B, N, seed=B + N)
    return torch.as_tensor(W, dtype=dtype, device=dev), torch.as_tensor(rhs, dtype=dtype, device=dev)


def _ldlt_bound(N, B):
    """Bound of the fused LDLᵀ at float32: W and rhs read, x and d written;
    N³/3 flops for the factor and 2N² for the solves."""
    return _bound(4 * B * (N * N + 3 * N), B * (N ** 3 / 3 + 2 * N * N), torch.float32)


def phase_kernel(dev):
    """The fused LDLᵀ kernel against its plain version on both mappings;
    returns the worst absolute error."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl
    from cannoles_tpu_torch.params import Params

    t = fl.thread_max_n()
    _log(f"  one thread per system up to N = {t}, one block per system above")
    worst = 0.0
    for dtype, bar in ((torch.float64, F64_REL), (torch.float32, F32_REL)):
        tol = Params.for_dtype(dtype).eig_tol
        for N in sorted({1, 5, t, t + 1, 34, 73, 96, 97, fl.max_n(dtype)}):
            for B in ((1, 257, 16384) if N == 5 else (1, 257)):
                W, rhs = _ldlt_inputs(B, N, dtype, dev)
                x, d = fl.fused_ldlt_solve(W, rhs, tol)
                torch.cuda.synchronize()
                xr, dr = fl.fused_ldlt_solve_reference(W, rhs, tol)
                ex = float((x - xr).abs().max())
                ed = float((d - dr).abs().max())
                rx = ex / max(float(xr.abs().max()), 1e-300)
                same = bool((_inertia(d, tol) == _inertia(dr, tol)).all())
                equal = torch.equal(d, dr)
                # every forced mapping at the headline's N and at the threshold
                # (128 systems of N = thread_max_n() do not fit in float64)
                routes = (((32, 64, 128, -1) if N == 5 else (32, 64, -1) if N == t else ())
                          if B == 257 else ())
                for route in routes:
                    equal &= torch.equal(fl._launch(W, rhs, tol, route)[1], dr)
                worst = max(worst, ex, ed)
                _log(f"  kernel {str(dtype)[6:]} N={N} B={B}: rel err x {rx:.3e}, d bit-equal "
                     f"{equal}{' (routes ' + str(routes) + ' too)' if routes else ''}, "
                     f"inertia equal {same}")
                if not (rx <= bar and equal and same and torch.isfinite(x).all()):
                    raise AssertionError(f"kernel disagrees with plain version at {dtype} N={N} B={B}")
    return worst


def threshold_sweep(dev):
    """Times (CUDA events) of the two mappings forced at every even N up to
    16, B = 256 and 16,384, both types (diagonally dominant inputs),
    and of 32, 64 and 128 systems per block at N = 5, B = 16,384; returns
    the largest N where one thread per system is not slower, per type and B."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl
    from cannoles_tpu_torch.params import Params

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        tol = Params.for_dtype(dtype).eig_tol
        for B in (256, 16384):
            wins = 0
            for N in (2, 4, 6, 8, 10, 12, 14, 16):
                G = torch.randn(B, N, N, generator=g, device=dev, dtype=dtype)
                W = G + G.transpose(1, 2) + 2 * N * torch.eye(N, device=dev, dtype=dtype)
                rhs = torch.randn(B, N, generator=g, device=dev, dtype=dtype)
                ms = [_events_ms(lambda r=r: fl._launch(W, rhs, tol, r), ahead=True)
                      for r in (32, -1, 32, -1)]
                thread, block = min(ms[0], ms[2]), min(ms[1], ms[3])
                _log(f"  sweep {str(dtype)[6:]} B={B} N={N}: thread per system {ms[0]:.4f}/{ms[2]:.4f} ms, "
                     f"block per system {ms[1]:.4f}/{ms[3]:.4f} ms")
                if thread <= block:
                    wins = N
            out[f"{str(dtype)[6:]} B={B}"] = wins
    W, rhs = _ldlt_inputs(16384, 5, torch.float32, dev)
    tol = Params.for_dtype(torch.float32).eig_tol
    per_block = {r: min(_events_ms(lambda r=r: fl._launch(W, rhs, tol, r), ahead=True) for _ in range(2))
                 for r in (32, 64, 128)}
    _log(f"  systems per block at f32 N=5 B=16384: "
         + ", ".join(f"{r}: {ms:.4f} ms" for r, ms in per_block.items()))
    return dict(thread_not_slower_up_to_n=out,
                systems_per_block_ms={str(r): ms for r, ms in per_block.items()})


def ldlt_times(dev, shapes, plain=True):
    """CUDA-event times of the fused LDLᵀ kernel at float32 at each (N, B),
    against its plain version (unless ``plain`` is false), and its bound."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl
    from cannoles_tpu_torch.params import Params

    tol = Params.for_dtype(torch.float32).eig_tol
    out = {}
    for N, B in shapes:
        W, rhs = _ldlt_inputs(B, N, torch.float32, dev)
        p1 = _events_ms(lambda: fl.fused_ldlt_solve_reference(W, rhs, tol)) if plain else None
        k1 = _events_ms(lambda: fl.fused_ldlt_solve(W, rhs, tol), ahead=True)
        k2 = _events_ms(lambda: fl.fused_ldlt_solve(W, rhs, tol), ahead=True)
        p2 = _events_ms(lambda: fl.fused_ldlt_solve_reference(W, rhs, tol)) if plain else None
        bound, by = _ldlt_bound(N, B)
        out[f"N={N} B={B}"] = dict(ms=min(k1, k2), plain_ms=min(p1, p2) if plain else None,
                                   bound_ms=bound, bound_by=by)
        _log(f"  time f32 N={N} B={B}: kernel {k1:.4f}/{k2:.4f} ms"
             + (f", plain {p1:.4f}/{p2:.4f} ms" if plain else "")
             + f"; bound {bound:.5f} ms ({by}) (CUDA events, mean of 20)")
    return out


def ldlt_host_us(dev, N=5, B=256, calls=1000, loops=5):
    """Host microseconds per call of ``fused_ldlt_solve`` (float32): the
    least of ``loops`` loops of ``calls`` calls with no synchronisation."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl
    from cannoles_tpu_torch.params import Params

    tol = Params.for_dtype(torch.float32).eig_tol
    W, rhs = _ldlt_inputs(B, N, torch.float32, dev)
    per_loop = []
    for _ in range(loops):
        fl.fused_ldlt_solve(W, rhs, tol)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fl.fused_ldlt_solve(W, rhs, tol)
        per_loop.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    _log(f"  host time of fused_ldlt_solve f32 N={N} B={B}: "
         + ", ".join(f"{us:.3f}" for us in per_loop) + f" us per call ({loops} loops of {calls} calls, no sync)")
    return min(per_loop)


def _count(key):
    """The process's count ``key`` (``core.segments.counters()``); a
    package from before that registry (``--against`` an older tree) keeps
    the kernels' launches as module globals of ``ops``."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    if hasattr(fl, "LAUNCHES"):
        from cannoles_tpu_torch.ops import block_chol as bc

        return {"fused_ldlt": fl.LAUNCHES, "chol_fused": bc.FUSED_LAUNCHES, "chol_block": bc.BLOCK_LAUNCHES}[key]
    from cannoles_tpu_torch.core import segments

    return segments.counters()[key]


def _shape_counts():
    """The fused LDLᵀ kernel's launches by (N, B), which graph replays add
    to, or None for a package that does not count them."""
    from cannoles_tpu_torch.ops import fused_ldlt as fl

    if hasattr(fl, "LAUNCHES"):  # a package from before the counter registry
        return dict(fl.BY_SHAPE) if hasattr(fl, "BY_SHAPE") else None
    from cannoles_tpu_torch.core import segments

    return {k[1]: n for k, n in segments.counters().items() if isinstance(k, tuple) and k[0] == "fused_ldlt"}


@contextlib.contextmanager
def _ldlt_shapes():
    """Counts the solver's fused LDLᵀ launches by (N, B), those inside the
    rescue pass apart, for the time of the block: from the kernel's counts
    by shape (``_shape_counts``) where the package has them, else by
    wrapping ``core.solver.fused_ldlt_solve`` (a package without the graph
    route); ``parallel.batch._rescue_unsolved`` is wrapped to tell the
    rescue apart."""
    from cannoles_tpu_torch.core import solver as sv
    from cannoles_tpu_torch.parallel import batch as bt

    counts = {"main": {}, "rescue": {}}
    where = ["main"]
    fused, rescue = sv.fused_ldlt_solve, bt._rescue_unsolved
    start = _shape_counts()

    def add(c, before):
        for k, n in _shape_counts().items():
            if n != before.get(k, 0):
                c[k] = c.get(k, 0) + n - before.get(k, 0)

    def counted(W, rhs, tol):
        c = counts[where[0]]
        key = (W.shape[-1], W.shape[0])
        c[key] = c.get(key, 0) + 1
        return fused(W, rhs, tol)

    def in_rescue(*a, **k):
        where[0] = "rescue"
        before = _shape_counts() if start is not None else None
        try:
            return rescue(*a, **k)
        finally:
            where[0] = "main"
            if start is not None:
                add(counts["rescue"], before)

    bt._rescue_unsolved = in_rescue
    if start is None:
        sv.fused_ldlt_solve = counted
    try:
        yield counts
    finally:
        sv.fused_ldlt_solve, bt._rescue_unsolved = fused, rescue
        if start is not None:
            # everything since the start, less what the rescue launched
            for k, n in _shape_counts().items():
                d = n - start.get(k, 0) - counts["rescue"].get(k, 0)
                if d:
                    counts["main"][k] = d


def _by_shape(counts):
    return {k: {f"N={N} B={B}": n for (N, B), n in sorted(v.items())} for k, v in counts.items()}


def phase_headline(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.core.status import MSG, status_name
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

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

    l0, h0 = _count("fused_ldlt"), solver.host_syncs
    with _ldlt_shapes() as shapes:
        t0 = time.perf_counter()
        res = vsolve(pb, x0s, rescue=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _count("fused_ldlt") - l0
    # the (N, B) the rescue pass launches most often
    rescue_shape = max(shapes["rescue"].items(), key=lambda kv: kv[1])[0] if shapes["rescue"] else None
    syncs = solver.host_syncs - h0 + sum(
        s.host_syncs for s in solver.__dict__.get("_rescue_siblings", {}).values()
    )
    summ = res.summary()
    _log(f"  headline: solved {summ['solved']}/{B}, wall {wall:.3f} s (rescue included), "
         f"kernel launches {launches}, host syncs {syncs} (pre-rescue pass alone {pre_syncs}), "
         f"pre-rescue failures {breakdown or 'none'}, mean_iter {summ['mean_iter']:.3f}")
    _log(f"  headline LDLT calls by shape: {_by_shape(shapes)}")
    if launches <= 0:
        raise AssertionError("headline rung did not launch the fused LDLT kernel")
    x = res.states.x
    if x.shape != (B, 2) or not bool(torch.isfinite(x[torch.as_tensor(res.solved_mask(), device=dev)]).all()):
        raise AssertionError("headline rung: non-finite solutions on solved lanes")
    if summ["solved"] < 0.99 * B:
        raise AssertionError(f"headline rung solved {summ['solved']}/{B} < 99%")
    return dict(solved=summ["solved"], B=B, wall_s=wall, launches=launches, host_syncs=syncs,
                pre_rescue=breakdown, ldlt_calls=_by_shape(shapes), rescue_shape=rescue_shape,
                pre_status=pre.status, status=res.status)


def phase_ba(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import bundle_adjustment_batch

    dtype = torch.float32
    B = 256
    pb, x0s, datas, x_true = bundle_adjustment_batch(B, 3, 16, dtype=dtype, device=dev)
    solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas",
                            dtype=dtype, device=dev)
    l0 = _count("fused_ldlt")
    with _ldlt_shapes() as shapes:
        t0 = time.perf_counter()
        res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _count("fused_ldlt") - l0
    summ = res.summary()
    ok = res.solved_mask()
    err = float(np.abs(res.solution[ok] - x_true[ok]).max()) if ok.any() else float("nan")
    _log(f"  BA: N={pb.nvar + pb.ncon}, solved {summ['solved']}/{B}, wall {wall:.3f} s, "
         f"kernel launches {launches}, host syncs {solver.host_syncs}, "
         f"max |x - x_true| on solved lanes {err:.3e}, mean_iter {summ['mean_iter']:.3f}, "
         f"LDLT calls by shape {_by_shape(shapes)}")
    if launches <= 0:
        raise AssertionError("BA rung did not launch the fused LDLT kernel")
    if summ["solved"] < 0.99 * B:
        raise AssertionError(f"BA rung solved {summ['solved']}/{B} < 99%")
    return dict(solved=summ["solved"], B=B, wall_s=wall, launches=launches,
                host_syncs=solver.host_syncs, ldlt_calls=_by_shape(shapes))


def phase_parity(dev, matmul_precision=None):
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    B = 64
    x0, d = lm_bench_batch(B, seed=1)
    out = {}
    for where in (dev, torch.device("cpu")):
        pb = lm_bench_family(torch.float64, where)
        s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", matmul_precision=matmul_precision)
        out[where.type] = vsolve(pb, x0, data_batch=d, solver=s, max_iter=50, rescue=True).states
    g, c = out["cuda"], out["cpu"]
    for f in ("status", "iter", "nfact", "nbk", "nlinsolve", "msg"):
        a, b = getattr(g, f).cpu(), getattr(c, f)
        if not torch.equal(a, b):
            lanes = torch.nonzero(a != b).flatten().tolist()
            raise AssertionError(f"card vs CPU: {f} differs on lanes {lanes}")
    err = float((g.x.cpu() - c.x).abs().max())
    _log(f"  card vs CPU (f64, B={B}, matmul_precision={matmul_precision}): counters equal, "
         f"max |x_gpu - x_cpu| {err:.3e}")
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


# Published peaks of one H100 SXM (NVIDIA's data sheet): memory 3.35 TB/s;
# float32 67 TFLOP/s outside the tensor cores (their float32 is TF32, which
# full precision rules out); float64 67 TFLOP/s on the tensor cores (DMMA,
# IEEE float64); bf16 989 TFLOP/s dense on the tensor cores (phase 20's
# one-pass product).
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 67e12, torch.bfloat16: 989e12}


def _bound(nbytes, flops, dtype):
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _chol_bound(B, N, nb, dtype):
    """Bound of a blocked Cholesky with the inverses of its diagonal blocks:
    A's lower triangle read once, L, Linv and d written once; N³/3 flops for
    the factor and nb³/3 for each block inverse (a multiply-add counts as
    two)."""
    item = torch.finfo(dtype).bits // 8
    nbytes = B * item * (N * (N + 1) // 2 + N * N + (N // nb) * nb * nb + N)
    flops = B * (N ** 3 / 3 + (N // nb) * nb ** 3 / 3)
    return _bound(nbytes, flops, dtype)


def _ill_conditioned(N, seed):
    """SPD with κ = 1e6: N·Q diag(geomspace(1, 1e-6)) Qᵀ, Q orthogonal."""
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(N, N)))
    A = (Q * np.geomspace(1.0, 1e-6, N)) @ Q.T * N
    return 0.5 * (A + A.T)[None]


def phase_chol_kernels(dev):
    from cannoles_tpu_torch.ops import block_chol as bc
    from cannoles_tpu_torch.params import Params

    # float32 to 1e-4 relative: a block's elimination is the plain version's
    # operation for operation (--fmad=false), but across blocks the plain
    # version forms L21 = A21 Minvᵀ and the trailing update with
    # torch.matmul, and the kernel by substitution and its own tiles: with
    # κ(A) ≲ 10 for these inputs the factors agree to ~N·eps ≈ 1.8e-4 at
    # worst, 1e-4 holds with margin in practice (measured on an H100:
    # ≤ 2.2e-6).  float64 to 1e-12 for the same reason (measured ≤ 1.9e-15).
    # The ill-conditioned inputs (κ = 1e6) keep these bars for L and d.  L⁻¹
    # and x are as sensitive to rounding as κ(L) = 1e3 and κ(A) make them:
    # L⁻¹ is held at about 10× its worst relative reading on an H100
    # (3.03e-3 f32, 1.01e-11 f64), and x by its backward error
    # ‖A x − b‖∞ / (‖A‖∞ ‖x‖∞ + ‖b‖∞) at about 10× its worst reading
    # (1.49e-8 f32, 4.16e-17 f64).
    bars = {torch.float32: 1e-4, torch.float64: 1e-12}
    ill_linv = {torch.float32: 3e-2, torch.float64: 1e-10}
    ill_back = {torch.float32: 1.5e-7, torch.float64: 5e-16}
    worst = {"fused": 0.0, "block": 0.0}
    worst_ill = {"fused": 0.0, "block": 0.0}  # absolute errors of the κ = 1e6 inputs
    routes = set()

    def check(A, rhs, dtype, tol, N, B, nb, label, want_ok, ill=False):
        Np = -(-N // nb) * nb
        route = "fused" if bc.uses_fused(Np, dtype) else "block"
        l0 = (_count("chol_fused"), _count("chol_block"))
        fac = bc.block_cholesky(A, tol, nb)
        x = bc.block_cho_solve(fac, rhs)
        torch.cuda.synchronize()
        grew = (_count("chol_fused") - l0[0], _count("chol_block") - l0[1])
        ref = bc.block_cholesky_reference(A, tol, nb)
        xr = bc.block_cho_solve(ref, rhs)
        errs = [_rel(a, b) for a, b in ((fac.L, ref.L), (fac.Linv, ref.Linv), (fac.d, ref.d), (x, xr))]
        into = worst_ill if ill else worst
        into[route] = max(into[route], max(e[1] for e in errs))
        finite = all(bool(torch.isfinite(t).all()) for t in (fac.L, fac.Linv, fac.d, x))
        bar = bars[dtype]
        if ill:
            res = (A.double() @ x.double()[..., None])[..., 0] - rhs.double()
            back = float((res.abs().amax(-1) / (A.double().abs().sum(-1).amax(-1) * x.double().abs().amax(-1)
                                                  + rhs.double().abs().amax(-1))).max())
            good = (errs[0][0] <= bar and errs[1][0] <= ill_linv[dtype] and errs[2][0] <= bar
                    and back <= ill_back[dtype])
            extra = f", backward error of x {back:.2e}"
        else:
            good = max(e[0] for e in errs) <= bar
            extra = ""
        _log(f"  chol {str(dtype)[6:]} N={N} B={B} nb={nb} ({route}{label}): worst rel err "
             f"L/Linv/d/x {' '.join(f'{e[0]:.2e}' for e in errs)}{extra}, ok {fac.ok.tolist()}")
        if not (good and finite and fac.ok.tolist() == ref.ok.tolist() == want_ok):
            raise AssertionError(f"Cholesky kernel disagrees with its plain version at "
                                 f"{dtype} N={N} B={B} nb={nb}{label}")
        if grew != ((1, 0) if route == "fused" else (0, Np // nb)):
            raise AssertionError(f"route {route} launched {grew} (fused, block)")
        routes.add(route)

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
                for nb in (256, 128, 512):
                    check(A, rhs, dtype, tol, N, B, nb, "", [True] + [False] * (B - 1))
        N = 1024
        A = torch.as_tensor(_ill_conditioned(N, 11), dtype=dtype, device=dev)
        rhs = torch.as_tensor(np.random.default_rng(12).normal(size=(1, N)), dtype=dtype, device=dev)
        for nb in (256, 512):
            check(A, rhs, dtype, tol, N, 1, nb, ", κ=1e6", [True], ill=True)
    if routes != {"fused", "block"}:
        raise AssertionError(f"routes covered: {routes}")
    return worst, worst_ill


# torch.profiler's readings go through the package's helpers
# (``cannoles_tpu_torch/utils/profiling.py``: the profiler starts at the
# first reading, each session behind a ~100 ms spin, an empty session
# repeated up to 3 times, None where it never records the card).


def _profile_device(fn, what):
    """``utils.profiling.profile_device`` with this script's log: ``fn``'s
    value, the session's events and the card's (None where the profiler
    does not trace the card, or for a package from before the helpers
    moved into it, as ``--against`` an older tree)."""
    try:
        from cannoles_tpu_torch.utils.profiling import profile_device
    except ImportError:
        out = fn()
        torch.cuda.synchronize()
        return out, None, None
    return profile_device(fn, what, log=_log)


def _busy_s(intervals):
    from cannoles_tpu_torch.utils.profiling import busy_s

    return busy_s(intervals)


def _launches(fn):
    """One warm call of fn under ``torch.profiler``: the Cholesky wrappers'
    launches (fused, block) and the device operations by name (kernels,
    copies and memsets: every event whose device is the card; None where
    the profiler does not trace the card)."""
    fn()
    torch.cuda.synchronize()
    counts = []

    def counted():
        l0 = (_count("chol_fused"), _count("chol_block"))
        fn()
        counts.append((_count("chol_fused") - l0[0], _count("chol_block") - l0[1]))

    _, _, events = _profile_device(counted, "one factorization")
    if events is None:
        return counts[-1], None
    names = {}
    for e in events:
        names[e.name] = names.get(e.name, 0) + 1
    return counts[-1], names


def chol_times(dev, plain=True):
    """Phase 7's times, CUDA events: ``block_cholesky`` (factor; factor +
    ``block_cho_solve``) at float32 (fused route) and float64 (blocked
    route) N = 1024, nb = 256, B = 1, and ``chol_block`` on one float64
    nb = 256 block, each against its plain version (unless ``plain`` is
    false), ``torch.linalg.cholesky`` (+ ``torch.cholesky_solve``) and its
    bound; and the wrapper launches and device operations of one
    factorization, counted under ``torch.profiler``."""
    from cannoles_tpu_torch.ops import block_chol as bc
    from cannoles_tpu_torch.params import Params

    def rounds(name, kernel, ref=None, reps_k=10, reps_p=3):
        p1 = _events_ms(ref, reps_p) if ref else None
        k1 = _events_ms(kernel, reps_k)
        k2 = _events_ms(kernel, reps_k)
        p2 = _events_ms(ref, reps_p) if ref else None
        _log(f"  time {name}: {k1:.4f}/{k2:.4f} ms"
             + (f", plain version {p1:.4f}/{p2:.4f} ms" if ref else "") + " (CUDA events)")
        return min(k1, k2), (min(p1, p2) if ref else None)

    def launches(name, fn):
        wrappers, names = _launches(fn)
        ops = None if names is None else sum(names.values())
        _log(f"  launches {name}: wrappers (fused, block) {wrappers}, device operations "
             + ("not measured" if names is None else f"{ops}: " + ", ".join(
                 f"{n} {k[:60]}" for k, n in sorted(names.items(), key=lambda kv: -kv[1]))))
        return dict(wrapper_launches_per_factorization=list(wrappers),
                    device_launches_per_factorization=ops)

    times = {}
    for dtype, key in ((torch.float32, "fused"), (torch.float64, "blocked")):
        tol = Params.for_dtype(dtype).eig_tol
        rng = np.random.default_rng(0)
        G = rng.normal(size=(1, 1024, 1024))
        A = torch.as_tensor(G @ G.transpose(0, 2, 1) + 1024 * np.eye(1024), dtype=dtype, device=dev)
        b = torch.as_tensor(rng.normal(size=(1, 1024)), dtype=dtype, device=dev)
        name = f"{str(dtype)[6:]} N=1024 nb=256 ({key} route)"
        k, p = rounds(f"{name}, factor", lambda: bc.block_cholesky(A, tol, 256),
                      (lambda: bc.block_cholesky_reference(A, tol, 256)) if plain else None)
        ks, _ = rounds(f"{name}, factor + block_cho_solve",
                       lambda: bc.block_cho_solve(bc.block_cholesky(A, tol, 256), b))
        lib_solve, _ = rounds(f"{name}, torch.linalg.cholesky + torch.cholesky_solve",
                              lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky(A)))
        lib = min(_events_ms(lambda: torch.linalg.cholesky(A)) for _ in range(2))
        bound, by = _chol_bound(1, 1024, 256, dtype)
        _log(f"  time {name}: torch.linalg.cholesky {lib:.4f} ms; bound {bound:.5f} ms ({by})")
        times[key] = dict(ms=k, plain_ms=p, bound_ms=bound, bound_by=by, library_ms=lib,
                          library_call="torch.linalg.cholesky (L only)", ms_with_solve=ks,
                          torch_cholesky_solve_ms=lib_solve,
                          **launches(name, lambda: bc.block_cholesky(A, tol, 256)))
        if dtype == torch.float64:
            Ab = A[:, :256, :256].contiguous()
            k, p = rounds("f64 one block nb=256 (block kernel alone)", lambda: bc.chol_block(Ab, tol),
                          (lambda: bc.chol_block_reference(Ab, tol)) if plain else None)
            lib = min(_events_ms(lambda: torch.linalg.cholesky(Ab)) for _ in range(2))
            bound, by = _chol_bound(1, 256, 256, dtype)
            _log(f"  time f64 nb=256 torch.linalg.cholesky {lib:.4f} ms; bound {bound:.5f} ms ({by})")
            times["block"] = dict(ms=k, plain_ms=p, bound_ms=bound, bound_by=by, library_ms=lib,
                                  library_call="torch.linalg.cholesky (L only)")
    return times


def _solve_summary(st):
    ss = st.solver_specific
    return (f"{st.status}, iter {st.iter}, nfact {ss['nfact']}, nlinsolve {ss['nlinsolve']}, "
            f"nbk {ss['nbk']}, msg '{ss['internal_msg']}'")


def _chol_cell(name, pb, x_true, solver_kw, solve_kw, bar, warm=3):
    """One ``linsolve="chol"`` cell at both seams (``pallas_chol_min=0``: the
    Cholesky kernels; default: ``torch.linalg.cholesky``): one solver per
    seam, its first solve (with the solver's one-time warm-up and graph
    captures), ``warm`` more, then one under ``torch.profiler``.  Every solve must end ``first_order`` with max
    |x − x_true| ≤ ``bar`` and launch the fused kernel at the kernel seam
    only.  For the profiled solve: the device's busy time (the union of the
    intervals of the events whose device is the card, each kernel once),
    its share of the profiled wall and of the median wall, and the five
    kernels with the most device time."""

    from cannoles_tpu_torch import CaNNOLeSSolver

    dev = pb.x0.device
    xt = torch.as_tensor(x_true, device=dev, dtype=torch.float64)
    out = {}
    solvers = {pcm: CaNNOLeSSolver(pb, kkt="condensed", linsolve="chol", pallas_chol_min=pcm,
                                   dtype=torch.float32, device=dev, **solver_kw) for pcm in (0, None)}

    def solve(pcm, label):
        seam = "kernel" if pcm == 0 else "default"
        s = solvers[pcm]
        h0 = s.host_syncs
        l0 = _count("chol_fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.solve(max_time=600.0, **solve_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count("chol_fused") - l0
        err = float((torch.as_tensor(st.solution, device=dev, dtype=torch.float64) - xt).abs().max())
        _log(f"  {name} ({seam} seam, {label}): {_solve_summary(st)}, wall {wall:.3f} s "
             f"(solve clock {st.elapsed_time:.4f} s), max |x - x_true| {err:.3e}, fused kernel launches "
             f"{launches}, host syncs {s.host_syncs - h0}")
        if st.status != "first_order" or not err <= bar:
            raise AssertionError(f"{name} ({seam} seam): {st.status}, error {err}")
        if (launches > 0) != (pcm == 0):
            raise AssertionError(f"{name} ({seam} seam): {launches} fused kernel launches")
        cell = out.setdefault(seam, {})
        cell.update(iter=st.iter, nfact=st.solver_specific["nfact"],
                    nlinsolve=st.solver_specific["nlinsolve"], err=err)
        cell.setdefault("launches", []).append(launches)
        return wall

    for rep in range(1 + warm):
        for pcm, seam in ((0, "kernel"), (None, "default")):
            wall = solve(pcm, "first" if rep == 0 else "warm")
            out[seam].setdefault("walls_s", []).append(wall)
    for pcm, seam in ((0, "kernel"), (None, "default")):
        wall, _, events = _profile_device(lambda: solve(pcm, "profiled"), f"{name} ({seam} seam)")
        if events is None:
            _log(f"  {name} ({seam} seam): device busy time not measured (profiled wall {wall} s)")
            out[seam].update(profiled_wall_s=wall, device_busy_s=None, device_events=None, top_kernels_ms=None)
            continue
        busy = _busy_s([(e.time_range.start, e.time_range.end) for e in events])
        by_name = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        med = float(np.median(out[seam]["walls_s"][1:]))
        _log(f"  {name} ({seam} seam): device busy {busy} s over {len(events)} events in a profiled "
             f"wall of {wall} s ({busy / wall:.3f} of it, {busy / med:.3f} of the median warm wall {med} s)")
        for kname, ms in top:
            _log(f"    {ms:.3f} ms  {kname[:100]}")
        out[seam].update(profiled_wall_s=wall, device_busy_s=busy, device_events=len(events),
                         top_kernels_ms={k[:100]: ms for k, ms in top})
    return out


def phase_large_rung(dev):
    from cannoles_tpu_torch.models.families import large_rung_problem

    pb, x_true, _ = large_rung_problem(dtype=torch.float32, device=dev)
    return _chol_cell("large rung 8192x1024 f32", pb, x_true,
                      dict(method="gauss_newton", block_size=256), dict(max_iter=30), 1e-3)


def phase_ba_large(dev):
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment

    pb, x_true = large_bundle_adjustment(16, 300, dtype=torch.float32, device=dev)
    # no bar on the solution: the scene is held to first_order only
    return _chol_cell("BA 16x300 f32 LM", pb, x_true, dict(method="lm"), {}, float("inf"))


def phase_ba_parity(dev):
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment

    out = {}
    for where in (dev, torch.device("cpu")):
        pb, _ = large_bundle_adjustment(16, 300, dtype=torch.float64, device=where)
        s = CaNNOLeSSolver(pb, method="lm", kkt="condensed", linsolve="chol", pallas_chol_min=0)
        l0 = _count("chol_block")
        t0 = time.perf_counter()
        out[where.type] = s.solve(max_time=1200.0)
        wall = time.perf_counter() - t0
        _log(f"  BA 16x300 f64 LM on {where.type}: {_solve_summary(out[where.type])}, "
             f"wall {wall:.3f} s, block kernel launches {_count("chol_block") - l0}")
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


# Phase 11, card vs CPU on the battery's uniform pass in float64.  Both
# sides run the same code; the card's reductions (cuBLAS, and the solver's
# sums over the batch-leading tensors) add in another order than the CPU's,
# so a trajectory that passes near a threshold can take the other side.
# Problems whose counters (iter, nfact, nlinsolve) differ between the card
# and the CPU, each with its reason; status must agree all the same, except
# for those in BATTERY_STATUS.
BATTERY_COUNTERS = {
    # rank-deficient constrained Jacobian: its multipliers are fixed only up
    # to rounding, and the ρ ladder's decisions follow them (the JAX
    # runner's rescue 1b exists for this row in float32)
    "brown_almost_linear+linear": "rank-deficient constraint Jacobian",
    # a rank-1 J: the ρ = 0 attempt's pivot lands within rounding of eig_tol
    "linear_rank1": "ρ = 0 inertia test at eig_tol",
    # ~600 factorizations in δ-thrashing inner loops: one ρ-ladder attempt
    # flips (the JAX package on the CPU counts 595, the port 597)
    "lvcon_wood_broyden_12": "ρ-ladder knife edge (also JAX vs port)",
    "hs27": "δ at √eps multiplies rounding by ~7e7 (see BATTERY_STATUS)",
}
# hs27 with the default configuration thrashes δ at its floor √eps: the
# multiplier update λ ← λ − c/δ multiplies rounding by ~7e7, so the card
# and the CPU part within the first iterations; the CPU (as the JAX
# package) runs to max_eval, the card may find a first-order point.
BATTERY_STATUS = {"hs27": "δ-floor thrash amplifies rounding (ROADMAP queue 3)"}
# Phase 12, float32 with the rescues: rows known to stay unsolved, each a
# float32 knife edge, not a fault (printed, not a gate: the gate is ≥ 86).
BATTERY_F32_UNSOLVED = {
    # rescue 1b's steps from the JAX package's own float32 states take its
    # decisions for 28 outer iterations; the whole runs part by rounding
    # and end exception (port) and first_order (JAX): tests/test_torch_fault_a.py
    "brown_almost_linear+linear": "float32 knife edge under rescue 1b (ROADMAP queue 3, closed)",
}
# Problems whose solutions, with equal counters, differ by more than 1e-10
# relative: each stops (rtol=1e-5) where F or J is nearly rank-deficient,
# so x is fixed only to rounding × 1/σ_min along some direction.  Their
# witness: the JAX package and the port, both on one CPU, part by the same
# order (a fifth as much to more; tests/test_torch_battery_dx.py), where
# the other rows agree to 1e-10.  name -> (bar on the relative
# |x_gpu - x_cpu|, bar on the relative |Σf²_gpu - Σf²_cpu|): ten times the
# reading of this script on an H100, and 1e-10 for Σf² wherever the
# reading lies below it.
BATTERY_DX = {
    "brown_almost_linear": (3.5e-5, 6.9e-9), "wood": (1.8e-7, 1.6e-9), "wood+linear": (1.2e-6, 1.9e-8),
    "watson_12": (1e-7, 1e-10), "linear_rank1_zero": (3.2e-8, 2.1e-9),
    "brown_almost_linear_25": (4e-8, 1e-10), "powell_badly_scaled": (7.6e-9, 1e-10),
    "meyer": (2.2e-9, 1.7e-8), "variably_dimensioned": (2.1e-9, 1e-10), "vardim_20": (2.4e-9, 1e-10),
    "linear_full_rank": (1.1e-9, 1e-10), "linear_full_rank_40_60": (2.8e-9, 1e-10),
    "ext_rosenbrock+linear": (2.5e-9, 1e-10), "variably_dimensioned+linear": (1.3e-9, 2.1e-9),
    "hs50": (1.2e-9, 1e-10),
}
# The battery's longest rows on an H100 host, submitted to the pool first
# so that its wall comes close to the longest row's (biggs_exp6_24 in
# float64 on the card: one worker holds it from the start, the other rows
# spread over the rest).
BATTERY_SLOW = ("biggs_exp6_24", "hs27", "trigonometric_20", "kowalik_osborne", "biggs_exp6",
                "brown_almost_linear+linear", "hs77", "meyer", "lvcon_wood_broyden_12", "gulf")
BATTERY_SETTINGS = {  # label: (dtype, device, max_time, rescue)
    "f64 card": (torch.float64, "cuda", float("inf"), False),
    "f32 card": (torch.float32, "cuda", 60.0, True),
    "f64 cpu": (torch.float64, "cpu", float("inf"), False),
}


def _worker_init():
    # one intra-op thread: the workers share the host's cores
    torch.set_num_threads(1)


def battery_pool(workers, meanwhile=None):
    """Phases 11 and 12's 270 solves (the 90 problems in each of
    BATTERY_SETTINGS) in one pool of ``workers`` processes, the longest
    rows first; ``meanwhile()`` runs in this process while the workers
    solve.  Returns ``({label: (rows, summary)}, wall seconds, what
    meanwhile returned)``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    from cannoles_tpu_torch import battery

    items = battery.collect()
    rank = {n: k for k, n in enumerate(BATTERY_SLOW)}
    order = sorted(range(len(items)), key=lambda i: rank.get(items[i][1], len(rank)))
    t0 = time.perf_counter()
    # spawned: a CUDA context does not survive a fork
    with ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_worker_init) as pool:
        futures = {}
        for i in order:
            for label, (dtype, device, max_time, rescue) in BATTERY_SETTINGS.items():
                f = pool.submit(battery.solve_index, i, dtype=dtype, device=device,
                                max_time=max_time, rescue=rescue)
                futures[f] = (label, i)
        side = meanwhile() if meanwhile is not None else None
        rows = {label: [None] * len(items) for label in BATTERY_SETTINGS}
        for f in as_completed(futures):
            label, i = futures[f]
            r = rows[label][i] = f.result()
            _log(f"  [{label}] {r['family']:8s} {r['name']:30s} {r['status']:<16s} iter={r['iter']:<4} "
                 f"Σf²={r['fsumsq']:<12.5g} t={r['time']:.2f}s syncs={r['host_syncs']} "
                 f"rescue={r['rescue']} (done at {time.perf_counter() - t0:.1f} s)")
    wall = time.perf_counter() - t0
    out = {}
    for label, rs in rows.items():
        bad = [r["name"] for r in rs if str(r["status"]).startswith("error:")]
        if bad:
            raise AssertionError(f"battery ({label}): problems raised: {bad}")
        out[label] = (rs, battery.summarize(rs, wall_s=sum(r["time"] for r in rs)))
    return out, wall, side


def phase_battery_parity(dev, pool_rows):
    """Phase 11: the runner's uniform pass in float64 on the card and on
    the CPU, problem by problem; multistart on freudenstein_roth on both."""
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models import mgh_problem
    from cannoles_tpu_torch.parallel.multistart import multistart

    (g_rows, g_summ), (c_rows, c_summ) = pool_rows["f64 card"], pool_rows["f64 cpu"]
    for where, summ in (("card", g_summ), ("CPU", c_summ)):
        _log(f"  uniform pass f64 on the {where}: solved {summ['solved_uniform']}/{summ['n']}, "
             f"sum of row times {summ['wall_s']:.3f} s, by family {summ['by_family_uniform']}")
    worst, differ, status_differ, loose, faults = 0.0, [], [], {}, []
    for g, c in zip(g_rows, c_rows):
        name = g["name"]
        if g["status"] != c["status"]:
            status_differ.append((name, g["status"], c["status"]))
            if name not in BATTERY_STATUS:
                faults.append(f"{name}: status {g['status']} vs {c['status']}")
        cg, cc = (g["iter"], g["nfact"], g["nlinsolve"]), (c["iter"], c["nfact"], c["nlinsolve"])
        if cg != cc:
            differ.append((name, cg, cc))
            if name not in BATTERY_COUNTERS:
                faults.append(f"{name}: iter/nfact/nlinsolve {cg} vs {cc}")
            continue
        xg, xc = np.asarray(g["solution"]), np.asarray(c["solution"])
        err = float(np.abs(xg - xc).max() / max(1.0, np.abs(xc).max()))
        df = abs(g["fsumsq"] - c["fsumsq"]) / max(1.0, c["fsumsq"])
        if name in BATTERY_DX:
            loose[name] = (err, df)
            bar_x, bar_f = BATTERY_DX[name]
            if not (err <= bar_x and df <= bar_f):
                faults.append(f"{name}: solutions differ by {err} (bar {bar_x}), Σf² by {df} (bar {bar_f})")
            continue
        worst = max(worst, err)
        if not err <= 1e-10:
            faults.append(f"{name}: solutions differ by {err} (relative)")
    if faults:
        raise AssertionError("card vs CPU on the battery: " + "; ".join(faults))
    _log(f"  card vs CPU: statuses equal on {len(g_rows) - len(status_differ)}/{len(g_rows)} "
         f"(differ, named: {status_differ or 'none'}); counters equal on "
         f"{len(g_rows) - len(differ)} (differ, named: {differ or 'none'}); worst relative "
         f"|x_gpu - x_cpu| {worst:.3e} over the rest, named ill-conditioned ones: {loose}")
    ms = {}
    for where in (dev, torch.device("cpu")):
        pb = mgh_problem("freudenstein_roth", device=where)
        s = CaNNOLeSSolver(pb)
        ms[where.type] = (multistart(pb, n_starts=64, atol=0.0, rtol=1e-5, max_inner=100, max_eval=5000,
                                     solver=s), s.host_syncs)
    (a, a_syncs), (b, b_syncs) = ms["cuda"], ms["cpu"]
    _log(f"  multistart freudenstein_roth f64: card {a.status} lane {a.solver_specific['best_lane']} "
         f"({a.solver_specific['n_solved']} solved, {a_syncs} syncs), CPU {b.status} lane "
         f"{b.solver_specific['best_lane']} ({b.solver_specific['n_solved']} solved, {b_syncs} syncs), "
         f"2f {2 * a.objective:.3e}")
    if (a.status, a.solver_specific["best_lane"]) != (b.status, b.solver_specific["best_lane"]):
        raise AssertionError("multistart: card and CPU disagree on the best lane or its status")
    slow = sorted(g_rows, key=lambda r: -r["time"])[:5]
    return dict(n=g_summ["n"], solved_uniform_card=g_summ["solved_uniform"],
                solved_uniform_cpu=c_summ["solved_uniform"], row_seconds_card=g_summ["wall_s"],
                row_seconds_cpu=c_summ["wall_s"], status_differ=status_differ, counters_differ=differ,
                worst_rel_dx=worst, named_rel_dx=loose,
                slowest_card=[(r["name"], r["time"], r["host_syncs"]) for r in slow])


def _profiled_solve(dev, name):
    """One uniform battery solve (float32 on the card) under
    ``torch.profiler``: the device's busy share of its wall."""
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.battery import collect

    make = next(it[2] for it in collect() if it[1] == name)
    pb = make(dtype=torch.float32, device=dev)
    s = CaNNOLeSSolver(pb, linsolve="ldlt")
    s.solve(atol=0.0, rtol=1e-5, max_time=60.0)  # warm: the solver's one-time costs and graph captures

    def timed():
        h0 = s.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = s.solve(atol=0.0, rtol=1e-5, max_time=60.0)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0, s.host_syncs - h0

    (st, wall, syncs), _, events = _profile_device(timed, "the battery solve")
    busy = None if events is None else _busy_s([(e.time_range.start, e.time_range.end) for e in events])
    _log(f"  profiled solve {name} f32: {_solve_summary(st)}, host syncs {syncs}, device busy "
         + ("not measured" if events is None else f"{busy} s over {len(events)} events")
         + f" in a wall of {wall} s" + ("" if events is None else f" ({busy / wall:.4f})"))
    return dict(problem=name, wall_s=wall, device_busy_s=busy, busy_share=None if events is None else busy / wall,
                device_events=None if events is None else len(events), host_syncs=syncs)


def phase_battery(dev, pool_rows, pool_wall):
    """Phase 12: the whole runner with its rescues in float32 on the card."""
    rows, summ = pool_rows["f32 card"]
    _log(f"  battery f32 on the card: solved {summ['solved']}/{summ['n']} (uniform "
         f"{summ['solved_uniform']}), sum of row times {summ['wall_s']:.3f} s, wall of the pool "
         f"(all three settings) {pool_wall:.3f} s")
    _log(f"  by family {summ['by_family']}, uniform {summ['by_family_uniform']}, "
         f"rows each rescue solved {summ['by_rescue']}")
    slow = sorted(rows, key=lambda r: -r["time"])[:5]
    _log("  slowest: " + ", ".join(f"{r['name']} {r['time']:.3f} s ({r['host_syncs']} syncs)" for r in slow))
    ms_rows = [(r["name"], r["multistart_host_syncs"], r["rescue"]) for r in rows
               if r["multistart_host_syncs"] is not None]
    _log(f"  multistart rows (name, host syncs of the sweep, rescue): {ms_rows}")
    unsolved = [r["name"] for r in rows if not r["solved"]]
    _log(f"  unsolved, named float32 knife edges: {[n for n in unsolved if n in BATTERY_F32_UNSOLVED]}; "
         f"not named: {[n for n in unsolved if n not in BATTERY_F32_UNSOLVED]}")
    if summ["solved"] < 86:
        raise AssertionError(f"battery f32 solved {summ['solved']}/90 < 86")
    prof = _profiled_solve(dev, "beale")
    return dict(summary=summ, pool_wall_s=pool_wall,
                slowest=[(r["name"], r["time"], r["host_syncs"]) for r in slow],
                multistart_rows=ms_rows, profiled=prof,
                unsolved=[r["name"] for r in rows if not r["solved"]])


def phase_deadline(dev, head):
    """Phase 13: the headline family through ``vsolve(max_time=...)`` with
    ``linsolve='auto'``: a budget of 0 dispatches chunk 0 alone (statuses
    equal to phase 4's first chunk before its rescue) and stamps every
    later lane max_time; a budget that never binds gives phase 4's
    statuses lane for lane."""
    from cannoles_tpu_torch import Status, vsolve
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    dtype = torch.float32
    B, chunk = 65536, 16384
    pb = lm_bench_family(dtype, dev)
    x0, d = lm_bench_batch(B, seed=0)
    kw = dict(data_batch=torch.as_tensor(d, dtype=dtype, device=dev), method="lm",
              kkt="full", linsolve="auto", max_iter=50, chunk_size=chunk, max_eval=48, rescue=True)
    x0s = torch.as_tensor(x0, dtype=dtype, device=dev)
    out = {}
    for budget in (0.0, 600.0):
        l0 = _count("fused_ldlt")
        t0 = time.perf_counter()
        res = vsolve(pb, x0s, max_time=budget, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count("fused_ldlt") - l0
        st = res.status
        if res.solver.linsolve != "pallas":
            raise AssertionError(f"deadline: 'auto' routed to {res.solver.linsolve}")
        if launches <= 0:
            raise AssertionError(f"deadline (max_time={budget}): no fused LDLT launch")
        if budget == 0.0:
            late = int((st[chunk:] == int(Status.MAX_TIME)).sum())
            same0 = bool((st[:chunk] == head["pre_status"][:chunk]).all())
            _log(f"  max_time=0: chunk 0 solved {int(res.solved_mask()[:chunk].sum())}/{chunk}, "
                 f"statuses of chunk 0 equal to phase 4's pre-rescue pass {same0}, lanes "
                 f"{chunk}+ max_time {late}/{B - chunk}, launches {launches}, wall {wall:.3f} s")
            if not (same0 and late == B - chunk):
                raise AssertionError("deadline max_time=0: wrong dispatch")
        else:
            same = bool((st == head["status"]).all())
            _log(f"  max_time=600: solved {res.summary()['solved']}/{B}, statuses equal to phase 4's "
                 f"{same}, launches {launches}, wall {wall:.3f} s")
            if not same:
                raise AssertionError("deadline max_time=600: statuses differ from phase 4's")
        out[f"max_time={budget:g}"] = dict(launches=launches, wall_s=wall,
                                           solved=res.summary()["solved"])
    return out


# Phase 14: benchmarks/bench_ba_large.py's scene at its full width (100
# cameras, 10,000 landmarks: n = 30,600, m = 2,000,000), float32, through
# both engines and both gauges.  Bars on each run's max |x − x_true|: twice
# the first reading of this scene on an H100 (NVIDIA H100 80GB HBM3, 700 W,
# torch 2.11: 7.1e-4, 6.4e-2, 2.3e-6, 8.7e-5), rounded up.  The solves are
# deterministic on one software stack; twice leaves room for another
# rounding path (a cuBLAS algorithm choice), and a larger error means the
# trajectory changed.  The frozen-gauge CG run stops at rtol = 1e-5 after
# two outer iterations with CG at its float32 tolerance eps^0.45 ≈ 7.6e-4:
# its x is that loose by design, not by fault.
BA_SCENE = (100, 10_000)
BA_SCENE_RECOVERY_BAR = {
    ("fixed", "schur"): 2e-3, ("fixed", "matfree_cg"): 0.13,
    ("constraints", "schur"): 5e-6, ("constraints", "matfree_cg"): 2e-4,
}
# Phase 15: small scenes in float64 on the card and on the CPU under the
# benchmark protocol (atol = 0, rtol = 1e-5, max_iter = 60).
BA_PARITY_CASES = ((3, 12, "constraints"), (4, 40, "fixed"))
BA_PARITY_TOL = dict(atol=0.0, rtol=1e-5, max_iter=60, max_time=600.0)
# The generic CG engine stops CG at eps^0.45, where the iteration count and
# the last digits of x follow rounding (the JAX package and the port on one
# CPU part the same way: tests/test_torch_ba_matfree.py).  Its runs keep
# status, iter, nfact and nlinsolve equal; ncg within 2 or 2% and x within
# 1e-8 (ten times the H100's largest reading, 7.8e-10 on 4x40).
BA_PARITY_NAMED = {
    "3x12 constraints matfree": "CG iteration count at eps^0.45 (knife edge; equal here on an H100, "
                                "824 vs 828 at tests/test_torch_gpu.py's tolerances)",
    "4x40 fixed matfree": "CG iteration count at eps^0.45 (knife edge; 61 vs 62 on an H100)",
}


def phase_ba_scene(dev):
    """Phase 14: ``bench_ba_large.run_scene`` in both gauges; every run
    must end first_order with max |x − x_true| ≤ BA_SCENE_RECOVERY_BAR."""
    from cannoles_tpu_torch.bench_ba_large import run_scene

    out = {}
    for gauge in ("fixed", "constraints"):
        t0 = time.perf_counter()
        res = run_scene(*BA_SCENE, gauge=gauge, device=dev, dtype=torch.float32,
                        log=lambda *a: _log("   ", *a))
        res["scene_wall_s"] = time.perf_counter() - t0
        for eng in ("schur", "matfree_cg"):
            r = res[eng]
            _log(f"  {gauge} {eng}: {r['status']}, iter {r['iter']}, nfact {r['nfact']}, ncg {r['ncg']}, "
                 f"objective {r['objective']:.4e}, max |x - x_true| {r['recovery_err']:.4e}, "
                 f"wall {r['wall_s']:.3f} s, device span {r['device_solve_s']:.3f} s, busy share "
                 f"{r['busy_share']:.4f} ({r['device_busy_s']:.4f} of a {r['window_wall_s']:.4f} s window), "
                 f"host syncs {r['host_syncs']}, peak device memory {r['peak_mem_gb']:.3f} GB")
            if r["status"] != "first_order" or not r["recovery_err"] <= BA_SCENE_RECOVERY_BAR[gauge, eng]:
                raise AssertionError(f"BA scene {gauge} {eng}: {r['status']}, error {r['recovery_err']}")
        _log(f"  {gauge} gauge: both engines in {res['scene_wall_s']:.3f} s")
        out[gauge] = res
    return out


def phase_ba_scene_parity(dev):
    """Phase 15: both engines in float64 on the card and on the CPU (status
    and counters equal, solutions within 1e-10 unless named in
    BA_PARITY_NAMED); then checkpoints on the card: a solve saved at
    max_iter=2, loaded and resumed equals the straight-through solve bit
    for bit (SchurBASolver, and the dense solver on a battery problem)."""
    import tempfile

    from cannoles_tpu_torch import (CaNNOLeSSolver, MatrixFreeSolver, SchurBASolver, ba_block_jacobi,
                                    load_state, save_state)
    from cannoles_tpu_torch.battery import collect
    from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment

    out = {}
    for C, P, gauge in BA_PARITY_CASES:
        for eng in ("schur", "matfree"):
            runs = []
            for where in (dev, torch.device("cpu")):
                pb, _ = large_bundle_adjustment(C, P, noise=0.0, seed=0, gauge=gauge,
                                                dtype=torch.float64, device=where)
                frozen = pb.data["gidx"].cpu().numpy() if gauge == "fixed" else None
                s = (SchurBASolver(pb, C, P, frozen_cam_coords=frozen) if eng == "schur" else
                     MatrixFreeSolver(pb, cg_maxiter=500, precond=ba_block_jacobi(C, P)))
                t0 = time.perf_counter()
                runs.append((s.solve(**BA_PARITY_TOL), time.perf_counter() - t0))
            (g, tg), (c, tc) = runs
            key = f"{C}x{P} {gauge} {eng}"
            cg = (g.status, g.iter, *(g.solver_specific[k] for k in ("nfact", "ncg", "nlinsolve")))
            cc = (c.status, c.iter, *(c.solver_specific[k] for k in ("nfact", "ncg", "nlinsolve")))
            dx = float(np.abs(g.solution - c.solution).max())
            _log(f"  {key} f64: card {cg} in {tg:.3f} s, CPU {cc} in {tc:.3f} s, max |x_gpu - x_cpu| {dx:.3e}")
            if key in BA_PARITY_NAMED:
                ok = (cg[:3] + cg[4:] == cc[:3] + cc[4:] and abs(cg[3] - cc[3]) <= max(2, 0.02 * cc[3])
                      and dx <= 1e-8)
            else:
                ok = cg == cc and dx <= 1e-10
            if not ok:
                raise AssertionError(f"card vs CPU ({key}): {cg} vs {cc}, dx {dx}")
            out[key] = dict(card=cg, cpu=cc, dx=dx, card_s=tg, cpu_s=tc)
    tol = dict(atol=1e-14, rtol=0.0)
    pb, _ = large_bundle_adjustment(3, 12, noise=0.0, seed=0, dtype=torch.float64, device=dev)
    dense_pb = next(it[2] for it in collect() if it[1] == "rosenbrock+linear")(dtype=torch.float64, device=dev)
    cases = (("SchurBASolver 3x12", lambda: SchurBASolver(pb, 3, 12), tol, pb.data),
             ("CaNNOLeSSolver rosenbrock+linear", lambda: CaNNOLeSSolver(dense_pb),
              dict(atol=0.0, rtol=1e-5), None))
    with tempfile.TemporaryDirectory() as tmp:
        for name, make, skw, template in cases:
            s = make()
            first = s.solve(max_iter=2, **skw)
            path = pathlib.Path(tmp) / "state.npz"
            save_state(path, s.last_state)
            # no tolerance keywords: they ride the state (given, they would re-target it)
            resumed = s.solve(resume_from=load_state(path, data_template=template, device=dev))
            straight = make().solve(**skw)
            same = (resumed.status, resumed.iter) == (straight.status, straight.iter) and np.array_equal(
                resumed.solution, straight.solution)
            _log(f"  checkpoint {name} on the card: saved at iter {first.iter} ({first.status}), resumed "
                 f"{resumed.status} iter {resumed.iter}, straight {straight.status} iter {straight.iter}, "
                 f"bit-equal {same}")
            if not same:
                raise AssertionError(f"checkpoint {name}: resume differs from the straight-through solve")
            out[f"checkpoint {name}"] = dict(iter=straight.iter, status=straight.status)
    return out


# Phase 16: the first H100 reading of the fit (NVIDIA H100 80GB HBM3,
# 700 W, torch 2.11): first_order after 1 outer iteration and 6 CG
# iterations, objective 4.702459 (523,131.6 at w = 0), max |w − w_true|
# 0.0534, peak device memory 1.26 GB.  w is not identifiable (4,096
# frequencies in [1, 50] make sin(t fᵀ) numerically rank-deficient), so the
# error is a reading of this trajectory: its bar is twice the first
# reading, rounded up; a larger error, or an objective more than ten times
# the first, means the trajectory changed.
FIT = (2**21, 4096)
FIT_OBJECTIVE_FIRST = 4.702459
FIT_OBJECTIVE_FACTOR = 10.0
FIT_PARAM_ERR_BAR = 0.11
# an eighth of the Jacobian that is never formed (m·n·4 B = 34.4 GB)
FIT_PEAK_GB = 4.0
# Phase 17.  The fit's float64 knife edges (tests/test_torch_separable.py):
# w is not identifiable and CG stops at eps^0.45, so ncg and x follow the
# order in which the products are summed; the JAX package's own solves
# with the products summed in other orders spread ncg over 78-95 (around
# 80) and x by 4.5e-9.  Bars: twice and ten times that.
FIT_PARITY = (16_384, 256)
FIT_PARITY_NCG = 30
FIT_PARITY_DX = 5e-8


def phase_fit(dev):
    """Phase 16: the huge separable fit at full width; see FIT_*."""
    from cannoles_tpu_torch.bench_matfree import run_fit

    r = run_fit(*FIT, cg_maxiter=100, device=dev, dtype=torch.float32)
    r.pop("solution")
    r["ms_per_product"] = 1e3 * r["device_solve_s"] / r["products"]
    _log(f"  m={r['m']} n={r['n']} float32 (J would be {r['jac_gb']:.1f} GiB, never formed): {r['status']}, "
         f"iter {r['iter']}, nfact {r['nfact']}, ncg {r['ncg']}, objective {r['objective']:.6g} (at w = 0 "
         f"{r['objective0']:.6g}), max |w - w_true| {r['param_err']:.4e}, wall {r['wall_s']:.3f} s, device span "
         f"{r['device_solve_s']:.3f} s, {r['products']} tiled products ({r['ms_per_product']:.2f} ms each), "
         f"host syncs {r['host_syncs']}, peak device memory {r['peak_mem_gb']:.3f} GB, busy share "
         f"{r['busy_share']:.4f} ({r['device_busy_s']:.4f} of a {r['window_wall_s']:.4f} s window, "
         f"{r['device_events']} device events)")
    # one product of each kind alone, against the traffic of the tiled
    # version: every block written by the multiply, read and written by
    # sin_, read by the matmul (4·m·n·4 bytes)
    from cannoles_tpu_torch import bench_matfree as bm

    m, n = FIT
    pb, _ = bm.separable_fit_problem(m, n, dtype=torch.float32, device=dev)
    t, f = pb.data["t"], pb.data["f"]
    w, u = torch.ones(n, device=dev), torch.ones(m, device=dev)
    r["forward_ms"] = _events_ms(lambda: bm._matvec(t, f, w), reps=5)
    r["transpose_ms"] = _events_ms(lambda: bm._rmatvec(t, f, u), reps=5)
    r["traffic_bound_ms"] = 1e3 * 4 * m * n * 4 / HBM_BYTES_S
    del pb, t, f
    _log(f"  one tiled product alone: forward {r['forward_ms']:.3f} ms, transpose {r['transpose_ms']:.3f} ms; "
         f"the tiled version's traffic ({4 * m * n * 4 / 1e9:.1f} GB) at 3.35 TB/s: {r['traffic_bound_ms']:.3f} ms")
    bad = []
    if r["status"] not in ("first_order", "small_residual"):
        bad.append(f"status {r['status']}")
    if not r["objective"] <= min(1e-3 * r["objective0"], FIT_OBJECTIVE_FACTOR * FIT_OBJECTIVE_FIRST):
        bad.append(f"objective {r['objective']}")
    if not r["peak_mem_gb"] <= FIT_PEAK_GB:
        bad.append(f"peak device memory {r['peak_mem_gb']} GB")
    if not r["param_err"] <= FIT_PARAM_ERR_BAR:
        bad.append(f"max |w - w_true| {r['param_err']}")
    if bad:
        raise AssertionError("separable fit: " + ", ".join(bad))
    return r


def phase_fit_parity(dev):
    """Phase 17: the fit at FIT_PARITY in float64 on the card and on the
    CPU, then ``linsolve="cpp"`` against ``"ldlt"`` on the card.

    The fit's named knife edge: after the first outer step the first-order
    test compares epstol with ‖∇L‖∞, the residual of a CG whose own
    tolerance bounds it only by eps^0.45·‖JᵀF(0)‖₂, above epstol; there the
    reading follows the order of summation (2.4e-5 to 2.3e-4 over seven
    orders on one CPU, epstol 5.4e-5), so one run may stop after step 1 and
    the other go on.  Where the iteration counts differ, each run must read
    at most that bound and must have stopped after step 1 exactly when its
    reading was at most epstol."""
    from cannoles_tpu_torch import CaNNOLeSSolver, MatrixFreeSolver, nls_problem
    from cannoles_tpu_torch.bench_matfree import MAX_ITER, MAX_TIME, separable_fit_problem

    runs = []
    for where in (dev, torch.device("cpu")):
        pb, _ = separable_fit_problem(*FIT_PARITY, dtype=torch.float64, device=where)
        s = MatrixFreeSolver(pb, cg_maxiter=100)
        duals, b0 = [], []

        def trace(_, state, __):
            duals.append(float(state.normdual[0]))
            if not b0:
                b0.append(float(torch.linalg.vector_norm(state.dual[0])))

        t0 = time.perf_counter()
        st = s.solve(max_time=MAX_TIME, max_iter=MAX_ITER, callback=trace)
        runs.append((st, duals, time.perf_counter() - t0, float(s.last_state.epstol[0]), s.cg_rtol * b0[0]))
    (g, dg, tg, epstol, bound), (c, dc, tc, _, _) = runs
    keys = ("nfact", "ncg", "nlinsolve", "neval_residual")
    cg = (g.status, g.iter, *(g.solver_specific[k] for k in keys))
    cc = (c.status, c.iter, *(c.solver_specific[k] for k in keys))
    dx = float(np.abs(g.solution - c.solution).max())
    _log(f"  fit {FIT_PARITY[0]}x{FIT_PARITY[1]} f64 (status, iter, nfact, ncg, nlinsolve, neval_residual): "
         f"card {cg} in {tg:.3f} s, CPU {cc} in {tc:.3f} s, max |x_gpu - x_cpu| {dx:.3e}; ||grad L|| after "
         f"step 1: card {dg[1]:.4e}, CPU {dc[1]:.4e}, epstol {epstol:.4e}, CG bound {bound:.4e}")
    if g.status != c.status or g.status not in ("first_order", "small_residual"):
        raise AssertionError(f"fit card vs CPU: {cg} vs {cc}")
    if g.iter == c.iter:
        ok = (cg[2] == cc[2] and cg[4:] == cc[4:] and abs(cg[3] - cc[3]) <= FIT_PARITY_NCG
              and dx <= FIT_PARITY_DX)
    else:
        ok = epstol < bound and all(d[1] <= bound and st.iter == (1 if d[1] <= epstol else 2)
                                    for st, d in ((g, dg), (c, dc)))
        _log("  the iteration counts part at the named knife edge (phase_fit_parity's docstring)")
    if not ok:
        raise AssertionError(f"fit card vs CPU: {cg} vs {cc}, dx {dx}")
    out = {"fit": dict(card=cg, cpu=cc, dx=dx, card_s=tg, cpu_s=tc, dual1_card=dg[1], dual1_cpu=dc[1],
                       epstol=epstol, cg_bound=bound)}

    pb = nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                     lambda x: (x.sum() - 1).reshape(1), [0.0], [0.0], device=dev)
    via = {}
    for b in ("ldlt", "cpp"):
        t0 = time.perf_counter()
        st = CaNNOLeSSolver(pb, linsolve=b).solve()
        via[b] = (st, time.perf_counter() - t0)
    (a, ta), (b, tb) = via["ldlt"], via["cpp"]
    dxc = float(np.abs(a.solution - b.solution).max())
    _log(f"  dense solve on the card: ldlt {a.status} iter {a.iter} nfact {a.solver_specific['nfact']} in "
         f"{ta:.3f} s, cpp {b.status} iter {b.iter} nfact {b.solver_specific['nfact']} in {tb:.3f} s, "
         f"max |dx| {dxc:.3e}")
    if (a.status, a.iter, a.solver_specific["nfact"]) != (b.status, b.iter, b.solver_specific["nfact"]) or \
            dxc > 1e-12:
        raise AssertionError("linsolve='cpp' on the card differs from 'ldlt'")
    out["cpp_vs_ldlt"] = dict(iter=b.iter, nfact=b.solver_specific["nfact"], dx=dxc, ldlt_s=ta, cpp_s=tb)
    return out


EXAMPLES = ("torch_01_basics.py", "torch_02_batched_sweep.py", "torch_04_bundle_adjustment.py")
EXAMPLE_TIMEOUT = 900.0


def start_examples():
    """Phase 18's examples, each in a process of its own on the card, all
    started at once (one intra-op thread each: the pool's workers share
    the host's cores); returns {name: (process, output file)} and the
    times at which each exits, filled in as they do."""
    import tempfile
    import threading

    here = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    runs, ends = {}, {}
    t0 = time.perf_counter()
    for name in EXAMPLES:
        out = tempfile.TemporaryFile("w+")
        p = subprocess.Popen([sys.executable, str(here / "examples" / name)], cwd=here, env=env,
                             stdout=out, stderr=subprocess.STDOUT, text=True)
        threading.Thread(target=lambda p=p, name=name: (p.wait(), ends.__setitem__(name, time.perf_counter() - t0)),
                         daemon=True).start()
        runs[name] = (p, out)
    return runs, ends


def phase_examples(runs, ends):
    """Phase 18: every example must exit 0; prints their output."""
    out = {}
    for name, (p, f) in runs.items():
        p.wait(timeout=EXAMPLE_TIMEOUT)
        time.sleep(0.1)  # the waiting thread records the exit time
        f.seek(0)
        text = f.read()
        f.close()
        _log(f"  {name}: exit {p.returncode} after {ends.get(name, float('nan')):.1f} s")
        for line in text.splitlines()[-40:]:
            _log(f"    {line}")
        if p.returncode != 0:
            raise AssertionError(f"example {name} exited {p.returncode}")
        out[name] = dict(exit=p.returncode, wall_s=ends.get(name))
    return out


# Phase 19: the multi-device layer with k ranks (gloo) sharing this one card.
# The walls are of k processes on one card and one host: they check the
# sharded program and say nothing of scaling.  BASELINE config 4 is
# benchmarks/bench_large.py's problem (its numpy draw at seed 0, m = 10,240,
# n = 1,024, float32, Gauss–Newton, condensed, chol, block_size=128,
# max_iter=30); config 5 is benchmarks/scaling.py's family and draw (the
# bench family, float32) at B = 102,400.
SHARD_CFG4 = (10_240, 1024)
SHARD_RANKS = (1, 2, 4)
SHARD_CFG5_B = 102_400
# benchmarks/scaling.py's default batch, for the scaling_bench rows
SHARD_SCALING_B = 4096
SHARD_FIT64_M = 8192
# Bars, about ten times the first H100 reading (NVIDIA H100 80GB HBM3,
# 700 W).  Config 4 (float32): max |x − x_unsharded| of solve_row_sharded
# and of the row-sharded MatrixFreeSolver: the sums over row blocks only
# reorder float32 additions (JᵀJ has κ ≈ 4); read 2.4e-7 (one ulp of |x| in
# [2, 4)) at k = 2 and 4 for both, 0 at k = 1 (every collective the
# identity).
SHARD_DX_BAR = 2.5e-6
SHARD_MF_DX_BAR = 2.5e-6
# config 5: on lanes whose status agrees, |x − x_k=1| (float32); read 0,
# every lane bit-equal (each lane's arithmetic does not depend on the
# batch's size); 1e-6 leaves room for another cuBLAS algorithm at another
# batch size.
SHARD_CFG5_DX_BAR = 1e-6
# config-5 lanes whose status may differ between k = 4 and k = 1: none named
SHARD_CFG5_NAMED: dict = {}
# float64 card vs CPU at k = 4 (as phase 6): x within 1e-10
SHARD_FIT64_DX_BAR = 1e-10


def _rank_sync(dev, group=None):
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group=group)


def _shard_counters(st):
    ss = st.solver_specific
    return (st.status, st.iter, ss["nfact"], ss["nlinsolve"], ss["nbk"])


def _rank_cfg4(pb, mesh):
    """Config 4 on this rank's rows of ``mesh`` at both seams, twice each
    (the second solve is the warm one): counters, x, the warm wall, peak
    device memory and the Cholesky kernel's launches of the warm solve."""
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.parallel.schur import solve_row_sharded

    dev = mesh.device
    out = {}
    for seam, pcm in (("kernel", 0), ("default", None)):
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", block_size=128,
                           pallas_chol_min=pcm, mesh=mesh)
        for _ in range(2):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            f0 = _count("chol_fused")
            _rank_sync(dev, mesh.group)
            t0 = time.perf_counter()
            st = solve_row_sharded(pb, mesh, solver=s, max_iter=30)
            _rank_sync(dev, mesh.group)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else float("nan")
        out[seam] = dict(counters=_shard_counters(st), x=st.solution, wall_s=wall, launches=_count("chol_fused") - f0,
                         peak_gb=peak)
    return out


def _rank_fit64(device):
    """The 8,192-row curve fit in float64, row-sharded over every rank."""
    from cannoles_tpu_torch.models.families import curve_fit_family
    from cannoles_tpu_torch.parallel.mesh import make_row_mesh
    from cannoles_tpu_torch.parallel.schur import solve_row_sharded

    mesh = make_row_mesh(device=device)
    st = solve_row_sharded(curve_fit_family(SHARD_FIT64_M, dtype=torch.float64, device=mesh.device), mesh)
    return dict(counters=_shard_counters(st), x=st.solution)


def rank_phase19(m, n, B5, device=None):
    """Phase 19's program on one of the ranks (``device``: None for the
    card): config 4 over the first k ranks for each k of SHARD_RANKS (the
    others wait), the row-sharded MatrixFreeSolver on config 4, config 5
    (B5 lanes) through ``vsolve(mesh=...)`` with its statistics, the
    scaling rows, and the float64 fit with its rows on this device and on
    the CPU (gloo reduces CPU tensors over the same group)."""
    import torch.distributed as dist

    from cannoles_tpu_torch import MatrixFreeSolver, vsolve
    from cannoles_tpu_torch.models.families import large_rung_problem, lm_bench_batch, lm_bench_family
    from cannoles_tpu_torch.parallel.mesh import make_batch_mesh, make_row_mesh
    from cannoles_tpu_torch.parallel.multihost import batch_convergence_stats, scaling_bench

    world = make_row_mesh(device=device)
    dev = world.device
    pb, _, _ = large_rung_problem(m, n, dtype=torch.float32, device=dev)
    out = {"cfg4": {}}
    for k in SHARD_RANKS:
        group = dist.new_group(list(range(k)))  # collective: every rank makes it
        if world.rank < k:
            out["cfg4"][k] = _rank_cfg4(pb, make_row_mesh(group, device=device))
        _rank_sync(dev)

    t0 = time.perf_counter()
    st = MatrixFreeSolver(pb, mesh=world).solve(max_iter=30, max_time=600.0)
    _rank_sync(dev)
    out["matfree"] = dict(counters=_shard_counters(st), ncg=st.solver_specific["ncg"], x=st.solution,
                          wall_s=time.perf_counter() - t0)
    del pb

    mesh = make_batch_mesh(device=device)
    fam = lm_bench_family(torch.float32, dev)
    x0, d = lm_bench_batch(B5, seed=0)
    f0 = _count("fused_ldlt")
    _rank_sync(dev)
    t0 = time.perf_counter()
    res = vsolve(fam, x0, data_batch=d, mesh=mesh, max_iter=50)
    _rank_sync(dev)
    wall = time.perf_counter() - t0
    launches = _count("fused_ldlt") - f0
    first = mesh.rank == 0  # the result is the same on every rank: one copy comes back
    out["cfg5"] = dict(wall_s=wall, launches=launches, stats=batch_convergence_stats(res.states, mesh),
                       linsolve=res.solver.linsolve, kkt=res.solver.kkt,
                       status=res.status if first else None, x=res.solution if first else None,
                       iters=res.iterations if first else None)
    out["scaling"] = scaling_bench(fam, x0[:SHARD_SCALING_B], d[:SHARD_SCALING_B], device_counts=[1, 2, 4],
                                   reps=1, device=device)
    out["fit64"] = {where: _rank_fit64(where) for where in (device, "cpu")}
    return out


def _unsharded_cfg4(pb, pcm):
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.core.solver import _add_batch_axis
    from cannoles_tpu_torch.core.status import status_name

    s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", block_size=128,
                       pallas_chol_min=pcm)
    st = s.run(pb.x0[None], pb.y0[None], s.make_config(max_iter=30), _add_batch_axis(pb.data, pb.x0.device))
    counters = (status_name(int(st.status[0])), int(st.iter[0]), int(st.nfact[0]), int(st.nlinsolve[0]),
                int(st.nbk[0]))
    return counters, st.x[0].cpu().numpy()


def phase_sharded(dev, m=SHARD_CFG4[0], n=SHARD_CFG4[1], B5=SHARD_CFG5_B):
    """Phase 19: the sharded paths with gloo ranks sharing the card, each
    against the port's one-process run (see SHARD_*), in one launch of
    max(SHARD_RANKS) ranks.  ``dev`` may be the CPU, at smaller sizes, to
    rehearse the phase."""
    from cannoles_tpu_torch import MatrixFreeSolver, vsolve
    from cannoles_tpu_torch.models.families import large_rung_problem, lm_bench_batch, lm_bench_family
    from cannoles_tpu_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    pb, x_true, _ = large_rung_problem(m, n, dtype=torch.float32, device=dev)
    ref = {seam: _unsharded_cfg4(pb, pcm) for seam, pcm in (("kernel", 0), ("default", None))}
    t0 = time.perf_counter()
    mf = MatrixFreeSolver(pb).solve(max_iter=30, max_time=600.0)
    mf_wall = time.perf_counter() - t0
    mf_ref = (_shard_counters(mf), mf.solver_specific["ncg"], mf.solution)
    del pb
    fam = lm_bench_family(torch.float32, dev)
    x0, d = lm_bench_batch(B5, seed=0)
    t0 = time.perf_counter()
    one = vsolve(fam, x0, data_batch=d, max_iter=50)
    if on_card:
        torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    for seam, (c, x) in ref.items():
        _log(f"  config 4 {m}x{n} unsharded ({seam} seam): {c}, max |x - x_true| "
             f"{np.abs(x - x_true).max():.3e}")
    _log(f"  config 4 MatrixFreeSolver unsharded: {mf_ref[0]}, ncg {mf_ref[1]}, wall {mf_wall:.3f} s")
    _log(f"  config 5 B={B5} k=1 (mesh=None): {one.summary()}, wall {one_wall:.3f} s")

    k = SHARD_RANKS[-1]
    t0 = time.perf_counter()
    ranks = launch(rank_phase19, k, m, n, B5, None if on_card else "cpu")
    _log(f"  launch of {k} ranks on {dev.type}: {time.perf_counter() - t0:.1f} s")

    bad, out = [], {"cfg4": {}, "launches_cfg4_per_rank": {}}
    for kk in SHARD_RANKS:
        members = [r["cfg4"][kk] for r in ranks[:kk]]
        for seam in ("kernel", "default"):
            c_ref, x_ref = ref[seam]
            r0 = members[0][seam]
            dx = float(np.abs(r0["x"] - x_ref).max())
            err = float(np.abs(r0["x"] - x_true).max())
            launches = [r[seam]["launches"] for r in members]
            walls = [r[seam]["wall_s"] for r in members]
            peaks = [r[seam]["peak_gb"] for r in members]
            same = all(np.array_equal(r[seam]["x"], r0["x"]) and r[seam]["counters"] == r0["counters"]
                       for r in members)
            _log(f"  config 4 k={kk} ({seam} seam): {r0['counters']}, max |x - x_unsharded| {dx:.3e}, "
                 f"max |x - x_true| {err:.3e}, warm wall {max(walls):.4f} s (per rank "
                 f"{[round(w, 4) for w in walls]}), peak device memory per rank "
                 f"{[round(p, 3) for p in peaks]} GB, Cholesky kernel launches per rank {launches}, "
                 f"ranks bit-equal {same}")
            out["cfg4"][f"k={kk} {seam}"] = dict(counters=r0["counters"], dx=dx, err=err, wall_s=max(walls),
                                                 peak_gb=peaks, launches=launches)
            if seam == "kernel":
                out["launches_cfg4_per_rank"][f"k={kk}"] = launches
            if r0["counters"][:4] != c_ref[:4] or not dx <= SHARD_DX_BAR or not err <= 1e-3 or not same:
                bad.append(f"config 4 k={kk} {seam}")
            if min(launches) <= 0 if seam == "kernel" else max(launches) > 0:
                bad.append(f"config 4 k={kk} {seam}: launches {launches}")

    r0 = ranks[0]
    mf_k = r0["matfree"]
    mdx = float(np.abs(mf_k["x"] - mf_ref[2]).max())
    mf_same = all(np.array_equal(r["matfree"]["x"], mf_k["x"]) for r in ranks)
    _log(f"  config 4 MatrixFreeSolver k={k}: {mf_k['counters']}, ncg {mf_k['ncg']} (unsharded {mf_ref[1]}), "
         f"max |x - x_unsharded| {mdx:.3e}, wall {mf_k['wall_s']:.3f} s, ranks bit-equal {mf_same}")
    out["matfree"] = dict(counters=mf_k["counters"], ncg=mf_k["ncg"], ncg_unsharded=mf_ref[1], dx=mdx,
                          wall_s=mf_k["wall_s"], wall_unsharded_s=mf_wall)
    if (mf_k["counters"][:3] != mf_ref[0][:3] or abs(mf_k["ncg"] - mf_ref[1]) > max(2, 0.02 * mf_ref[1])
            or not mdx <= SHARD_MF_DX_BAR or not mf_same):
        bad.append(f"matfree k={k}")

    c5 = r0["cfg5"]
    st1, stk = one.status, c5["status"]
    differ = np.nonzero(st1 != stk)[0]
    unnamed = [int(i) for i in differ if int(i) not in SHARD_CFG5_NAMED]
    eq = st1 == stk
    cdx = float(np.abs(c5["x"][eq] - one.solution[eq]).max())
    same_iters = int((c5["iters"] == one.iterations).sum())
    solved = (stk == 1) | (stk == 2)
    own = dict(solved=int(solved.sum()), n=int(stk.shape[0]), total_iters=int(c5["iters"].sum()))
    stats_ok = all({q: r["cfg5"]["stats"][q] for q in own} == own for r in ranks)
    c5_launches = [r["cfg5"]["launches"] for r in ranks]
    _log(f"  config 5 B={B5} k={k} (vsolve(mesh=), linsolve={c5['linsolve']}, kkt={c5['kkt']}): "
         f"stats {c5['stats']}, statuses differing from k=1 {differ.size} (unnamed {unnamed[:10]}), "
         f"iterations equal on {same_iters}/{stk.shape[0]} lanes, max |x - x_k=1| on equal statuses {cdx:.3e}, "
         f"batch_convergence_stats equal to the result's own counts on every rank {stats_ok}, wall "
         f"{max(r['cfg5']['wall_s'] for r in ranks):.3f} s, LDLT kernel launches per rank {c5_launches}")
    out["cfg5"] = dict(stats=c5["stats"], differ=int(differ.size), dx=cdx, wall_s=max(r["cfg5"]["wall_s"]
                       for r in ranks), wall_k1_s=one_wall, launches=c5_launches)
    if unnamed or not cdx <= SHARD_CFG5_DX_BAR or not stats_ok or min(c5_launches) <= 0:
        bad.append(f"config 5 k={k}")

    out["scaling"] = [dict(row, mesh="one_card_shared") for row in r0["scaling"]]
    for row in out["scaling"]:
        _log(f"  scaling_bench B={SHARD_SCALING_B} devices={row['devices']} throughput {row['throughput']:.1f}/s "
             f"time {row['time']:.4f} s speedup {row['speedup']:.3f} efficiency {row['efficiency']:.3f} "
             f"[one_card_shared: ranks share one card, not scaling]")

    (g, c) = (r0["fit64"][w] for w in (None if on_card else "cpu", "cpu"))
    fdx = float(np.abs(g["x"] - c["x"]).max())
    f_same = all(np.array_equal(r["fit64"][w]["x"], r0["fit64"][w]["x"]) for r in ranks for w in r["fit64"])
    _log(f"  curve fit {SHARD_FIT64_M} rows float64 k={k}: {dev.type} {g['counters']}, CPU {c['counters']}, "
         f"max |x_{dev.type} - x_cpu| {fdx:.3e}, ranks bit-equal {f_same}")
    out["fit64"] = dict(card=g["counters"], cpu=c["counters"], dx=fdx)
    if g["counters"] != c["counters"] or not fdx <= SHARD_FIT64_DX_BAR or not f_same:
        bad.append(f"float64 fit {dev.type} vs CPU")
    out["wall_s"] = time.perf_counter() - t_phase
    _log(f"  phase 19 took {out['wall_s']:.1f} s")
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))
    return out


# Phase 22: the entry points that a user (and the benchmark) calls, each
# through its Python entry function, after phase 19 and alone on the card.
# The ranks they spawn share the card (gloo): their walls check the sharded
# programs, not scaling.  perf_profile runs its six problems in six
# spawned processes from the phase's start (three of its runs spend the
# runner's 30 s budget), beside the rest of the phase.
ENTRY_DRYRUN_RANKS = 4  # nb = 2, nr = 2 on the dry run's 2-D axis
ENTRY_SHARD = 2
ENTRY_SCALING = (4096, 2)  # B, ranks
ENTRY_CHOL_REL_ERR = 1e-4
ENTRY_LARGE_ERR = 1e-3
# one process per problem, the longest first, so that the budget-bound
# runs overlap with each other and with the rest of the phase
ENTRY_PROFILE_GROUPS = ({"jennrich_sampson"}, {"hs27"}, {"gulf_10"}, {"hs61"}, {"beale+linear"}, {"rosenbrock"})
# (problem, configuration) whose solved flag on the card may differ from
# JAX's CPU record (benchmarks/results_perf_profile_cpu.json), with why
ENTRY_PROFILE_NAMED = {
    ("hs27", "newton/full"): "the default configuration thrashes δ at its floor √eps; the CPU (JAX's "
                             "record, max_eval) and the card part within the first iterations "
                             "(BATTERY_STATUS), and the card may reach a first-order point",
}


def _check_profile(runs):
    """Per problem and configuration, solved against JAX's CPU record."""
    record = json.loads((pathlib.Path(__file__).resolve().parent / "benchmarks"
                         / "results_perf_profile_cpu.json").read_text())
    rows, bad = {}, []
    for run in runs:
        if run["errors"]:
            bad.append(f"perf_profile errors {run['errors'][:3]}")
        for part in ("unconstrained", "constrained"):
            got, rec = run[part], record[part]
            for i, name in enumerate(got["problems"]):
                k = rec["problems"].index(name)
                p = run["problems"].index(name)
                solved = np.isfinite(got["time_costs"][i]).tolist()
                want = np.isfinite(rec["time_costs"][k]).tolist()
                rows[name] = dict(solved=solved, record=want, statuses=run["statuses"][p],
                                  walls=run["walls"][p], neval=got["eval_costs"][i][:4])
                for j, col in enumerate(got["configs"]):
                    if solved[j] != want[j]:
                        named = ENTRY_PROFILE_NAMED.get((name, col))
                        _log(f"  perf_profile {name} {col}: solved {solved[j]} on the card, {want[j]} in "
                             f"JAX's CPU record" + (f" (named: {named})" if named else " (unnamed)"))
                        if not named:
                            bad.append(f"perf_profile {name} {col}")
    return rows, bad


def _chol_row(r):
    """A bench_chol row for the kernels line."""
    return {k: r[k] for k in ("N", "kernel_ms", "cholesky_ms", "plain_ms", "bound_ms", "bound_by",
                              "share_of_bound", "rel_err", "launches_fused", "launches_block")}


def phase_entry_points(dev, large=(10_240, 1024), scaling_B=ENTRY_SCALING[0], chol_sizes=None):
    """Phase 22: ``dryrun_multichip``, ``bench_large`` (alone and
    ``--shard``), ``scaling``, ``bench_chol``, ``perf_profile`` on six
    problems and ``mgh_battery --constrained --linsolve auto`` on the card.
    ``dev`` may be the CPU, at smaller sizes, to rehearse the phase (it then
    fails only on the kernel launch gate)."""
    import functools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from cannoles_tpu_torch import bench_chol, bench_large, mgh_battery, perf_profile, scaling
    from cannoles_tpu_torch.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    device = None if dev.type == "cuda" else "cpu"  # the entry points' own default is the card
    out, bad, walls = {}, [], {}
    pool = ProcessPoolExecutor(len(ENTRY_PROFILE_GROUPS), mp_context=multiprocessing.get_context("spawn"))
    try:
        group = functools.partial(perf_profile.run, dtype=torch.float64, device=dev.type, log=None)
        profile = [pool.submit(group, g) for g in ENTRY_PROFILE_GROUPS]

        t0 = time.perf_counter()
        dr = dryrun_multichip(ENTRY_DRYRUN_RANKS, device)
        walls["dryrun"] = time.perf_counter() - t0
        out["dryrun"] = dict(rows_status=dr["rows"]["status"], solved_2d=dr["2d"]["solved"],
                             mesh_2d=(dr["2d"]["nb"], dr["2d"]["nr"]), solved_dp=dr["dp"]["solved"])
        _log(f"  dryrun_multichip({ENTRY_DRYRUN_RANKS}) on {ENTRY_DRYRUN_RANKS} gloo ranks sharing the card: "
             f"{out['dryrun']}, {walls['dryrun']:.1f} s")

        t0 = time.perf_counter()
        one = bench_large.run(*large, device=device)
        sh = bench_large.run_sharded(ENTRY_SHARD, *large, device=device)
        walls["bench_large"] = time.perf_counter() - t0
        for r in (one, sh):
            _log(f"  bench_large: {bench_large._line(r)}")
        out["bench_large"] = {k: {q: v for q, v in r.items() if q != "x"} for k, r in (("one", one), ("shard", sh))}
        if one["status"] != "first_order" or not one["err"] <= ENTRY_LARGE_ERR or not sh["err"] <= ENTRY_LARGE_ERR:
            bad.append("bench_large status or error")
        if (sh["status"], sh["iter"], sh["nfact"]) != (one["status"], one["iter"], one["nfact"]):
            bad.append(f"bench_large --shard {ENTRY_SHARD}: {sh['iter']}/{sh['nfact']} against {one['iter']}/"
                       f"{one['nfact']}")

        t0 = time.perf_counter()
        rows = scaling.run(scaling_B, ENTRY_SCALING[1], device)
        walls["scaling"] = time.perf_counter() - t0
        for r in rows:
            _log(f"  scaling B={scaling_B} devices={r['devices']} throughput {r['throughput']:.1f}/s "
                 f"time {r['time']:.4f} s speedup {r['speedup']:.3f} efficiency {r['efficiency']:.3f} [{r['mesh']}]")
        out["scaling"] = rows
        kind = "one_card_shared" if device is None else "virtual_cpu_shared_core"
        if [r["devices"] for r in rows] != [1, 2] or any(r["mesh"] != kind for r in rows):
            bad.append("scaling rows")

        t0 = time.perf_counter()
        c0 = _count("chol_fused"), _count("chol_block")
        chol = bench_chol.run(chol_sizes or bench_chol.SIZES, dev, log=lambda s: _log(f"  bench_chol {s}"))
        launches = (_count("chol_fused") - c0[0], _count("chol_block") - c0[1])
        walls["bench_chol"] = time.perf_counter() - t0
        out["bench_chol"] = dict(rows=chol, launches=launches)
        _log(f"  bench_chol launches (fused, block) {launches}")
        if (launches[0] <= 0 or launches[1] <= 0 or any(not r["ok"] or not r["rel_err"] <= ENTRY_CHOL_REL_ERR
                                                         for r in chol)):
            bad.append("bench_chol")

        t0 = time.perf_counter()
        mrows, msum = mgh_battery.run(constrained=True, linsolve="auto", device=dev.type, log=None)
        walls["mgh_battery"] = time.perf_counter() - t0
        _log(f"  mgh_battery --constrained --linsolve auto: {msum}, slowest row "
             f"{max(mrows, key=lambda r: r['time'])['name']} {max(r['time'] for r in mrows):.2f} s")
        out["mgh_battery"] = dict(summary=msum, rows=[(r["name"], r["status"], r["iter"]) for r in mrows])
        if msum["solved"] != 14 or msum["n"] != 14:
            bad.append("mgh_battery --constrained")

        t0 = time.perf_counter()
        runs = [f.result() for f in profile]
        walls["perf_profile_wait"] = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    prows, pbad = _check_profile(runs)
    bad += pbad
    for name, r in prows.items():
        _log(f"  perf_profile {name}: solved {r['solved']} (record {r['record']}), statuses {r['statuses']}, "
             f"walls {[round(w, 3) for w in r['walls']]} s, neval {r['neval']}")
    out["perf_profile"] = prows
    out["walls_s"] = walls
    out["wall_s"] = time.perf_counter() - t_phase
    _log(f"  phase 22 took {out['wall_s']:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    if bad:
        raise AssertionError("phase 22: " + "; ".join(bad))
    return out


# Phase 20: matmul_precision on the card.  Every mode, and bench.py's own
# bf16 commit setting (bench.py:326-329: quality_gate off, default seam).
PREC_MODES = (None, "highest", "float32", "bfloat16", "tensorfloat32")
PREC_IEEE = (None, "highest", "float32")
# the large rung's bar on max |x − x_true| in every mode (PERF.md §2)
PREC_LARGE_BAR = 1e-3
# substrings of the names the profiler gives cuBLAS's GEMM kernels on the card
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def _gemm_ms(events):
    """Device ms of the GEMM kernels among profiler events."""
    return sum(e.time_range.elapsed_us() for e in events
               if any(k in e.name.lower() for k in GEMM_NAMES)) / 1e3


def prec_large_rung(dev):
    """Phase 20's large rung (``bench.py``'s 8192×1024, float32, GN,
    condensed, ``chol``, ``max_iter=30``) under each mode at the default
    seam, in bench.py's bf16 commit setting, and under 'bfloat16' at the
    kernel seam: a first solve, three warm ones (host wall with a
    synchronize before each clock read, and the CUDA-event span), one under
    ``torch.profiler`` (GEMM device time, busy time, top kernels).  Every
    solve ``first_order`` with max |x − x_true| ≤ ``PREC_LARGE_BAR``."""
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.families import large_rung_problem

    pb, x_true, _ = large_rung_problem(dtype=torch.float32, device=dev)
    xt = torch.as_tensor(x_true, device=dev, dtype=torch.float64)
    runs = [(f"mode {mp}", dict(matmul_precision=mp, block_size=256)) for mp in PREC_MODES]
    runs += [("bfloat16, quality_gate=False (bench.py)", dict(matmul_precision="bfloat16", quality_gate=False)),
             ("bfloat16, kernel seam", dict(matmul_precision="bfloat16", block_size=256, pallas_chol_min=0))]
    out = {}
    for label, kw in runs:
        s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol",
                           dtype=torch.float32, device=dev, **kw)
        kernel_seam = kw.get("pallas_chol_min") == 0
        l0 = _count("chol_fused")

        def solve():
            st = s.solve(max_iter=30, max_time=600.0)
            err = float((torch.as_tensor(st.solution, device=dev, dtype=torch.float64) - xt).abs().max())
            if st.status != "first_order" or not err <= PREC_LARGE_BAR:
                raise AssertionError(f"large rung, {label}: {st.status}, max |x - x_true| {err}")
            return st, err

        solve()
        walls, spans = [], []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            st, err = solve()
            b.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            spans.append(a.elapsed_time(b))
        _, _, events = _profile_device(solve, f"large rung, {label}")
        by_name = {}
        for e in events or ():
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        launches = _count("chol_fused") - l0
        if (launches > 0) != kernel_seam:
            raise AssertionError(f"large rung, {label}: {launches} fused Cholesky kernel launches")
        ss = st.solver_specific
        row = dict(status=st.status, iter=st.iter, nfact=ss["nfact"], nlinsolve=ss["nlinsolve"], err=err,
                   warm_walls_s=walls, event_ms=spans, gemm_ms=None if events is None else _gemm_ms(events),
                   busy_ms=None if events is None else 1e3 * _busy_s([(e.time_range.start, e.time_range.end)
                                                                      for e in events]),
                   launches=launches, top_kernels_ms=None if events is None else {k[:90]: v for k, v in top})
        _log(f"  large rung, {label}: {st.status}, iter {st.iter}, nfact {ss['nfact']}, "
             f"max |x - x_true| {err:.3e}, warm walls {', '.join(f'{w:.4f}' for w in walls)} s, "
             f"CUDA-event spans {', '.join(f'{t:.3f}' for t in spans)} ms, "
             + ("GEMM and busy time not measured" if events is None else
                f"GEMM {row['gemm_ms']:.3f} ms and busy {row['busy_ms']:.3f} ms of the profiled solve")
             + f", fused kernel launches {launches}")
        for kname, ms in top:
            _log(f"    {ms:.3f} ms  {kname[:100]}")
        out[label] = row
    return out


def prec_ba(dev):
    """Phase 20's BA rung (phase 5's 256 scenes, N = 73, ``pallas``) under
    each mode, and under 'bfloat16' with the quality gate off: solved count
    and the fused LDLᵀ kernel's launches; at least 99% solved under the IEEE
    modes, the counts of the others recorded."""
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import bundle_adjustment_batch

    pb, x0s, datas, x_true = bundle_adjustment_batch(256, 3, 16, dtype=torch.float32, device=dev)
    B = x0s.shape[0]
    runs = [(f"mode {mp}", dict(matmul_precision=mp)) for mp in PREC_MODES]
    runs.append(("bfloat16, quality_gate=False", dict(matmul_precision="bfloat16", quality_gate=False)))
    out = {}
    for label, kw in runs:
        solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas",
                                dtype=torch.float32, device=dev, **kw)
        l0 = _count("fused_ldlt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count("fused_ldlt") - l0
        summ = res.summary()
        ok = res.solved_mask()
        err = float(np.abs(res.solution[ok] - x_true[ok]).max()) if ok.any() else float("nan")
        _log(f"  BA rung, {label}: solved {summ['solved']}/{B}, mean_iter {summ['mean_iter']:.3f}, "
             f"max |x - x_true| on solved lanes {err:.3e}, wall {wall:.3f} s, LDLT kernel launches {launches}")
        if launches <= 0:
            raise AssertionError(f"BA rung, {label}: the fused LDLT kernel was not launched")
        if kw["matmul_precision"] in PREC_IEEE and summ["solved"] < 0.99 * B:
            raise AssertionError(f"BA rung, {label}: solved {summ['solved']}/{B} < 99%")
        out[label] = dict(solved=summ["solved"], B=B, mean_iter=summ["mean_iter"], err=err, wall_s=wall,
                          launches=launches)
    return out


def prec_route(dev):
    """The card's one-pass bf16 product (``critical_matmul(a, b,
    'bfloat16')``) against its plain version ``bf16_pass_reference`` at the
    JᵀJ shapes of the large rung and the BA rung.  Both compute exact
    products of the same bf16 operands and sum them in float32 in another
    order, so each entry may differ by at most 2·K·u·(|a|·|b|) (K the inner
    dimension, u = 2⁻²⁴: the worst case of both sums).  Times (CUDA events)
    of the route, the plain version, and the IEEE and TF32 float32 GEMMs."""
    from cannoles_tpu_torch.core.solver import _add_batch_axis
    from cannoles_tpu_torch.models.families import bundle_adjustment_batch, large_rung_problem
    from cannoles_tpu_torch.utils.precision import bf16_pass_reference, critical_matmul, matmul_mode

    pb, _, _ = large_rung_problem(dtype=torch.float32, device=dev)
    JL = pb.Jt(pb.x0[None], _add_batch_axis(pb.data, dev))
    pbb, x0s, datas, _ = bundle_adjustment_batch(256, 3, 16, dtype=torch.float32, device=dev)
    JB = pbb.Jt(x0s, datas)
    out = {}
    for name, a in (("large rung JtJ", JL), ("BA rung JtJ", JB)):
        b = a.mT
        B, n, K = a.shape
        got = critical_matmul(a, b, "bfloat16")
        ref = bf16_pass_reference(a, b)
        with matmul_mode("highest"):
            bound = 2 * K * 2.0**-24 * (a.bfloat16().float().abs() @ b.bfloat16().float().abs())
            ieee = a @ b
        if got.dtype != torch.float32 or got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"bf16 route, {name}: {got.dtype} {tuple(got.shape)}")
        over = int(((got - ref).abs() > bound).sum())
        rel, err = _rel(got, ref)
        rel_ieee, _ = _rel(got, ieee)
        route_ms = _events_ms(lambda: critical_matmul(a, b, "bfloat16"))
        plain_ms = _events_ms(lambda: bf16_pass_reference(a, b))
        with matmul_mode("highest"):
            ieee_ms = _events_ms(lambda: a @ b)
        with matmul_mode("tensorfloat32"):
            tf32_ms = _events_ms(lambda: a @ b)
        # JᵀJ reads J once (float32) and writes the float32 result
        bound_ms, by = _bound(4 * B * n * (K + n), 2 * B * n * n * K, torch.bfloat16)
        _log(f"  bf16 route, {name} {tuple(a.shape)}x{tuple(b.shape)}: entries over 2Ku(|a||b|) {over}, "
             f"max |route - plain| {err:.3e} ({rel:.3e} of the lane's max |plain|), against the IEEE "
             f"product {rel_ieee:.3e}; route {route_ms:.4f} ms, plain {plain_ms:.4f} ms, IEEE f32 GEMM "
             f"{ieee_ms:.4f} ms, TF32 GEMM {tf32_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
        if over:
            raise AssertionError(f"bf16 route, {name}: {over} entries outside 2Ku(|a||b|) of the plain version")
        out[name] = dict(shape=list(a.shape), over=over, max_abs_err=err, rel_err=rel, rel_vs_ieee=rel_ieee,
                         route_ms=route_ms, plain_ms=plain_ms, ieee_ms=ieee_ms, tf32_ms=tf32_ms,
                         bound_ms=bound_ms, bound_by=by)
    return out


def prec_pinned(dev):
    """The sites that the JAX package pins to 'highest', called inside a
    TF32 scope and inside an IEEE one, must give the same bits: the gate
    residual, one ``chol`` attempt at each seam (S = δI + ZᵀZ, the
    triangular and Cholesky solves, ``block_cho_solve``) on a condensed
    system n = 1024, p = 8, and one ``ldlt`` attempt (triangular solves and
    the refinement product) at N = 200; an unpinned product of the same
    operands must change, or TF32 was never on."""
    from cannoles_tpu_torch import CaNNOLeSSolver, nls_problem
    from cannoles_tpu_torch.utils.precision import matmul_mode
    from cannoles_tpu_torch.utils.testing import quasi_definite

    f32 = dict(dtype=torch.float32, device=dev)
    rng = np.random.default_rng(20)
    n, p = 1024, 8
    G = rng.normal(size=(n, n)) / np.sqrt(n)
    Jc = rng.normal(size=(p, n))
    K = np.block([[G @ G.T + np.eye(n), Jc.T], [Jc, -1e-2 * np.eye(p)]])[None]
    K, rhs = torch.as_tensor(K, **f32), torch.as_tensor(rng.normal(size=(1, n + p)), **f32)
    sol = torch.as_tensor(rng.normal(size=(1, n + p)), **f32)
    pb = nls_problem(lambda x: x, torch.zeros(n, **f32), n, lambda x: x[:p], np.zeros(p), np.zeros(p), device=dev)
    W2, r2, n1 = quasi_definite(1, 200, seed=20, skip=False)
    pb2 = nls_problem(lambda x: x, torch.zeros(n1, **f32), 200 - n1, device=dev)
    chol = {pcm: CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol",
                                matmul_precision="tensorfloat32", pallas_chol_min=pcm) for pcm in (None, 0)}
    ldlt = CaNNOLeSSolver(pb2, method="gauss_newton", linsolve="ldlt", matmul_precision="tensorfloat32")
    W2, r2 = torch.as_tensor(W2, **f32), torch.as_tensor(r2, **f32)
    sites = {
        "gate residual": lambda: (chol[None]._gate_residual(K, sol, rhs),),
        "chol attempt, default seam": lambda: chol[None]._attempt_raw(K, rhs),
        "chol attempt, kernel seam": lambda: chol[0]._attempt_raw(K, rhs),
        "ldlt attempt": lambda: ldlt._attempt_raw(W2, r2),
    }
    out = {}
    for name, fn in list(sites.items()) + [("unpinned product (control)", lambda: (K @ K,))]:
        with matmul_mode("tensorfloat32"):
            a = fn()
        with matmul_mode("highest"):
            b = fn()
        torch.cuda.synchronize()
        out[name] = all(torch.equal(x, y) for x, y in zip(a, b))
    _log(f"  pinned sites bit-equal under TF32: {out}")
    bad = [k for k in sites if not out[k]]
    if bad or out["unpinned product (control)"]:
        raise AssertionError(f"pinned sites: {bad} differ under TF32, control equal: "
                             f"{out['unpinned product (control)']}")
    return out


def phase_precision(dev):
    """Phase 20's checks after its paths: the route against its plain
    version, the pinned sites, and float64 card = CPU under the two reduced
    modes (phase 6's family and settings)."""
    out = dict(route=prec_route(dev), pinned=prec_pinned(dev))
    out["f64_parity"] = {mp: phase_parity(dev, mp) for mp in ("bfloat16", "tensorfloat32")}
    return out


# ---------------------------------------------------------------------------
# phase 21: the solver's graph route against its eager route
# ---------------------------------------------------------------------------
# the battery row whose host checks set the pool's wall before the graph
# route, and the outer iterations of its capped runs (the eager route here,
# and both packages under --against: about a minute at the parent's 8 ms per
# host check)
HOST_PATH_ROW = "biggs_exp6_24"
HOST_PATH_CAP = 100
# outer iterations of the profiled window behind the device operations per
# host check
HOST_PATH_PROFILED = 20


def _bits_differ(a, b):
    """The fields of two states (or batches of them) that are not equal bit
    for bit."""
    bad = []
    for f in a._fields[:-1]:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype.is_floating_point:
            it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(it), y.contiguous().view(it)
        if x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
            bad.append(f)
    return bad


def _force_route(solver, route):
    """Phase 21's switch: the same solver on the eager route (the rule's
    route otherwise)."""
    if route == "eager" and hasattr(solver, "route"):
        solver.route, solver.route_reason = "eager", "chip_smoke phase 21"
    return solver


def _host_ops(fn):
    """``fn``'s value, the device operations that the host launches (CUDA
    runtime launches, copies and graph launches) and the kernels the device
    runs, in one call of ``fn``, from ``torch.profiler`` (None, None where
    it does not trace the card)."""
    from torch.autograd import DeviceType

    out, ev, device = _profile_device(fn, "the capped solve")
    if ev is None:
        return out, None, None
    launches = sum(1 for e in ev if e.device_type != DeviceType.CUDA
                   and e.name.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset", "cudaGraphLaunch", "cuLaunch")))
    return out, launches, len(device)


def host_path_solve(dev, route, max_iter=-1, profiled=True):
    """``biggs_exp6_24`` float64 uniform (``linsolve='ldlt'``, the battery
    protocol) on ``route``: status, counters, host checks, the solve's clock
    (after the warm-up), ms per check and the wall; with ``profiled``, the
    device operations per check of a second solve capped at
    ``HOST_PATH_PROFILED`` outer iterations."""
    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.battery import collect

    make = next(it[2] for it in collect() if it[1] == HOST_PATH_ROW)
    pb = make(dtype=torch.float64, device=dev)
    s = _force_route(CaNNOLeSSolver(pb, linsolve="ldlt"), route)
    kw = dict(atol=0.0, rtol=1e-5, max_time=float("inf"), max_iter=max_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = s.solve(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(route=getattr(s, "route", "eager"), status=st.status, iter=st.iter,
               **{k: st.solver_specific[k] for k in ("nfact", "nlinsolve", "nbk")},
               host_syncs=s.host_syncs, solve_s=st.elapsed_time, wall_s=wall,
               ms_per_sync=1e3 * st.elapsed_time / max(1, s.host_syncs),
               graphs=len(s.graph_replays()) if hasattr(s, "graph_replays") else 0,
               replays=s.graph_replays() if hasattr(s, "graph_replays") else {})
    state = s.last_state
    if profiled:

        def capped():
            h0 = s.host_syncs
            s.solve(**{**kw, "max_iter": HOST_PATH_PROFILED})
            return max(1, s.host_syncs - h0)

        n, launches, kernels = _host_ops(capped)
        out.update(launches_per_sync=None if launches is None else launches / n,
                   kernels_per_sync=None if kernels is None else kernels / n)
    _log(f"  {HOST_PATH_ROW} f64 {out['route']}{' capped' if max_iter >= 0 else ''}: {_solve_summary(st)}, "
         f"host checks {out['host_syncs']}, solve {out['solve_s']:.3f} s ({out['ms_per_sync']:.4f} ms per "
         f"check), wall {wall:.3f} s, launches/kernels per check "
         f"{out.get('launches_per_sync') or float('nan'):.1f}/{out.get('kernels_per_sync') or float('nan'):.1f}, "
         f"graphs {out['graphs']}")
    return out, state


def headline_rescue(dev, route, reps=2):
    """Phase 4's headline (B = 65,536, float32, LM, full KKT, rescue) on
    ``route``: the rung's wall and the rescue's (the time inside
    ``_rescue_unsolved``), host checks, launches; the last rep's states."""
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family
    from cannoles_tpu_torch.parallel import batch as bt

    dtype = torch.float32
    pb = lm_bench_family(dtype, dev)
    solver = _force_route(CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full",
                                         dtype=dtype, device=dev), route)
    x0, d = lm_bench_batch(65536, seed=0)
    x0s = torch.as_tensor(x0, dtype=dtype, device=dev)
    datas = torch.as_tensor(d, dtype=dtype, device=dev)
    spent = [0.0]
    rescue = bt._rescue_unsolved

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return rescue(*a, **k)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

    runs = []
    bt._rescue_unsolved = timed
    try:
        for _ in range(reps):
            spent[0] = 0.0
            syncs0 = _all_syncs(solver)
            l0 = _count("fused_ldlt")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=50, chunk_size=16384,
                         max_eval=48, rescue=True)
            torch.cuda.synchronize()
            runs.append(dict(wall_s=time.perf_counter() - t0, rescue_s=spent[0],
                             host_syncs=_all_syncs(solver) - syncs0, launches=_count("fused_ldlt") - l0,
                             solved=int(res.summary()["solved"])))
    finally:
        bt._rescue_unsolved = rescue
    _log(f"  headline {getattr(solver, 'route', 'eager')}: " + "; ".join(
        f"wall {r['wall_s']:.3f} s (rescue {r['rescue_s']:.3f} s), checks {r['host_syncs']}, "
        f"launches {r['launches']}, solved {r['solved']}" for r in runs))
    return runs, res.states


def _all_syncs(solver):
    return solver.host_syncs + sum(s.host_syncs for s in solver.__dict__.get("_rescue_siblings", {}).values())


# phase 21's chol case: the exp-fit batch of the 2-D mesh's tests
# (``tests/torch_ranks.py`` ``exp_fit_batch``), B = 4, m = 32
HOST_PATH_CHOL = (4, 32)


def _exp_fit_batch(B, m, seed=0):
    rng = np.random.default_rng(seed)
    t = np.tile(np.linspace(0.0, 1.0, m), (B, 1))
    return t, (1.5 + 0.5 * rng.random(B))[:, None] * np.exp(-1.1 * t)


def host_path_chol(dev, dtype, route, pallas_chol_min=None):
    """The exp-fit batch through ``vsolve`` (Gauss–Newton, condensed,
    ``linsolve="chol"``) on ``route``: the solver and the states."""
    from cannoles_tpu_torch import CaNNOLeSSolver, nls_problem, vsolve

    B, m = HOST_PATH_CHOL
    t, y = _exp_fit_batch(B, m)
    own = {"t": torch.as_tensor(t[0], dtype=dtype, device=dev), "y": torch.as_tensor(y[0], dtype=dtype, device=dev)}
    pb = nls_problem(lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) - d["y"], [1.0, 0.0], m, data=own,
                     name="exp_fit", dtype=dtype, device=dev)
    s = _force_route(CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed",
                                    pallas_chol_min=pallas_chol_min), route)
    x0 = np.tile(pb.x0.cpu().numpy(), (B, 1))
    return s, vsolve(pb, x0, data_batch={"t": t, "y": y}, solver=s, max_iter=20).states


def phase_host_path_chol(dev):
    """Phase 21's chol case: the exp-fit batch at B = 4 in float32 and
    float64, at the default seam and through the Cholesky kernels
    (``pallas_chol_min=0``: the n = 2 block padded to 128), on both routes:
    the graph route captures and replays it, states equal bit for bit,
    statuses equal the CPU run's, every lane ``first_order``."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        for pcm in (None, 0):
            runs = {}
            for route in ("graph", "eager"):
                f0 = _count("chol_fused")
                s, st = host_path_chol(dev, dtype, route, pcm)
                torch.cuda.synchronize()
                runs[route] = (s, st, _count("chol_fused") - f0)
            (g, a, la), (_, b, lb) = runs["graph"], runs["eager"]
            _, c = host_path_chol(torch.device("cpu"), dtype, "eager", pcm)
            key = f"{str(dtype)[6:]} {'kernels' if pcm == 0 else 'cholesky'}"
            bad = _bits_differ(a, b)
            row = dict(route=g.route, replays=sum(g.graph_replays().values()), status=a.status.tolist(),
                       iter=a.iter.tolist(), cpu_status=c.status.tolist(), launches=(la, lb))
            _log(f"  chol B={HOST_PATH_CHOL[0]} {key}: {row}")
            if g.route != "graph" or not g.graph_replays().get("solve0") or bad:
                raise AssertionError(f"phase 21: chol {key}: graph route {g.route}, replays "
                                     f"{g.graph_replays()}, fields differing from the eager route {bad}")
            if a.status.tolist() != c.status.tolist() or set(c.status.tolist()) != {1}:
                raise AssertionError(f"phase 21: chol {key}: statuses {row['status']} against the CPU's "
                                     f"{row['cpu_status']}")
            if la != lb or (la > 0) != (pcm == 0):
                raise AssertionError(f"phase 21: chol {key}: Cholesky kernel launches {la} (graph) and {lb} "
                                     "(eager)")
            out[key] = row
    _log("  chol: the exp-fit batch bit-equal on both routes in both dtypes, statuses the CPU's")
    return out


def phase_host_path(dev):
    """Phase 21: ``biggs_exp6_24`` float64 uniform and the headline's
    rescue through the graph route and the eager route: bit-equal states;
    per route host checks, ms per check, device operations per check, walls;
    the graphs captured and their replays per segment."""
    from cannoles_tpu_torch.core import segments

    t21 = time.perf_counter()
    cap0 = segments.CAPTURE_SECONDS[0]
    full, _ = host_path_solve(dev, "graph")
    if full["status"] != "first_order":
        raise AssertionError(f"phase 21: {HOST_PATH_ROW} on the graph route ended {full['status']}")
    capped = {}
    states = {}
    for route in ("graph", "eager"):
        capped[route], states[route] = host_path_solve(dev, route, max_iter=HOST_PATH_CAP)
    bad = _bits_differ(states["graph"], states["eager"])
    keys = ("status", "iter", "nfact", "nlinsolve", "nbk", "host_syncs")
    if bad or any(capped["graph"][k] != capped["eager"][k] for k in keys):
        raise AssertionError(f"phase 21: {HOST_PATH_ROW} graph vs eager route differ: fields {bad}, "
                             f"{[(k, capped['graph'][k], capped['eager'][k]) for k in keys]}")
    _log(f"  {HOST_PATH_ROW}: graph and eager routes bit-equal over {HOST_PATH_CAP + 1} outer iterations; "
         f"ms per check {capped['graph']['ms_per_sync']:.4f} vs {capped['eager']['ms_per_sync']:.4f}")
    head, hstates = {}, {}
    for route in ("graph", "eager"):
        head[route], hstates[route] = headline_rescue(dev, route)
    bad = _bits_differ(hstates["graph"], hstates["eager"])
    if bad:
        raise AssertionError(f"phase 21: headline graph vs eager route differ in {bad}")
    _log("  headline: graph and eager routes bit-equal, rescue included")
    chol = phase_host_path_chol(dev)
    out = dict(full=full, capped=capped, headline=head, chol=chol,
               capture_s=segments.CAPTURE_SECONDS[0] - cap0, wall_s=time.perf_counter() - t21)
    _log(f"  phase 21 took {out['wall_s']:.1f} s (graph captures {out['capture_s']:.2f} s)")
    return out


def peak_memory(dev, draws=4):
    """Peak device memory (GB, allocated and reserved by the caching
    allocator, whose reserve holds the graph pools) on the package's
    default route, each workload on one solver kept alive to the end: the
    large rung (8192x1024 f32, ``chol``, three solves), and ``draws``
    ``vsolve`` calls with the rescue (the headline's family, B = 16,384,
    one draw each, so each rescue solves another number of lanes); the
    banks each solver and its rescue siblings keep."""
    import gc

    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import large_rung_problem, lm_bench_batch, lm_bench_family

    def banks(solver):
        sibs = solver.__dict__.get("_rescue_siblings", {}).values()
        return sum(len(getattr(x, "_banks", {})) for x in (solver, *sibs))

    def measured(fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        a0, r0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        info = fn()
        torch.cuda.synchronize()
        return dict(wall_s=time.perf_counter() - t0, base_allocated_gb=a0 / 1e9, base_reserved_gb=r0 / 1e9,
                    peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
                    end_reserved_gb=torch.cuda.memory_reserved(dev) / 1e9, **info)

    out = {}
    pb, _, _ = large_rung_problem(dtype=torch.float32, device=dev)
    s = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol", block_size=256,
                       dtype=torch.float32, device=dev)
    out["large_rung"] = measured(lambda: dict(statuses=[s.solve(max_iter=30, max_time=600.0).status
                                                        for _ in range(3)], banks=banks(s)))
    del s, pb
    fam = lm_bench_family(torch.float32, dev)
    s = CaNNOLeSSolver(fam, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=dev)

    def repeated():
        solved = []
        for seed in range(draws):
            x0, d = lm_bench_batch(16384, seed=seed)
            res = vsolve(fam, torch.as_tensor(x0, dtype=torch.float32, device=dev), solver=s,
                         data_batch=torch.as_tensor(d, dtype=torch.float32, device=dev), max_iter=50,
                         chunk_size=16384, max_eval=48, rescue=True)
            solved.append(int(res.summary()["solved"]))
        return dict(solved=solved, banks=banks(s), siblings=len(s.__dict__.get("_rescue_siblings", {})))

    out["repeated_vsolve_rescue"] = measured(repeated)
    _log("  peak device memory: " + "; ".join(
        f"{k} allocated {v['peak_allocated_gb']:.3f} GB, reserved {v['peak_reserved_gb']:.3f} GB "
        f"(end {v['end_reserved_gb']:.3f}), banks {v['banks']}" for k, v in out.items()))
    return out


# phase 23: the large rung's problem at these m (n = 1024, float32; J is
# 33.5 MB, 268 MB and 1.07 GB), and the most that the graph route's peak
# allocated memory may exceed the eager route's (ROADMAP queue 3 C1: 1.85x
# at m = 8,192 on an H100 80GB HBM3 at 700 W before the bank shared its data)
# phase 25: random stores (seed, entries, largest numel) over the kernel's
# paths, as the card test; the batches of the headline family's graph-route
# vsolves whose engagement is read (a B = 1 solve; a sweep's chunk with its
# rescue); the batches whose outer_post store is checked and timed
COPY_LAYOUTS = ((0, 20, 8), (1, 60, 40), (2, 150, 30), (3, 40, 3000), (4, 100, 40_000), (5, 300, 4_000))
COPY_SOLVE_B = (1, 4096)
COPY_STORE_B = (1, 16_384)
COPY_ENGAGEMENT_BAR = 0.95


def _copy_engagement(dev, B):
    """The batched copy's counts over one headline-family ``vsolve`` at B on
    the graph route (a fresh solver: its captures and replays)."""
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    x0, d = lm_bench_batch(B, seed=B)
    pb = lm_bench_family(torch.float32, dev)
    s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=dev)
    keys = ("bank_copy", ("bank_copy", "entries"), ("bank_copy", "left"))
    c0 = [_count(k) for k in keys]
    vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=dev),
           data_batch=torch.as_tensor(d, dtype=torch.float32, device=dev), solver=s,
           max_iter=50, max_eval=48, rescue=True)
    torch.cuda.synchronize()
    c = dict(zip(("launches", "entries", "left"), (_count(k) - n for k, n in zip(keys, c0))), B=B)
    c["engagement"] = c["entries"] / max(c["entries"] + c["left"], 1)
    return c


def phase_bank_copy(dev, layouts=COPY_LAYOUTS, solves=COPY_SOLVE_B, batches=COPY_STORE_B):
    """Phase 25: the bank store's batched copy.  The kernel against its
    plain version on random stores (bit for bit, one launch counted per
    launch of the plan on the card, none for the plain version on the CPU);
    the counters over a headline-family graph-route ``vsolve`` at each B of
    ``solves`` (launches counted, engagement at least
    ``COPY_ENGAGEMENT_BAR``); and the ``outer_post`` store at each B of
    ``batches`` (``bench_copy.store_row``): the kernel, the plain version
    and PyTorch's multi-tensor copy leave the same bytes, and each is timed
    inside a captured graph."""
    from cannoles_tpu_torch import bench_copy
    from cannoles_tpu_torch.ops import bank_copy
    from cannoles_tpu_torch.utils.testing import copy_expected, copy_layout, copy_pairs

    out = dict(plans=0, layouts=[])
    l0 = _count("bank_copy")
    for seed, n, max_numel in layouts:
        pool, other, entries = copy_layout(seed, n, max_numel)
        got = {}
        for where in (dev, torch.device("cpu")):
            tp, to = torch.as_tensor(pool, device=where).clone(), torch.as_tensor(other, device=where).clone()
            pairs = copy_pairs(entries, tp, to)
            if where.type == "cuda":
                plan, left = bank_copy.plan(pairs, {bank_copy._storage(d) for d, _ in pairs})
            bank_copy.store(pairs)
            got[where.type] = tp.cpu().numpy()
        torch.cuda.synchronize()
        if not (np.array_equal(got["cuda"], got["cpu"]) and np.array_equal(got["cuda"], copy_expected(entries, pool, other))):
            raise AssertionError(f"phase 25: the batched copy differs from its plain version on layout {seed}")
        out["plans"] += len(plan)
        out["layouts"].append(dict(seed=seed, entries=n, bytes=int(pool.size), launches=len(plan),
                                   one_block=sum(o for o, _ in plan), left=len(left)))
    out["launches"] = _count("bank_copy") - l0
    if out["launches"] != out["plans"]:
        raise AssertionError(f"phase 25: {out['launches']} launches counted for {out['plans']} planned on the card")
    _log(f"  kernel == plain version on {len(layouts)} random stores, {out['launches']} launches counted: "
         f"{out['layouts']}")

    out["solves"] = [_copy_engagement(dev, B) for B in solves]
    _log(f"  graph-route vsolves: {out['solves']}")
    bad = [c for c in out["solves"] if c["launches"] <= 0 or c["engagement"] < COPY_ENGAGEMENT_BAR]
    if bad:
        raise AssertionError(f"phase 25: the batched copy launched too little or folded under "
                             f"{COPY_ENGAGEMENT_BAR:.0%} of the pairs: {bad}")

    out["stores"] = [bench_copy.store_row(dev, B) for B in batches]
    for row in out["stores"]:
        _log(f"  outer_post store at B = {row['B']}: {row}")
    if not all(row["equal"] for row in out["stores"]):
        raise AssertionError("phase 25: the outer_post store's bytes differ between the kernel, the plain "
                             "version and the multi-tensor copy")
    return out


# BAL Dubrovnik-356's observation structure (cameras, points, observations:
# ``models.bal.draw_scene`` at seed 0), the pair kernel's main-path shape in
# the benchmark's cell ``bal_dubrovnik356.pool4``; its (dtype, cd) cases,
# the first the main path's and the one timed; the bars on |T - plain|
# over the sum of the terms' magnitudes, entry by entry
SCHUR_PAIRS_SCENE = (356, 226_730, 1_255_268)
SCHUR_PAIRS_CASES = ((torch.float32, 9), (torch.float32, 6), (torch.float64, 9))
SCHUR_PAIRS_BAR = {torch.float32: 1e-5, torch.float64: 1e-12}


def _pairs_library(X, W, pp):
    """The library route of the pair sums: chunked ``bmm`` and
    ``index_add_`` (float atomics, in no fixed order)."""
    from cannoles_tpu_torch.ops import schur_pairs

    out = X.new_zeros((pp.n_blocks, X.shape[1], X.shape[1]))
    for s in range(0, pp.n_pairs, schur_pairs.CHUNK):
        i, j = pp.pair_i[s:s + schur_pairs.CHUNK].long(), pp.pair_j[s:s + schur_pairs.CHUNK].long()
        out.index_add_(0, pp.block_of_pair[s:s + schur_pairs.CHUNK], torch.bmm(X[i], W[j].transpose(1, 2)))
    return out


def _pairs_bound(n_obs, pp, cd, dtype):
    """The pair kernel's least time (ms): X and W read once (n_obs·cd·3
    items each), the pair list once (two 32-bit indices a pair, one a
    block), each lower block written once; 2·cd²·3 operations a pair."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * n_obs * cd * 3 + pp.n_blocks * cd * cd) * item + (2 * pp.n_pairs + pp.n_blocks + 1) * 4
    return _bound(nbytes, 2 * cd * cd * 3 * pp.n_pairs, dtype)


def phase_schur_pairs(dev, scene=SCHUR_PAIRS_SCENE, cases=SCHUR_PAIRS_CASES):
    """Phase 26: the camera-Schur pair kernel (``ops/schur_pairs.py``) on
    BAL Dubrovnik-356's pair plan, built on the card, with random X and W
    (n_obs, cd, 3) of each case.  The kernel against its plain version on the
    same X and W: every entry of every block within ``SCHUR_PAIRS_BAR`` of
    the sum of its terms' magnitudes (the plain version on |X| and |W|);
    bit-equal across two launches; one launch counted per launch.  At the first case the kernel, the plain
    version and the library route (``bmm`` + ``index_add_``) are timed with
    CUDA events, beside the bound from the inputs."""
    from cannoles_tpu_torch.models.bal import draw_scene
    from cannoles_tpu_torch.ops import schur_pairs

    C, P, n_obs = scene
    sc = draw_scene(C, P, n_obs, seed=0)
    pp = schur_pairs.plan(sc["cam_idx"].to(dev), sc["pt_idx"].to(dev), C)
    out = dict(shape=f"{C} cameras, {P:,} points, {n_obs:,} observations", pairs=pp.n_pairs,
               blocks=pp.n_blocks, cases=[])
    g = torch.Generator(device=dev).manual_seed(26)
    l0 = _count("schur_pairs")
    launched = 0
    for k, (dtype, cd) in enumerate(cases):
        X = torch.randn((n_obs, cd, 3), generator=g, dtype=dtype, device=dev)
        W = torch.randn((n_obs, cd, 3), generator=g, dtype=dtype, device=dev)
        T1 = schur_pairs.accumulate(X, W, pp)
        T2 = schur_pairs.accumulate(X, W, pp)
        launched += 2
        ref = schur_pairs.plain(X, W, pp)
        mag = schur_pairs.plain(X.abs(), W.abs(), pp)
        torch.cuda.synchronize()
        ratio = float(((T1 - ref).abs() / mag.clamp_min(torch.finfo(dtype).tiny)).max())
        case = dict(dtype=str(dtype)[6:], cd=cd, err_over_magnitude=ratio, bit_equal=bool(torch.equal(T1, T2)),
                    max_abs_err=float((T1 - ref).abs().max()))
        if not case["bit_equal"] or not ratio <= SCHUR_PAIRS_BAR[dtype]:
            raise AssertionError(f"phase 26: the pair kernel at {case}: not bit-equal across launches or over "
                                 f"{SCHUR_PAIRS_BAR[dtype]:g} of its terms' magnitudes against the plain version")
        if k == 0:
            ms = _events_ms(lambda: schur_pairs.accumulate(X, W, pp), reps=20)
            launched += 20 + 3
            bound, by = _pairs_bound(n_obs, pp, cd, dtype)
            lib = _events_ms(lambda: _pairs_library(X, W, pp), reps=3)
            a, b = _pairs_library(X, W, pp), _pairs_library(X, W, pp)
            out.update(ms=ms, plain_ms=_events_ms(lambda: schur_pairs.plain(X, W, pp), reps=3), bound_ms=bound,
                       bound_by=by, library_ms=lib, library_bit_equal=bool(torch.equal(a, b)),
                       timed=f"{case['dtype']} cd={cd}")
        out["cases"].append(case)
        del X, W, T1, T2, ref, mag
    out["launches"] = _count("schur_pairs") - l0
    if out["launches"] != launched:
        raise AssertionError(f"phase 26: {out['launches']} pair-kernel launches counted for {launched} made")
    _log(f"  pair kernel on {out['shape']} ({out['pairs']:,} pairs, {out['blocks']:,} blocks): {out['cases']}")
    _log(f"  {out['timed']}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bmm + index_add_ "
         f"{out['library_ms']:.4f} ms (bit-equal across runs: {out['library_bit_equal']}), bound "
         f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {100 * out['bound_ms'] / out['ms']:.2f}%)")
    return out


# the products kernel's (dtype, cd) cases, the first the main path's and
# the one timed, and the bars on |kernel - plain| over the sum of the terms'
# magnitudes, entry by entry
OBS_CASES = ((torch.float32, 9), (torch.float32, 6), (torch.float64, 9))
OBS_BAR = {torch.float32: 1e-5, torch.float64: 1e-12}


def _obs_inputs(sl, cd, dtype, dev, g):
    """Random inputs of every kind: A and Bm as the forward-mode Jacobian
    leaves them (views of one (n_obs, cd + 3, 2) record an observation), X,
    W and the vectors contiguous."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=dtype, device=dev)

    n_obs = sl.n_obs
    J = rnd(1, n_obs, cd + 3, 2).transpose(-1, -2)
    A, Bm = J[..., :cd], J[..., cd:]
    return {"jv": (A, Bm, rnd(1, cd * sl.n_cams + 3 * sl.n_pts)), "jtw": (A, Bm, rnd(1, 2 * n_obs)),
            "reduce": (rnd(1, n_obs, cd, 3), rnd(1, sl.n_pts, 3)),
            "lift": (rnd(1, n_obs, cd, 3), rnd(1, sl.n_cams, cd)), "uv": (A, Bm)}


def _obs_bound(kind, sl, cd, dtype):
    """A kind's least time (ms): every block, index list, vector and output
    read or written once (each observation's A and Bm 2·(cd + 3) items,
    X or W 3·cd, a camera or point index or order entry 4 bytes, each CSR
    start 4 bytes); two operations a multiply-add."""
    item = torch.finfo(dtype).bits // 8
    n, C, P = sl.n_obs, sl.n_cams, sl.n_pts
    N = cd * C + 3 * P
    ab, xw = 2 * (cd + 3) * n, 3 * cd * n
    items, ints, flops = {
        "jv": (ab + N + 2 * n, 2 * n, 4 * (cd + 3) * n),
        "jtw": (ab + 2 * n + N, 2 * n + C + P + 2, 4 * (cd + 3) * n),
        "reduce": (xw + 3 * P + cd * C, 2 * n + C + 1, 6 * cd * n),
        "lift": (xw + cd * C + 3 * P, 2 * n + P + 1, 6 * cd * n),
        "uv": (ab + cd * cd * C + 9 * P, 2 * n + C + P + 2, 4 * (cd * (cd + 1) // 2 + 6) * n),
    }[kind]
    return _bound(items * item + 4 * ints, flops, dtype)


def _obs_library(kind, args, sl):
    """The library route of a kind: the plain version's einsums with each
    segment sum by ``index_add_`` (float atomics, in no fixed order)."""
    from cannoles_tpu_torch.ops import obs_products

    def seg(values, index, n):
        v = values.transpose(0, 1)
        return v.new_zeros((n, *v.shape[1:])).index_add_(0, index, v).transpose(0, 1)

    kept, obs_products._seg = obs_products._seg, seg
    try:
        return getattr(obs_products, f"plain_{kind}")(*args, sl)
    finally:
        obs_products._seg = kept


def phase_obs_products(dev, scene=SCHUR_PAIRS_SCENE, cases=OBS_CASES):
    """Phase 27: the list route's products over observations
    (``ops/obs_products.py``) on BAL Dubrovnik-356's lists, built on the
    card.  Each kind against its plain version on random inputs of each
    case: every entry within ``OBS_BAR`` of the sum of its terms' magnitudes
    (the plain version on the inputs' magnitudes); bit-equal across two
    launches; one launch counted per launch.  At the first case each kind's
    kernel, plain version and library route are timed with CUDA events,
    beside its byte bound.  Then one float32 LM solve of the scene: the
    product calls of every kind and the launches over them."""
    from cannoles_tpu_torch.core import segments
    from cannoles_tpu_torch.core.ba import SchurBASolver
    from cannoles_tpu_torch.models.bal import bal_scene, draw_scene
    from cannoles_tpu_torch.ops import obs_products

    C, P, n_obs = scene
    sc = draw_scene(C, P, n_obs, seed=0)
    sl = obs_products.lists(sc["cam_idx"].to(dev), sc["pt_idx"].to(dev), C, P)
    out = dict(shape=f"{C} cameras, {P:,} points, {n_obs:,} observations", cases=[], kinds={})
    g = torch.Generator(device=dev).manual_seed(27)
    l0 = _count("obs_products")
    launched = 0
    tup = (lambda t: t if isinstance(t, tuple) else (t,))
    for k, (dtype, cd) in enumerate(cases):
        case = dict(dtype=str(dtype)[6:], cd=cd, err_over_magnitude={}, bit_equal={})
        for kind, args in _obs_inputs(sl, cd, dtype, dev, g).items():
            fn = getattr(obs_products, kind)
            plain = getattr(obs_products, f"plain_{kind}")
            k1, k2 = fn(*args, sl), fn(*args, sl)
            launched += 2
            ref, mag = plain(*args, sl), plain(*(a.abs() for a in args), sl)
            torch.cuda.synchronize()
            case["err_over_magnitude"][kind] = max(
                float(((a - r).abs() / m.clamp_min(torch.finfo(dtype).tiny)).max())
                for a, r, m in zip(tup(k1), tup(ref), tup(mag)))
            case["bit_equal"][kind] = all(torch.equal(a, b) for a, b in zip(tup(k1), tup(k2)))
            if not case["bit_equal"][kind] or not case["err_over_magnitude"][kind] <= OBS_BAR[dtype]:
                raise AssertionError(f"phase 27: the products kernel's {kind} at {case}: not bit-equal across "
                                     f"launches or over {OBS_BAR[dtype]:g} of its terms' magnitudes")
            if k == 0:
                ms = _events_ms(lambda: fn(*args, sl), reps=20)
                launched += 23
                bound, by = _obs_bound(kind, sl, cd, dtype)
                row = out["kinds"][kind] = dict(
                    ms=ms, bound_ms=bound, bound_by=by, share=bound / ms,
                    plain_ms=_events_ms(lambda: plain(*args, sl), reps=5),
                    library_ms=_events_ms(lambda: _obs_library(kind, args, sl), reps=5))
                _log(f"  {kind} ({case['dtype']} cd={cd}): kernel {ms:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                     f"einsum + index_add_ {row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}, "
                     f"{100 * bound / ms:.2f}%)")
            del k1, k2, ref, mag
        out["cases"].append(case)
    out["launches"] = _count("obs_products") - l0
    if out["launches"] != launched:
        raise AssertionError(f"phase 27: {out['launches']} products-kernel launches counted for {launched} made")
    _log(f"  products kernel on {out['shape']}: {out['cases']}")

    pb, _ = bal_scene(C, P, n_obs, seed=0, dtype=torch.float32, device=dev)
    s = SchurBASolver(pb, C, P, method="lm", use_initial_multiplier=True)
    s.solve(max_iter=50)  # warm: the lists, the pair plan, the kernels' first launches
    c0 = segments.counters()
    t0 = time.perf_counter()
    st = s.solve(max_iter=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = segments.counters()
    calls = {kind: c1[("obs_products", kind)] - c0[("obs_products", kind)] for kind in obs_products.KINDS}
    launches = c1["obs_products"] - c0["obs_products"]
    out["solve"] = dict(status=st.status, iter=st.iter, nfact=st.solver_specific["nfact"], wall_ms=1e3 * wall,
                        calls=calls, launches=launches, engagement=launches / max(sum(calls.values()), 1))
    _log(f"  one solve of the scene: {out['solve']}")
    if min(calls.values()) <= 0 or out["solve"]["engagement"] != 1.0:
        raise AssertionError(f"phase 27: a solve's products did not all go through the kernel: {out['solve']}")
    return out


# the blocks kernel's types, the first the main path's and the one timed,
# and the bars on |kernel - plain| over each observation's block magnitude
# (the largest |entry| of its A, Bm or W from the plain version): the two
# round the same derivatives in other orders (jacfwd's tangent by tangent
# and cuBLAS's W, the kernel's closed form with each product rounded)
OBS_BLOCKS_CASES = (torch.float32, torch.float64)
OBS_BLOCKS_BAR = {torch.float32: 1e-5, torch.float64: 1e-12}
# operations an observation, counted from csrc/obs_blocks.cu's source (the
# full rotation branch, the mask and W included; sqrt, sin, cos and a
# divide count one each)
OBS_BLOCKS_FLOPS = 490


def _blocks_err(got, want, dtype):
    """The largest |kernel - plain| over each observation's block magnitude,
    of A, Bm and W."""
    tiny = torch.finfo(dtype).tiny
    return max(float(((g - w).abs().flatten(2).amax(-1) / w.abs().flatten(2).amax(-1).clamp_min(tiny)).max())
               for g, w in zip(got, want))


def _blocks_bound(sl, dtype):
    """The blocks kernel's least time (ms): two 32-bit indices an
    observation, x's cameras and points read once, A, Bm and W written once
    (2·9 + 2·3 + 9·3 items an observation)."""
    item = torch.finfo(dtype).bits // 8
    nbytes = 8 * sl.n_obs + item * (9 * sl.n_cams + 3 * sl.n_pts + 51 * sl.n_obs)
    return _bound(nbytes, OBS_BLOCKS_FLOPS * sl.n_obs, dtype)


def phase_obs_blocks(dev, scene=SCHUR_PAIRS_SCENE, cases=OBS_BLOCKS_CASES):
    """Phase 28: the list route's per-observation Jacobian blocks
    (``ops/obs_blocks.py``) on BAL Dubrovnik-356's lists, built on the card,
    at the scene's true cameras and points, camera 0's pose frozen by the
    mask.  The kernel against its plain version in each type: A, Bm and W
    within ``OBS_BLOCKS_BAR`` of each observation's block magnitude;
    bit-equal across two launches; one launch counted per launch.  At the
    first type the kernel and the plain version are timed with CUDA events,
    beside the byte bound.  Then one float32 LM solve of the scene: the
    block evaluations and the launches over them."""
    from cannoles_tpu_torch.core import segments
    from cannoles_tpu_torch.core.ba import SchurBASolver
    from cannoles_tpu_torch.models.bal import bal_scene, draw_scene, snavely_project
    from cannoles_tpu_torch.ops import obs_blocks, obs_products

    C, P, n_obs = scene
    sc = draw_scene(C, P, n_obs, seed=0)
    sl = obs_products.lists(sc["cam_idx"].to(dev), sc["pt_idx"].to(dev), C, P)
    out = dict(shape=f"{C} cameras, {P:,} points, {n_obs:,} observations", cases=[])
    l0 = _count("obs_blocks")
    launched = 0
    for k, dtype in enumerate(cases):
        x = torch.cat([sc["cams"].reshape(-1), sc["pts"].reshape(-1)]).to(dtype=dtype, device=dev)[None]
        mask = torch.ones((C, 9), dtype=dtype, device=dev)
        mask[0, :6] = 0
        k1 = obs_blocks.blocks(snavely_project, x, sl, 9, mask)
        k2 = obs_blocks.blocks(snavely_project, x, sl, 9, mask)
        launched += 2
        ref = obs_blocks.plain_blocks(snavely_project, x, sl, 9, mask)
        torch.cuda.synchronize()
        case = dict(dtype=str(dtype)[6:], err_over_magnitude=_blocks_err(k1, ref, dtype),
                    bit_equal=all(torch.equal(a, b) for a, b in zip(k1, k2)))
        if not case["bit_equal"] or not case["err_over_magnitude"] <= OBS_BLOCKS_BAR[dtype]:
            raise AssertionError(f"phase 28: the blocks kernel at {case}: not bit-equal across launches or over "
                                 f"{OBS_BLOCKS_BAR[dtype]:g} of the blocks' magnitudes against the plain version")
        if k == 0:
            ms = _events_ms(lambda: obs_blocks.blocks(snavely_project, x, sl, 9, mask), reps=20)
            launched += 23
            bound, by = _blocks_bound(sl, dtype)
            out.update(ms=ms, bound_ms=bound, bound_by=by, share=bound / ms, timed=case["dtype"],
                       plain_ms=_events_ms(lambda: obs_blocks.plain_blocks(snavely_project, x, sl, 9, mask), reps=3))
            _log(f"  {case['dtype']}: kernel {ms:.4f} ms, plain {out['plain_ms']:.4f} ms, bound {bound:.4f} ms "
                 f"({by}, {100 * bound / ms:.2f}%)")
        out["cases"].append(case)
        del k1, k2, ref
    out["launches"] = _count("obs_blocks") - l0
    if out["launches"] != launched:
        raise AssertionError(f"phase 28: {out['launches']} blocks-kernel launches counted for {launched} made")
    _log(f"  blocks kernel on {out['shape']}: {out['cases']}")

    pb, _ = bal_scene(C, P, n_obs, seed=0, dtype=torch.float32, device=dev)
    s = SchurBASolver(pb, C, P, method="lm", use_initial_multiplier=True)
    s.solve(max_iter=50)  # warm: the lists, the pair plan, the kernels' first launches
    c0 = segments.counters()
    t0 = time.perf_counter()
    st = s.solve(max_iter=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1 = segments.counters()
    calls = c1[("obs_blocks", "calls")] - c0[("obs_blocks", "calls")]
    launches = c1["obs_blocks"] - c0["obs_blocks"]
    out["solve"] = dict(status=st.status, iter=st.iter, nfact=st.solver_specific["nfact"], wall_ms=1e3 * wall,
                        calls=calls, launches=launches, engagement=launches / max(calls, 1))
    _log(f"  one solve of the scene: {out['solve']}")
    if calls <= 0 or out["solve"]["engagement"] != 1.0:
        raise AssertionError(f"phase 28: a solve's blocks did not all come from the kernel: {out['solve']}")
    return out


MEMORY_ROWS = (8192, 65536, 262144)
MEMORY_RATIO_BAR = 1.25


def phase_memory(dev, sizes=MEMORY_ROWS, n=1024, bar=MEMORY_RATIO_BAR):
    """Phase 23: the peak device memory of both routes (allocated and
    reserved by the caching allocator, whose reserve holds the graph pool)
    over three solves of ``large_rung_problem(m, n)`` on one solver
    (float32, Gauss–Newton, condensed, ``chol``), at each m of ``sizes``;
    every solve ``first_order``, the graph route's peak allocated at most
    ``bar`` times the eager route's (no bar: ``--measure`` reads another
    package)."""
    import gc

    from cannoles_tpu_torch import CaNNOLeSSolver
    from cannoles_tpu_torch.models.families import large_rung_problem

    t23 = time.perf_counter()
    out = {}
    for m in sizes:
        pb, _, _ = large_rung_problem(m, n, dtype=torch.float32, device=dev)
        row = dict(jacobian_gb=m * n * 4 / 1e9)
        for route in ("eager", "graph"):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            s = _force_route(CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol",
                                            block_size=256, dtype=torch.float32, device=dev), route)
            sts = [s.solve(max_iter=30, max_time=600.0).status for _ in range(3)]
            torch.cuda.synchronize()
            if sts != ["first_order"] * 3 or s.route != route:
                raise AssertionError(f"phase 23: m={m} on the {route} route ({s.route}): {sts}")
            row[route] = dict(peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                              peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9)
            del s
        row["ratio_allocated"] = row["graph"]["peak_allocated_gb"] / row["eager"]["peak_allocated_gb"]
        _log(f"  m={m} (J {row['jacobian_gb']:.3f} GB): peak allocated / reserved GB eager "
             f"{row['eager']['peak_allocated_gb']:.4f} / {row['eager']['peak_reserved_gb']:.4f}, graph "
             f"{row['graph']['peak_allocated_gb']:.4f} / {row['graph']['peak_reserved_gb']:.4f}, "
             f"ratio {row['ratio_allocated']:.3f}")
        if bar is not None and row["ratio_allocated"] > bar:
            raise AssertionError(f"phase 23: m={m}: the graph route's peak allocated memory is "
                                 f"{row['ratio_allocated']:.3f} times the eager route's")
        out[str(m)] = row
        del pb
    out["wall_s"] = time.perf_counter() - t23
    _log(f"  phase 23 took {out['wall_s']:.1f} s")
    return out


BENCH_TIMEOUT = 900
BENCH_BA_SOLVED = 254
BENCH_LARGE_ERR = 1e-3  # phase 8's bar
BENCH_KEYS = ("ba_scenes_per_s", "ba_scenes_per_s_device", "ba_solved", "ba_mfu_pct", "large_ms_per_solve",
              "large_ms_device", "large_ms_device_bf16", "large_mfu_pct", "warmup_s", "total_s", "headline_solved",
              "headline_failures_pre_rescue", "backend", "device_name", "power_limit")


def check_bench(line: dict, err: str) -> dict:
    """Phase 24's checks of the bench's JSON line and standard error: every
    key there and filled, the headline's solved count against its rung's B,
    the BA rung's solved count, the large rung's status and error.  Returns
    the best rung and the large rung's status and error."""
    extra = line.get("extra", {})
    missing = [k for k in ("metric", "value", "unit", "vs_baseline") if line.get(k) is None]
    missing += [k for k in BENCH_KEYS if extra.get(k) is None]
    if missing:
        raise AssertionError(f"phase 24: the bench's line lacks or nulls {missing}")
    rungs = [dict(B=int(B), value=float(v), solved=int(sv))
             for B, v, sv in re.findall(r"^# pallas B=(\d+) chunk=\S+: (\d+) inst/s solved=(\d+)/\d+", err, re.M)]
    best = [r for r in rungs if abs(r["value"] - line["value"]) <= 1.0 and r["solved"] == int(extra["headline_solved"])]
    if not best:
        raise AssertionError(f"phase 24: no rung line matches the headline {line['value']} ({rungs})")
    B = best[0]["B"]
    if int(extra["headline_solved"]) < 0.99 * B:
        raise AssertionError(f"phase 24: headline solved {extra['headline_solved']}/{B} < 99%")
    solved, total = map(int, extra["ba_solved"].split("/"))
    if solved < BENCH_BA_SOLVED * total / 256:
        raise AssertionError(f"phase 24: BA rung solved {extra['ba_solved']} < {BENCH_BA_SOLVED}/256")
    m = re.search(r"^# large rung: .* status=(\d+) err=(\S+) ", err, re.M)
    if m is None:
        raise AssertionError("phase 24: no large rung line on the bench's standard error")
    status, large_err = int(m.group(1)), float(m.group(2))
    if status != 1 or not large_err <= BENCH_LARGE_ERR:  # 1: first_order
        raise AssertionError(f"phase 24: large rung status {status}, max |x - x_true| {large_err}")
    return dict(best_rung=best[0], large_status=status, large_err=large_err)


def phase_bench() -> dict:
    """Phase 24: the bench module in a process of its own, checked."""
    t24 = time.perf_counter()
    here = str(pathlib.Path(__file__).resolve().parent)
    r = subprocess.run([sys.executable, "-m", "cannoles_tpu_torch.bench"], capture_output=True, text=True,
                       cwd=here, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t24
    for line in r.stderr.strip().splitlines():
        _log(f"  {line}")
    lines = r.stdout.strip().splitlines()
    if r.returncode or not lines:
        raise AssertionError(f"phase 24: the bench exited {r.returncode}: {r.stderr[-2000:]}")
    line = json.loads(lines[-1])
    _log(f"  bench line: {lines[-1]}")
    _log(f"  phase 24 took {wall:.1f} s")
    return dict(line=line, wall_s=wall, **check_bench(line, r.stderr))


def _stop(runs):
    for p, f in runs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()


def measure(root: str) -> int:
    """``--measure``: phase 4, then phase 3 and phase 7's times, then phase
    21's two workloads capped (``biggs_exp6_24`` f64 at ``HOST_PATH_CAP``
    outer iterations on the package's default route, with the device
    operations per host check; the headline with its rescue, two reps),
    then ``peak_memory`` and phase 23's ladder (no bar), nothing else, for
    the package under ``root``; prints one JSON line."""
    sys.path.insert(0, root)
    from cannoles_tpu_torch.ops import _native

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _native.load()
    head = phase_headline(dev)
    for k in ("pre_status", "status"):  # per-lane statuses: phase 13's input, not printed
        head.pop(k)
    shapes = [(5, 16384), (73, 256)] + ([tuple(head["rescue_shape"])] if head["rescue_shape"] else [])
    ldlt = ldlt_times(dev, shapes, plain=False)
    ldlt["host_us_per_call N=5 B=256"] = ldlt_host_us(dev)
    chol = chol_times(dev, plain=False)
    biggs, _ = host_path_solve(dev, "graph", max_iter=HOST_PATH_CAP)
    rescue, _ = headline_rescue(dev, "graph")
    memory = peak_memory(dev)
    ladder = phase_memory(dev, bar=None)
    _log(json.dumps({"root": root, "headline": head, "ldlt": ldlt, "chol": chol,
                     "host_path": {"biggs_capped": biggs, "headline_rescue": rescue}, "memory": memory,
                     "memory_ladder": ladder}))
    return 0


def against(other: str) -> int:
    """``--against DIR``: ``--measure`` for DIR's package, then this one, each
    in a fresh process, on one card."""
    here = str(pathlib.Path(__file__).resolve().parent)
    rc = 0
    for root in (other, here):
        r = subprocess.run([sys.executable, __file__, "--measure", root], capture_output=True,
                           text=True, timeout=900)
        _log(r.stdout.strip())
        if r.returncode:
            print(r.stderr[-4000:], file=sys.stderr, flush=True)
            rc = r.returncode
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="compare phase 4's wall, phases 3 and 7's times and phase 21's capped "
                         "workloads with the package in DIR")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if args.measure:
        return measure(args.measure)
    if args.against:
        return against(str(pathlib.Path(args.against).resolve()))
    from cannoles_tpu_torch.ops import _native
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

    _phase("phase 3: kernel vs plain version on the card")
    worst = phase_kernel(dev)
    sweep = threshold_sweep(dev)
    times = ldlt_times(dev, [(5, 16384), (73, 256)])
    f0 = _count("fused_ldlt")
    _phase("phase 4: headline rung")
    head = phase_headline(dev)
    head_lanes = {k: head.pop(k) for k in ("pre_status", "status")}
    _phase("phase 5: BA rung")
    ba = phase_ba(dev)
    launches = _count("fused_ldlt") - f0
    _log("  phase 3's kernel at the rescue's most frequent shape, and its host cost per call")
    rescue = tuple(head["rescue_shape"] or (5, 48))
    times.update(ldlt_times(dev, [rescue]))
    host_us = ldlt_host_us(dev)
    _phase("phase 6: solver on the card vs on the CPU")
    phase_parity(dev)

    _phase("phase 7: Cholesky kernels vs plain versions on the card")
    chol_worst, chol_worst_ill = phase_chol_kernels(dev)
    times7 = chol_times(dev)
    c0 = _count("chol_fused"), _count("chol_block")
    _phase("phase 8: large rung (linsolve='chol')")
    large = phase_large_rung(dev)
    _phase("phase 9: BA scene 16x300 (linsolve='chol')")
    ba_large = phase_ba_large(dev)
    _phase("phase 10: BA scene 16x300 in float64, card vs CPU")
    phase_ba_parity(dev)
    fused_launches, block_launches = _count("chol_fused") - c0[0], _count("chol_block") - c0[1]
    if fused_launches <= 0 or block_launches <= 0:
        raise AssertionError(f"the chol path launched the fused kernel {fused_launches} and the "
                             f"block kernel {block_launches} times")

    # phase 20 before the pool, so that its walls are not shared with it
    c0 = _count("fused_ldlt"), _count("chol_fused")
    _phase("phase 20: matmul_precision on the card (large rung, BA rung)")
    t20 = time.perf_counter()
    prec = dict(large_rung=prec_large_rung(dev), ba=prec_ba(dev))
    prec_launches = dict(fused_ldlt=_count("fused_ldlt") - c0[0], chol_fused=_count("chol_fused") - c0[1])
    _log(f"  phase 20's kernel launches: {prec_launches}")
    _phase("phase 20: the bf16 route vs its plain version, the pinned sites, float64 card vs CPU")
    prec.update(phase_precision(dev))
    prec["wall_s"] = time.perf_counter() - t20
    _log(f"  phase 20 took {prec['wall_s']:.1f} s")

    # phase 21 before the pool too: its walls and ms per host check are
    # the host's, which the pool's workers would share
    c0 = _count("fused_ldlt"), _count("chol_fused")
    _phase("phase 21: the graph route against the eager route (biggs_exp6_24 f64, the headline's rescue, "
           "linsolve='chol' at B = 4)")
    host_path = phase_host_path(dev)
    host_path["launches"] = _count("fused_ldlt") - c0[0]
    host_path["launches_chol_fused"] = _count("chol_fused") - c0[1]
    if host_path["launches"] <= 0 or host_path["launches_chol_fused"] <= 0:
        raise AssertionError(f"phase 21: the headline launched the fused LDLT kernel {host_path['launches']} "
                             f"times and the chol batch the Cholesky kernel {host_path['launches_chol_fused']} "
                             "times")

    _phase("phase 25: the bank store's batched copy (kernel vs plain version, engagement, outer_post stores)")
    copies = phase_bank_copy(dev)

    _phase("phase 26: the camera-Schur pair kernel on BAL Dubrovnik-356's plan (kernel vs plain version, times)")
    pairs = phase_schur_pairs(dev)
    torch.cuda.empty_cache()

    _phase("phase 27: the list route's products over observations on BAL Dubrovnik-356's lists (kernel vs plain "
           "version, times, one solve's engagement)")
    products = phase_obs_products(dev)
    torch.cuda.empty_cache()

    _phase("phase 28: the list route's per-observation Jacobian blocks on BAL Dubrovnik-356's lists (kernel vs "
           "plain version, times, one solve's engagement)")
    blocks28 = phase_obs_blocks(dev)
    torch.cuda.empty_cache()

    _phase("phase 23: peak device memory of the graph and eager routes, large_rung_problem(m, 1024) at m = "
           + ", ".join(f"{m:,}" for m in MEMORY_ROWS))
    memory = phase_memory(dev)

    # phase 24 alone on the card too: its walls are the bench's timing
    torch.cuda.empty_cache()
    _phase("phase 24: the headline benchmark, python -m cannoles_tpu_torch.bench")
    bench = phase_bench()

    # the battery's solves are host-bound: with 8 workers on an H100's
    # 8-CPU host every row ran at half the speed it has beside two others
    # (biggs_exp6_24 on the CPU: 318 s against 160 s), and its card row,
    # the longest, set the pool's wall at 604 s; with 4 that row took 382 s
    workers = min(4, os.cpu_count() or 1)
    _phase(f"phases 11-12: the battery's 90 problems in three settings, {workers} worker processes "
           f"({os.cpu_count()} CPUs)")
    def large_ba():
        # the card work of phases 14-15 runs here while the workers solve
        _phase("phase 14: BA scene 100x10,000 through SchurBASolver and MatrixFreeSolver (beside the pool)")
        t0 = time.perf_counter()
        scene = phase_ba_scene(dev)
        _phase("phase 15: BA engines card vs CPU in float64, checkpoints on the card (beside the pool)")
        parity = phase_ba_scene_parity(dev)
        return dict(scene=scene, parity=parity, wall_s=time.perf_counter() - t0)

    # phase 18's examples run beside the pool: their solves are host-bound
    examples, example_ends = start_examples()
    _log(f"  phase 18's examples started beside the pool: {', '.join(EXAMPLES)}")
    try:
        pool_rows, pool_wall, large = battery_pool(workers, large_ba)
        _log(f"  phases 14-15 took {large['wall_s']:.3f} s beside the pool")
        _phase("phase 11: the battery's uniform pass in float64, card vs CPU")
        parity11 = phase_battery_parity(dev, pool_rows)
        _phase("phase 12: the battery with its rescues in float32 on the card")
        battery12 = phase_battery(dev, pool_rows, pool_wall)
        f0 = _count("fused_ldlt")
        _phase("phase 13: vsolve(max_time=...) on the headline family")
        deadline = phase_deadline(dev, head_lanes)
        deadline_launches = _count("fused_ldlt") - f0
        _phase("phase 16: the huge separable fit (m=2,097,152, n=4,096, float32) through MatrixFreeSolver")
        fit = phase_fit(dev)
        _phase("phase 17: the fit in float64 card vs CPU, and linsolve='cpp' vs 'ldlt' on the card")
        fit_parity = phase_fit_parity(dev)
        _phase("phase 18: the examples on the card")
        examples_out = phase_examples(examples, example_ends)
    finally:
        _stop(examples)
    _phase("phase 19: the multi-device layer, k gloo ranks sharing the card")
    sharded = phase_sharded(dev)
    _phase("phase 22: the entry points (dryrun, bench_large, scaling, bench_chol, perf_profile, mgh_battery)")
    entries = phase_entry_points(dev)

    head_t, ba_t, rescue_t = (times[f"N={N} B={B}"] for N, B in ((5, 16384), (73, 256), rescue))
    _log(smi)
    _log(json.dumps({"kernels": [{
        "name": "fused_ldlt_solve",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/fused_ldlt.cu",
        "replaces": "cannoles_tpu/ops/pallas_ldlt.py:79",
        "launches": launches,
        "max_abs_err": worst,
        **head_t,
        "library_ms": None,  # torch.linalg.ldl_factor_ex pivots: another function
        "shape": "f32 N=5 B=16384",
        **{f"{k}_ba": v for k, v in ba_t.items()},
        "shape_ba": "f32 N=73 B=256",
        **{f"{k}_rescue": v for k, v in rescue_t.items()},
        "shape_rescue": f"f32 N={rescue[0]} B={rescue[1]}",
        "thread_max_n": fl.thread_max_n(),
        "threshold_sweep": sweep,
        "host_us_per_call": host_us,
        "headline": head,
        "ba": ba,
        "launches_deadline": deadline_launches,
        "deadline": deadline,
        # phase 19: vsolve(mesh=) over 4 ranks on BASELINE config 5
        "launches_config5_per_rank": sharded["cfg5"]["launches"],
        # phase 20: the BA rung under the six matmul_precision settings
        "launches_precision": prec_launches["fused_ldlt"],
        # phase 21: the headline on both routes, two reps each
        "launches_host_path": host_path["launches"],
    }, {
        "name": "chol_fused",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/block_chol.cu",
        "replaces": "cannoles_tpu/ops/pallas_chol.py:117",
        "launches": fused_launches,
        "max_abs_err": chol_worst["fused"],
        "max_abs_err_kappa_1e6": chol_worst_ill["fused"],
        **times7["fused"],
        "shape": "f32 N=1024 nb=256 B=1 (factor)",
        "large_rung": large,
        "ba_16x300": ba_large,
        # phase 19: solve_row_sharded at the kernel seam on BASELINE config 4
        "launches_config4_per_rank": sharded["launches_cfg4_per_rank"],
        # phase 20: the large rung under 'bfloat16' at the kernel seam
        "launches_precision": prec_launches["chol_fused"],
        # phase 21: the exp-fit batch at B = 4 through the kernel on both routes
        "launches_host_path": host_path["launches_chol_fused"],
        # phase 22: bench_chol's rows at N = 256, 512, 1024 (f32, nb = 128)
        "launches_bench_chol": entries["bench_chol"]["launches"][0],
        "bench_chol": [_chol_row(r) for r in entries["bench_chol"]["rows"] if r["route"] == "fused"],
    }, {
        "name": "chol_block",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/block_chol.cu",
        "replaces": "cannoles_tpu/ops/pallas_chol.py:56",
        "launches": block_launches,
        "max_abs_err": chol_worst["block"],
        "max_abs_err_kappa_1e6": chol_worst_ill["block"],
        **times7["block"],
        # launches of one factorization on the blocked route (f64 N=1024)
        "wrapper_launches_per_factorization": times7["blocked"]["wrapper_launches_per_factorization"],
        "device_launches_per_factorization": times7["blocked"]["device_launches_per_factorization"],
        "shape": "f64 nb=256 B=1 (one block)",
        "blocked_route": times7["blocked"],
        "blocked_route_shape": "f64 N=1024 nb=256 B=1 (factor: the block kernel + torch.matmul)",
        # phase 22: bench_chol's rows at N = 2048, 4096 (f32, nb = 128, blocked route)
        "launches_bench_chol": entries["bench_chol"]["launches"][1],
        "bench_chol": [_chol_row(r) for r in entries["bench_chol"]["rows"] if r["route"] == "blocked"],
    }, {
        "name": "bank_copy",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/bank_copy.cu",
        "replaces": None,  # no TPU kernel: the graph route's copy of a segment's outputs
        **copies,
    }, {
        "name": "schur_pairs",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/schur_pairs.cu",
        "replaces": None,  # no TPU kernel: the JAX package's Schur engine takes the dense grid's einsum
        **pairs,
    }, {
        "name": "obs_products",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/obs_products.cu",
        "replaces": None,  # no TPU kernel: the JAX package has no observation-list route
        **products,
    }, {
        "name": "obs_blocks",
        "route": "cuda",
        "source": "cannoles_tpu_torch/csrc/obs_blocks.cu",
        "replaces": None,  # no TPU kernel: the JAX package has no observation-list route
        **blocks28,
    }], "battery": {"parity_f64": parity11, "f32_card": battery12}, "large_ba": large,
        "separable_fit": fit, "fit_parity": fit_parity, "examples": examples_out,
        "sharded": {k: v for k, v in sharded.items() if k != "launches_cfg4_per_rank"},
        "matmul_precision": prec, "host_path": host_path, "memory": memory, "bench": bench,
        "entry_points": {k: v for k, v in entries.items() if k not in ("bench_chol", "perf_profile")}}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
