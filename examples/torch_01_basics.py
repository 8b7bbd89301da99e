#!/usr/bin/env python
"""Basics with the PyTorch port: define problems, solve, inspect results.

The port's twin of examples/01_basics.py.  Runs on the card by default;
without one it raises.  On the CPU:  python examples/torch_01_basics.py --cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from cannoles_tpu_torch import CaNNOLeSSolver, cannoles, nls_problem  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
device = "cpu" if ap.parse_args().cpu else None  # None: the card, or raise

# ---- unconstrained Rosenbrock in NLS form --------------------------------
rosen = nls_problem(
    lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
    [-1.2, 1.0],
    nequ=2,
    device=device,
)
stats = cannoles(rosen)
print("rosenbrock:", stats)

# ---- equality constrained, with the iteration log ------------------------
constrained = nls_problem(
    lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
    [-1.2, 1.0],
    2,
    cons=lambda x: (x[0] + x[1]).reshape(1),
    lcon=[1.0],
    ucon=[1.0],
    device=device,
)
stats = cannoles(constrained, verbose=1)
print("solution:", stats.solution, " multipliers:", stats.multipliers)

# ---- reusable solver: warm starts -----------------------------------------
# The last start ends max_eval (100,000 evaluations) in 2 iterations, with
# one host check per ρ attempt, line-search trip and inner iteration (71,445
# here).  The JAX twin gets there within solve()'s default 30 s budget.  On
# one idle CPU thread the port took 28.0 s (115.1 s before its evaluators
# were built once and its derivatives traced, and its host checks cut;
# `python -m cannoles_tpu_torch.host_timings --device cpu --what solves`,
# PERF.md); on an H100 each segment between two checks is one CUDA graph
# replay.  The budget stays 120 s.
solver = CaNNOLeSSolver(constrained, method="gauss_newton", kkt="condensed")
for x0 in ([0.0, 0.0], [3.0, -2.0], [-5.0, 5.0]):
    s = solver.solve(x0=torch.tensor(x0, dtype=solver.dtype, device=solver.device), max_time=120.0)
    print(f"from {x0}: {s.status} in {s.iter} iters ({s.elapsed_time:.1f} s) -> {s.solution}")
