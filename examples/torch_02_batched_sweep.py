#!/usr/bin/env python
"""Batched instance sweep + multistart with the PyTorch port.

The port's twin of examples/02_batched_sweep.py.  Runs on the card by
default; without one it raises.

    python examples/torch_02_batched_sweep.py [--cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cannoles_tpu_torch import CaNNOLeSSolver, multistart, nls_problem, vsolve  # noqa: E402
from cannoles_tpu_torch.models.mgh import mgh_problem  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
device = "cpu" if ap.parse_args().cpu else None  # None: the card, or raise


# A problem *family*: `data` parameterizes each instance.
def residual(x, theta):
    return torch.stack([x[0] - theta[0], 10 * (x[1] - x[0] ** 2) - theta[1]])


def cons(x, theta):
    return (x[0] + x[1] - theta[2]).reshape(1)


family = nls_problem(residual, [-1.2, 1.0], 2, cons, [0.0], [0.0], data=torch.zeros(3), device=device)

B = 512
rng = np.random.default_rng(0)
x0s = rng.normal(scale=0.5, size=(B, 2)) + [-1.2, 1.0]
thetas = np.stack(
    [1 + 0.2 * rng.normal(size=B), 0.1 * rng.normal(size=B), 1 + 0.2 * rng.normal(size=B)],
    axis=1,
)

solver = CaNNOLeSSolver(family, method="lm", kkt="condensed")
res = vsolve(family, x0s, data_batch=thetas, solver=solver, chunk_size=128)
print("sweep:", res.summary())

# Multistart: batched global search on a nonconvex problem the single start
# gets stuck on (Freudenstein-Roth: local min at 48.98, global at 0)
fr = mgh_problem("freudenstein_roth", device=device)
single = CaNNOLeSSolver(fr).solve(atol=0.0, rtol=1e-5)
best = multistart(fr, n_starts=64, atol=0.0, rtol=1e-5, max_iter=150)
print(f"freudenstein_roth: single start Σf² = {2*single.objective:.4g}, "
      f"multistart Σf² = {2*best.objective:.4g}")
