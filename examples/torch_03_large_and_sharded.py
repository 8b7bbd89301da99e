#!/usr/bin/env python
"""One large problem with the PyTorch port: the condensed Schur solve, and the
same problem with its residual rows split over ranks.

The port's twin of examples/03_large_and_sharded.py.  Runs on the card by
default, the row-sharded solve over 2 ranks that share it (``--ranks`` to
change); without a card it raises.  ``--cpu`` runs on the CPU with 8 ranks,
as the JAX twin's ``--cpu`` gives 8 virtual devices.  Each rank is a process
of its own (``cannoles_tpu_torch.parallel.launch``), so the rank's program
lives at module level and the example's body under ``__main__``.

    python examples/torch_03_large_and_sharded.py [--cpu] [--ranks K]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cannoles_tpu_torch import CaNNOLeSSolver  # noqa: E402
from cannoles_tpu_torch.models.families import bundle_adjustment, curve_fit_family  # noqa: E402
from cannoles_tpu_torch.parallel.launch import launch  # noqa: E402
from cannoles_tpu_torch.parallel.schur import make_row_mesh, solve_row_sharded  # noqa: E402


def row_sharded_fit(device):
    """One rank's part: every rank builds the whole problem and solves its
    block of the 8,192 rows; all get the same stats."""
    mesh = make_row_mesh(device=device)
    pb = curve_fit_family(m=8192, dtype=torch.float32, device=mesh.device)
    st = solve_row_sharded(pb, mesh)
    return st.status, st.iter, st.solution


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--ranks", type=int, default=None, help="ranks of the row-sharded solve (2; --cpu: 8)")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None  # None: the card, or raise

    # ---- large curve fit, one process, two-level-Cholesky condensed solve --
    pb = curve_fit_family(m=8192, dtype=torch.float32, device=device)
    solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="chol")
    stats = solver.solve()
    print("curve fit 8192 rows:", stats.status, stats.solution)

    # ---- the same problem with its residual rows split over k ranks ------
    k = args.ranks or (8 if args.cpu else 2)
    status, iters, _ = launch(row_sharded_fit, k, device)[0]
    print("row-sharded:", status, "iters:", iters, f"({k} ranks)")

    # ---- equality-constrained bundle adjustment (gauge fixed by constraints)
    ba, x_true = bundle_adjustment(n_cams=4, n_pts=24, device=device)
    stats = CaNNOLeSSolver(ba, method="gauss_newton", kkt="condensed").solve()
    err = np.abs(np.asarray(stats.solution) - x_true).max()
    print(f"bundle adjustment: {stats.status}, scene error {err:.2e}")


if __name__ == "__main__":
    main()
