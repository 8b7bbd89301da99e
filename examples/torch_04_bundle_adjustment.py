#!/usr/bin/env python
"""Bundle adjustment three ways with the PyTorch port: batched scenes,
camera-Schur, matrix-free.

The port's twin of examples/04_bundle_adjustment.py, at its sizes.  Runs on
the card by default; without one it raises.  On the CPU:

    python examples/torch_04_bundle_adjustment.py --cpu
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cannoles_tpu_torch import CaNNOLeSSolver, MatrixFreeSolver, SchurBASolver, ba_block_jacobi, vsolve  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment  # noqa: E402
from cannoles_tpu_torch.models.families import bundle_adjustment_batch  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
device = "cpu" if ap.parse_args().cpu else None  # None: the card, or raise

# ----------------------------------------------------------------------
# 1. A batch of small gauge-constrained scenes in one vsolve (the
#    instance-batch regime: thousands of independent solves per card)
# ----------------------------------------------------------------------
B = 8
pb, x0s, datas, x_true = bundle_adjustment_batch(B, n_cams=3, n_pts=16, device=device)
solver = CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", linsolve="pallas")
res = vsolve(pb, x0s, data_batch=datas, solver=solver, max_iter=40)
print("batched scenes:", res.summary())

# ----------------------------------------------------------------------
# 2. One large scene, camera-Schur direct elimination (production path):
#    frozen-gauge formulation, no (m, n) Jacobian ever materialized
# ----------------------------------------------------------------------
C, P = 10, 500
pb2, xt2 = large_bundle_adjustment(C, P, gauge="fixed", dtype=torch.float32, device=device)
st = SchurBASolver(
    pb2, C, P, frozen_cam_coords=pb2.data["gidx"].cpu().numpy()
).solve(atol=0.0, rtol=1e-5, max_iter=60)
print(
    f"schur {C}c/{P}p: {st.status} in {st.iter} iters, obj {st.objective:.2e}, "
    f"scene err {np.abs(np.asarray(st.solution, np.float64) - xt2).max():.2e}"
)

# ----------------------------------------------------------------------
# 3. Same scene through the generic matrix-free CG engine (no structure
#    assumptions: works for any large NLS, not just BA)
# ----------------------------------------------------------------------
st2 = MatrixFreeSolver(pb2, cg_maxiter=400).solve(atol=0.0, rtol=1e-5, max_iter=60)
print(f"matfree: {st2.status} in {st2.iter} iters, obj {st2.objective:.2e}")

# ----------------------------------------------------------------------
# 4. Gauge via equality CONSTRAINTS (exercises the constrained KKT
#    machinery): LM damping tames the transient along the near-gauge null
#    space, and the per-outer CGLS multiplier refit replaces the slow
#    first-order dual walk.
# ----------------------------------------------------------------------
pb3, xt3 = large_bundle_adjustment(C, P, gauge="constraints", dtype=torch.float32, device=device)
# small scenes have a SMALLER initial dual, so the rtol-derived target is
# tighter in absolute terms and float32 needs more iterations than the
# 100-camera / 10,000-landmark scene
st3 = SchurBASolver(pb3, C, P, method="lm", multiplier_refit=True).solve(
    atol=0.0, rtol=1e-5, max_iter=120
)
print(
    f"schur constrained: {st3.status} in {st3.iter} iters, "
    f"|c| {st3.primal_feas:.2e}, scene err "
    f"{np.abs(np.asarray(st3.solution, np.float64) - xt3).max():.2e}"
)

# the generic engine matches with the structure-aware block preconditioner
mf3 = MatrixFreeSolver(pb3, method="lm", multiplier_refit=True, precond=ba_block_jacobi(C, P))
st4 = mf3.solve(atol=0.0, rtol=1e-5, max_iter=120)
print(f"matfree constrained: {st4.status} in {st4.iter} iters")

# ----------------------------------------------------------------------
# 5. Continuation: the relative exit above is loose at scale (epstol =
#    rtol * |grad L0|), so polish by RESUMING with an absolute target;
#    explicit tolerances with resume_from re-target the run from the
#    current iterate, and plain Gauss-Newton drives the objective to the
#    float32 floor in a few more iterations.
# ----------------------------------------------------------------------
gn3 = MatrixFreeSolver(pb3, method="gauss_newton", multiplier_refit=True, precond=ba_block_jacobi(C, P))
st5 = gn3.solve(
    resume_from=mf3.last_state,
    atol=1e-6, rtol=0.0, Fatol=0.0, Frtol=0.0, max_iter=st4.iter + 100,
)
print(
    f"continuation: {st5.status} at iter {st5.iter}, obj {st5.objective:.2e}, "
    f"scene err {np.abs(np.asarray(st5.solution, np.float64) - xt3).max():.2e}"
)
