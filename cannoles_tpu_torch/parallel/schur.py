"""Row-block parallelism for one large NLS problem (BASELINE config 4).

Port of ``cannoles_tpu/parallel/schur.py``.  The residual rows are split
over the ranks of a row mesh; each rank holds its (m/k, n) block of J and the
replicated condensed (n+p)² system, and the solver all-reduces the m-sized
contractions JᵀJ, Jᵀ rhs and the sums and maxima over the rows (see
``core/solver.py``).  The JAX package gets the same all-reduces from GSPMD;
here each is an explicit collective, and every rank runs the same program
on its rows (SPMD, one process per rank, e.g. through ``parallel.launch``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.solver import CaNNOLeSSolver, _add_batch_axis
from ..core.status import ExecutionStats, status_name
from ..problem import NLSProblem
from ..utils.linalg import norm_2
from .mesh import Mesh, make_row_mesh

__all__ = ["make_row_mesh", "solve_row_sharded"]


def solve_row_sharded(
    problem: NLSProblem,
    mesh: Optional[Mesh] = None,
    *,
    x0=None,
    lam0=None,
    solver: Optional[CaNNOLeSSolver] = None,
    method: str = "gauss_newton",
    linsolve: str = "chol",
    max_iter: int = 200,
    **numeric,
) -> ExecutionStats:
    """Solve ONE large problem with its residual rows split over ``mesh``
    (default: ``make_row_mesh()`` over every rank).  Every rank of the mesh
    calls it with the whole problem and gets the same stats.

    ``problem.data`` leaves whose leading axis is ``nequ`` are split; the
    others stay whole.  m must divide evenly over the ranks.  A ``solver``
    must use the condensed KKT system; one built without the mesh is
    rebuilt with it, with the same options."""
    problem.validate_for_solve()
    if problem.data is None:
        raise ValueError(
            "row-sharded solve needs per-residual `data` (leading axis = nequ) "
            "to define the row partition"
        )
    mesh = mesh or make_row_mesh()
    if solver is None:
        solver = CaNNOLeSSolver(problem, method=method, linsolve=linsolve, kkt="condensed", mesh=mesh)
    elif solver.kkt != "condensed":
        raise ValueError("row-sharded solve requires the condensed KKT backend")
    elif solver.mesh != mesh:
        solver = solver._rebuilt(problem, mesh)
    dev, dt = solver.device, solver.dtype
    x0 = torch.as_tensor(problem.x0 if x0 is None else x0).to(dtype=dt, device=dev).reshape(1, -1)
    lam0 = torch.as_tensor(problem.y0 if lam0 is None else lam0).to(dtype=dt, device=dev).reshape(1, -1)
    cfg = solver.make_config(max_iter=max_iter, **numeric)
    state = solver.run(x0, lam0, cfg, _add_batch_axis(solver.problem.data, dev))

    stats = ExecutionStats()
    stats.status = status_name(int(state.status[0]))
    stats.iter = int(state.iter[0])
    stats.objective = float(state.fx[0])
    stats.dual_feas = float(state.normdual[0])
    stats.primal_feas = float(norm_2(state.cx)[0])
    stats.solution = state.x[0].cpu().numpy()
    stats.multipliers = state.lam[0].cpu().numpy()
    stats.solver_specific.update(
        nfact=int(state.nfact[0]), nlinsolve=int(state.nlinsolve[0]), nbk=int(state.nbk[0])
    )
    return stats
