"""cannoles_tpu_torch — the batched CaNNOLeS solver in PyTorch, for NVIDIA H100.

A port of ``cannoles_tpu`` (the JAX/Pallas package beside it, which stays
the reference).  It imports torch and numpy, never JAX.  The solver is
batch-native: every state tensor has a leading batch axis, and a single
solve is the case B = 1.  The fused LDLᵀ factor+solve of every ρ-ladder
attempt (``linsolve='pallas'``) is a hand-written CUDA kernel
(``csrc/fused_ldlt.cu``), built with nvcc at first use on a CUDA tensor.
Problems too large for a dense Jacobian go through the matrix-free engines
(``MatrixFreeSolver``: CG on jvp/vjp products; ``SchurBASolver``: direct
camera-Schur elimination for bundle adjustment); ``save_state``/
``load_state`` and ``solve(resume_from=...)`` checkpoint and continue a
solve, in the JAX package's file format.

Problems and the model builders go to the card unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.  The
solver follows the problem's device.

Quick start (on the card)::

    import torch
    from cannoles_tpu_torch import nls_problem, cannoles

    nls = nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
                      [-1.2, 1.0], 2)
    stats = cannoles(nls)

On the CPU: ``nls_problem(..., device="cpu")``.

Mixed precision on the card (TF32, or a one-pass bf16 JᵀJ)::

    stats = CaNNOLeSSolver(nls, dtype=torch.float32, matmul_precision="bfloat16").solve()

Batched::

    from cannoles_tpu_torch import vsolve
    res = vsolve(nls, x0_batch, method="lm", linsolve="pallas")
"""

from .core.ba import SchurBASolver, ba_block_jacobi
from .core.matfree import MatrixFreeSolver, MFState, solve_matfree
from .core.solver import (
    AVAILABLE_LINSOLVE,
    AVAILABLE_METHODS,
    CaNNOLeSSolver,
    RunConfig,
    SolverState,
    cannoles,
)
from .core.status import ExecutionStats, Status, status_name
from .params import Params
from .parallel.batch import BatchResult, vsolve
from .parallel.multistart import multistart
from .problem import Counters, NLSProblem, nls_problem
from .utils.checkpoint import load_state, save_state
from .utils.profiling import stage_timings, trace

__version__ = "0.1.0"

__all__ = [
    "nls_problem",
    "cannoles",
    "CaNNOLeSSolver",
    "vsolve",
    "multistart",
    "Status",
    "ExecutionStats",
    "status_name",
    "SolverState",
    "RunConfig",
    "BatchResult",
    "Params",
    "NLSProblem",
    "Counters",
    "AVAILABLE_METHODS",
    "AVAILABLE_LINSOLVE",
    "MatrixFreeSolver",
    "MFState",
    "solve_matfree",
    "SchurBASolver",
    "ba_block_jacobi",
    "save_state",
    "load_state",
    "stage_timings",
    "trace",
]
