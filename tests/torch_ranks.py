"""Rank programs of the port's distributed tests (``test_torch_schur.py``,
``test_torch_multihost.py``, ``test_torch_matfree_solver.py``,
``test_torch_mesh2d.py``, ``test_torch_gpu.py``).

``cannoles_tpu_torch.parallel.launch`` runs each of these functions in k
spawned ranks, which import this module by name; it imports torch and numpy
only, never JAX (the test modules import JAX, so the ranks' code cannot live
there).  Each function builds its problem from numpy inputs that the tests
also hand to the JAX package, and returns plain picklable values.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

import cannoles_tpu_torch as tc
from cannoles_tpu_torch.core.solver import TENSOR_FIELDS
from cannoles_tpu_torch.models.families import bundle_adjustment
from cannoles_tpu_torch.parallel.mesh import make_batch_mesh, make_mesh_2d, make_row_mesh
from cannoles_tpu_torch.parallel.multihost import (
    batch_convergence_stats,
    global_batch_mesh,
    init_distributed,
    scaling_bench,
)
from cannoles_tpu_torch.parallel.schur import solve_row_sharded

CURVE_TRUE = np.array([2.0, 1.5, 1.0, 0.4, 0.5])


# ---- numpy inputs, shared with the JAX side of the tests ----
def curvefit_data(m: int):
    """``tests/test_schur.py``'s fit y = a1 e^(-b1 t) + a2 e^(-b2 t) + c,
    y evaluated in numpy."""
    t = np.linspace(0.0, 4.0, m)
    a1, b1, a2, b2, c = CURVE_TRUE
    return t, a1 * np.exp(-b1 * t) + a2 * np.exp(-b2 * t) + c


def constrained_data(m: int):
    t = np.linspace(0.0, 1.0, m)
    return t, 2.5 * np.exp(-1.3 * t)


def linear_rows_data(m: int = 4_096, n: int = 8, seed: int = 2):
    """``tests/test_matfree_solver.py``'s row-sharded least squares."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) / np.sqrt(n)
    x_true = rng.normal(size=n)
    return A, A @ x_true, x_true


def exp_fit_batch(B: int = 4, m: int = 32, seed: int = 0):
    """The 2-D mesh's batch (the dry run's axis 3): B exp fits y = a e^(-1.1 t)
    on m rows, a ~ U(1.5, 2)."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.linspace(0.0, 1.0, m), (B, 1))
    amps = 1.5 + 0.5 * rng.random(B)
    return t, amps[:, None] * np.exp(-1.1 * t)


def family_batch(B: int = 16, seed: int = 1):
    """``tests/test_batch.py``'s mesh batch: starts and data."""
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.2, size=(B, 2)) + np.array([-1.2, 1.0]), np.ones((B, 2))


# ---- the port's problems ----
def curvefit_problem(m: int, dtype=torch.float64, device="cpu"):
    t, y = curvefit_data(m)

    def residual(x, d):
        tt = d["t"]
        return x[0] * torch.exp(-x[1] * tt) + x[2] * torch.exp(-x[3] * tt) + x[4] - d["y"]

    data = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in (("t", t), ("y", y))}
    return tc.nls_problem(residual, [1.0, 1.0, 0.5, 0.1, 0.0], m, data=data, name="curvefit",
                          dtype=dtype, device=device)


def constrained_problem(m: int, device="cpu"):
    t, y = constrained_data(m)
    data = {"t": torch.as_tensor(t, device=device), "y": torch.as_tensor(y, device=device)}
    return tc.nls_problem(
        lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) - d["y"], [1.0, 0.0], m,
        lambda x, d: torch.stack([x[0] - 2 * x[1]]), [-0.1], [-0.1], data=data, device=device,
    )


# the centered fit runs to its small-residual stop, where x is fixed to
# ~1e-15 (at the default tolerances Gauss-Newton stops where the order of
# the row sums moves x by ~1e-10, as for the curve fit)
CENTERED_TOL = dict(atol=1e-12, rtol=0.0)


def centered_problem(m: int, device="cpu"):
    """``constrained_data``'s fit to y − mean(y): row i of F reads every
    row of y, so no rank's rows alone give its rows of F."""
    t, y = constrained_data(m)
    data = {"t": torch.as_tensor(t, device=device), "y": torch.as_tensor(y, device=device)}
    return tc.nls_problem(lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) + x[2] - (d["y"] - d["y"].mean()),
                          [1.0, 0.0, 0.0], m, data=data, name="centered", device=device)


def exp_fit_problem(m: int, kind: str = "fit", device="cpu"):
    """The exp fit of ``exp_fit_batch`` (its lane 0's data as the problem's
    own).  ``"centered"`` fits y − mean(y) with an offset, a residual whose
    row i reads every row of y; ``"constrained"`` adds x0 + x1 = mean(y), a
    constraint that reads every row of its lane's y."""
    t, y = exp_fit_batch(m=m)
    data = {"t": torch.as_tensor(t[0], device=device), "y": torch.as_tensor(y[0], device=device)}
    if kind == "centered":
        return tc.nls_problem(lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) + x[2] - (d["y"] - d["y"].mean()),
                              [1.0, 0.0, 0.0], m, data=data, name="centered_2d", device=device)
    cons = (lambda x, d: torch.stack([x[0] + x[1] - d["y"].mean()])) if kind == "constrained" else None
    return tc.nls_problem(lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) - d["y"], [1.0, 0.0], m, cons,
                          *([[0.0], [0.0]] if cons else []), data=data, name=f"exp_{kind}_2d", device=device)


# the centered fit runs on 4,096 rows to its small-residual stop, as in
# ``schur_cases`` (on 32 rows the order of the row sums moves its stop by
# an iteration in some lanes)
MESH2D_CASES = {  # name -> (problem kind, rows, vsolve keywords)
    "fit": ("fit", 32, dict(max_iter=20)),
    "centered": ("centered", 4096, dict(max_iter=20, **CENTERED_TOL)),
    "constrained": ("constrained", 32, dict(max_iter=50)),
    "rescued": ("fit", 32, dict(max_iter=2, rescue=True)),
}


def mesh2d_solve(mesh, case: str, B: int = 4, m=None, device="cpu"):
    """One case of ``MESH2D_CASES`` through ``vsolve`` (Gauss–Newton, chol,
    condensed) on ``mesh`` (a 2-D mesh, or None for the one-process solve):
    the whole result's fields as numpy."""
    kind, rows, kw = MESH2D_CASES[case]
    m = rows if m is None else m
    pb = exp_fit_problem(m, kind, device)
    t, y = exp_fit_batch(B, m)
    x0 = np.tile(pb.x0.cpu().numpy(), (B, 1))  # lam0: the problem's y0 on every lane
    solver = tc.CaNNOLeSSolver(pb, method="gauss_newton", linsolve="chol", kkt="condensed",
                               mesh=None if mesh is None else mesh.rows)
    res = tc.vsolve(pb, x0, data_batch={"t": t, "y": y}, solver=solver, mesh=mesh, **kw)
    return {f: getattr(res.states, f).cpu().numpy() for f in ("x", "status", "iter", "nfact", "nlinsolve")}


def mesh2d_cases(nb: int = 2, nr: int = 4, device="cpu"):
    """Every case of ``MESH2D_CASES`` on an nb × nr mesh, and the refusals
    of uneven B and m (their messages, None where nothing was raised)."""
    mesh = make_mesh_2d(nb, nr, device=device)
    out = {case: mesh2d_solve(mesh, case, device=device) for case in MESH2D_CASES}
    out["coords"] = (mesh.batch.rank, mesh.rows.rank, mesh.shape)
    for key, (B, m) in (("uneven_B", (3, 32)), ("uneven_m", (4, 31))):
        try:
            mesh2d_solve(mesh, "fit", B, m, device)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    return out


def family_problem(device="cpu"):
    """``tests/test_batch.py``'s ``_family``."""
    return tc.nls_problem(
        lambda x, d: torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
        lambda x, d: torch.stack([x[0] + x[1] - d[1]]), [0.0], [0.0],
        data=torch.zeros(2, dtype=torch.float64, device=device), name="family", device=device,
    )


def _stats(st):
    sp = st.solver_specific
    return dict(status=st.status, iter=st.iter, nfact=sp["nfact"], nlinsolve=sp["nlinsolve"],
                nbk=sp["nbk"], x=np.asarray(st.solution), lam=np.asarray(st.multipliers))


# ---- rank programs ----
def schur_cases(device: str = "cpu", group=None):
    """Every row-sharded problem of ``tests/test_schur.py`` and
    ``tests/test_families.py``, and m not divisible by the ranks, over
    ``group``'s ranks (default: all)."""
    mesh = make_row_mesh(group, device=device)
    out = {
        "curvefit": _stats(solve_row_sharded(curvefit_problem(8192, device=device), mesh,
                                             method="gauss_newton")),
        "constrained": _stats(solve_row_sharded(constrained_problem(4096, device=device), mesh)),
        "ba": _stats(solve_row_sharded(bundle_adjustment(n_cams=4, n_pts=16, noise=0.0, device=device)[0],
                                       mesh, method="gauss_newton")),
        "centered": _stats(solve_row_sharded(centered_problem(4096, device=device), mesh, method="gauss_newton",
                                             **CENTERED_TOL)),
    }
    try:
        solve_row_sharded(curvefit_problem(8191, device=device), mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def schur_by_size(sizes, device: str = "cpu"):
    """``schur_cases`` over the first k ranks for each k of ``sizes`` (the
    other ranks wait): {k: cases} on the ranks that took part."""
    out = {}
    for k in sizes:
        group = dist.new_group(list(range(k)))  # collective: every rank makes it
        if dist.get_rank() < k:
            out[k] = schur_cases(device, group)
        dist.barrier()
    return out


def matfree_rows(device: str = "cpu"):
    """The row-sharded ``MatrixFreeSolver`` on ``linear_rows_data``."""
    A, b, _ = linear_rows_data()
    data = {"A": torch.as_tensor(A, device=device), "b": torch.as_tensor(b, device=device)}
    pb = tc.nls_problem(lambda x, d: d["A"] @ x - d["b"], np.zeros(A.shape[1]), A.shape[0], data=data,
                        device=device)
    st = tc.MatrixFreeSolver(pb, mesh=make_row_mesh(device=device)).solve()
    return dict(_stats(st), ncg=st.solver_specific["ncg"])


STOP_BUDGET = 1.0  # s: rank 0's max_time in the "budget_in_step" case


def _sleep_past(budget):
    """A callback that, after outer step 1, sleeps until ``budget`` has
    passed since its first call (after the solve's first evaluation), so
    the budget runs out at the first host sync of step 2."""
    first = []

    def cb(problem, state, stats):
        if not first:
            first.append(time.time())
        elif stats.iter == 1:
            time.sleep(max(0.0, budget + 0.2 - (time.time() - first[0])))

    return cb


def _user_at(it):
    def cb(problem, state, stats):
        if stats.iter == it:
            stats.status = "user"

    return cb


def stop_cases():
    """Host decisions that one rank alone asks for, on a row mesh of every
    rank, for ``CaNNOLeSSolver(mesh=).solve()`` and
    ``MatrixFreeSolver(mesh=).solve()`` on the 1,024-row curve fit: rank 0's
    budget spent after step 1 ("budget") or inside step 2
    ("budget_in_step"), rank 1's callback stopping at step 1 ("user"), and
    rank 0 alone logging ("verbose").  Each must stop every rank at the same
    step (a rank that went on alone would wait in its next all-reduce)."""
    mesh = make_row_mesh(device="cpu")
    me = mesh.rank
    pb = curvefit_problem(1024)
    out = {}
    for engine, make in (("dense", lambda: tc.CaNNOLeSSolver(pb, method="gauss_newton", kkt="condensed", mesh=mesh)),
                         ("matfree", lambda: tc.MatrixFreeSolver(pb, mesh=mesh))):
        cases = {  # callbacks with state are made anew for each solve
            "budget": dict(max_time=0.0 if me == 0 else 1e9),
            "budget_in_step": dict(max_time=STOP_BUDGET if me == 0 else 1e9,
                                   callback=_sleep_past(STOP_BUDGET) if me == 0 else None),
            "user": dict(callback=_user_at(1) if me == 1 else None),
            "verbose": dict(verbose=1 if me == 0 else 0),
        }
        for case, kw in cases.items():
            out[engine, case] = _stats(make().solve(max_iter=4, **kw))
    return out


def backend_probe():
    """The launch group's backend, and its SUM of ones on the CPU and on
    this rank's card."""
    cpu = torch.ones(2)
    card = torch.ones(2, device=torch.cuda.current_device())
    dist.all_reduce(cpu)
    dist.all_reduce(card)
    return dict(backend=str(dist.get_backend()), cpu=cpu.tolist(), card=card.cpu().tolist())


def batch_cases():
    """``vsolve(mesh=...)`` on ``tests/test_batch.py``'s mesh batch, its
    convergence statistics, the refusals, and ``scaling_bench``."""
    init_distributed()  # the group is up: a no-op
    pb = family_problem()
    mesh = make_batch_mesh(device="cpu")
    x0, d = family_batch()
    res = tc.vsolve(pb, x0, data_batch=d, mesh=mesh, max_iter=100)
    out = {
        "states": {f: getattr(res.states, f).numpy() for f in TENSOR_FIELDS},
        "stats": batch_convergence_stats(res.states, mesh),
        "rescued": tc.vsolve(pb, x0, data_batch=d, mesh=mesh, max_iter=3, rescue=True).status,
        "global_mesh": (global_batch_mesh(device="cpu").size, mesh.size, mesh.rank),
    }
    for key, kw in (("uneven", dict(x0_batch=x0[:-1], data_batch=d[:-1])),
                    ("max_time", dict(x0_batch=x0, data_batch=d, max_time=1.0))):
        try:
            tc.vsolve(pb, mesh=mesh, **kw)
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    rng = np.random.default_rng(3)
    xs = rng.normal(scale=0.2, size=(8, 2)) + np.array([-1.2, 1.0])
    out["scaling"] = scaling_bench(pb, xs, data_batch=np.ones((8, 2)), device_counts=[2, 4], max_iter=50,
                                   reps=1, kkt="full", method="newton", device="cpu")
    return out
