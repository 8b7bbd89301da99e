"""The flagship batched solve as a callable, and a dry run of the three
mesh axes over n ranks.

Port of the JAX package's repo-root entry script (``entry()`` and
``dryrun_multichip(n)``).  ``entry()`` returns ``(fn, example_args)``: one
full batched solve of the flagship family (the bench family's Rosenbrock
residual with one linear constraint, ``method="lm"``, ``linsolve="ldlt"``,
float32, B = 8, ``max_iter=20``).  JAX jits ``fn``; here ``fn`` runs the
batch-native solver (``CaNNOLeSSolver.run``), on the card by default.

``dryrun_multichip(n)`` spawns n ranks (``parallel.launch``; gloo where
they share a card or run on the CPU) and runs, from the JAX script's numpy
draws (``default_rng(0)``):

* the batch axis: the flagship family at B = 2n (``max_iter=40``) through
  ``vsolve(mesh=)``, the solved count summed over the ranks, and the
  sharded x equal to the one-process x (``atol=1e-12``);
* the row axis: ``solve_row_sharded`` on the 16n-row exp fit
  (``max_iter=5``);
* the 2-D axis: nb = max(2, n // 4), nr = n // nb (``make_mesh_2d``),
  B2 = 2·nb exp-fit instances of m2 = 8·nr rows, Gauss–Newton, ``chol``,
  condensed, ``max_iter=20``: every instance solved.

It prints the JAX script's three lines and returns what it checked.

    python -m cannoles_tpu_torch.dryrun [--device cpu]      # entry() once
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def _flagship(dtype=torch.float32, device=None):
    from .core.solver import CaNNOLeSSolver
    from .problem import nls_problem

    def residual(x, d):
        return torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2) - d[1]])

    def cons(x, d):
        return torch.stack([x[0] + x[1] - d[2]])

    problem = nls_problem(
        residual, torch.tensor([-1.2, 1.0], dtype=dtype), 2, cons, [0.0], [0.0],
        data=torch.zeros((3,), dtype=dtype), name="flagship_lm_family", device=device,
    )
    return CaNNOLeSSolver(problem, method="lm", linsolve="ldlt", dtype=dtype)


def _flagship_batch(B, rng):
    """The JAX script's starts and data: x0 (B, 2), lam0 (B, 1), d (B, 3)."""
    x0s = rng.normal(scale=0.3, size=(B, 2)) + [-1.2, 1.0]
    return x0s, np.zeros((B, 1)), np.stack([np.ones(B), np.zeros(B), np.ones(B)], axis=1)


def entry(device=None):
    """``(fn, example_args)``: ``fn(x0s, lam0s, datas)`` is one full batched
    solve of the flagship family, returning ``(x, status, fx)``; the args
    are float32 tensors on ``device`` (default: the card)."""
    dtype = torch.float32
    solver = _flagship(dtype, device)
    dev = solver.device
    cfg = solver.make_config(max_iter=20)
    args = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                 for a in _flagship_batch(8, np.random.default_rng(0)))

    def fn(x0s, lam0s, datas):
        states = solver.run(x0s, lam0s, cfg, datas)
        return states.x, states.status, states.fx

    return fn, args


def _exp_fit(m, t, y, dtype, device, name):
    from .problem import nls_problem

    return nls_problem(
        lambda x, d: x[0] * torch.exp(-x[1] * d["t"]) - d["y"], torch.tensor([1.0, 0.0], dtype=dtype), m,
        data={"t": torch.as_tensor(t, dtype=dtype), "y": torch.as_tensor(y, dtype=dtype)}, name=name,
        device=device,
    )


def _solved(status) -> int:
    return int(((status == 1) | (status == 2)).sum())


def _dryrun_rank(n: int, device=None) -> dict:
    """One rank's part of :func:`dryrun_multichip` (every rank of n)."""
    from .parallel.batch import vsolve
    from .parallel.mesh import make_batch_mesh, make_mesh_2d, make_row_mesh
    from .parallel.multihost import batch_convergence_stats
    from .parallel.schur import solve_row_sharded

    dtype = torch.float32
    out = {}
    # --- axis 1: instance lanes over every rank --------------------------
    mesh = make_batch_mesh(device=device)
    solver = _flagship(dtype, mesh.device)
    B = 2 * n
    rng = np.random.default_rng(0)
    x0s, lam0s, datas = _flagship_batch(B, rng)
    res = vsolve(solver.problem, x0s, lam0s, datas, solver=solver, mesh=mesh, max_iter=40)
    out["dp"] = dict(x=res.solution, status=res.status,
                     solved=batch_convergence_stats(res.states, mesh)["solved"])
    # the one-process vmapped solve of the same batch, on this rank
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=solver.device)  # noqa: E731
    out["dp"]["ref"] = solver.run(t(x0s), t(lam0s), solver.make_config(max_iter=40), t(datas)).x.cpu().numpy()

    # --- axis 2: one problem's residual rows over every rank -------------
    m = 16 * n
    tt = np.linspace(0.0, 1.0, m)
    pb = _exp_fit(m, tt, 2.5 * np.exp(-1.3 * tt), dtype, mesh.device, "dryrun_rowsharded")
    stats = solve_row_sharded(pb, make_row_mesh(device=device), max_iter=5)
    out["rows"] = dict(status=stats.status, iter=stats.iter, x=stats.solution)

    # --- axis 3: lanes over 'batch', each lane's rows over 'rows' ---------
    nb = max(2, n // 4)
    nr = n // nb
    mesh2 = make_mesh_2d(nb, nr, device=device)  # every rank makes the groups
    B2, m2 = 2 * nb, 8 * nr
    t2 = np.tile(np.linspace(0.0, 1.0, m2), (B2, 1))
    amps = 1.5 + 0.5 * rng.random(B2)
    y2 = amps[:, None] * np.exp(-1.1 * t2)
    out["2d"] = dict(nb=nb, nr=nr, B=B2)
    if mesh2 is not None:
        from .core.solver import CaNNOLeSSolver

        pb2 = _exp_fit(m2, t2[0], y2[0], dtype, mesh2.device, "dryrun_2d")
        solver2 = CaNNOLeSSolver(pb2, method="gauss_newton", linsolve="chol", kkt="condensed", mesh=mesh2.rows)
        res2 = vsolve(pb2, np.tile([1.0, 0.0], (B2, 1)), np.zeros((B2, 0)), {"t": t2, "y": y2},
                      solver=solver2, mesh=mesh2, max_iter=20)
        out["2d"].update(status=res2.status, x=res2.solution, iter=res2.iterations,
                         nfact=res2.states.nfact.cpu().numpy(), solved=_solved(res2.status))
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three mesh axes over ``n_devices`` spawned ranks (see the module
    docstring), with the JAX script's asserts; prints its three lines and
    returns rank 0's results with the per-rank x of each axis.  ``device``:
    None for the card (ranks ``cuda:{r % count}``), ``"cpu"`` for the CPU."""
    from .parallel.launch import launch

    n = int(n_devices)
    if n < 2:
        raise ValueError(f"dryrun_multichip needs at least 2 ranks for its 2-D axis, got {n}")
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: dryrun_multichip runs on the card by default; pass device=\"cpu\"")
    ranks = launch(_dryrun_rank, n, n, None if device is None else str(device))
    r0 = ranks[0]
    B = 2 * n
    dp = r0["dp"]
    assert dp["x"].shape == (B, 2)
    assert dp["solved"] == B, f"only {dp['solved']}/{B} lanes solved"
    # sharded results must agree with the one-process solve (per-lane math
    # does not depend on the lanes beside it)
    np.testing.assert_allclose(dp["x"], dp["ref"], rtol=0, atol=1e-12)
    for r in ranks[1:]:
        assert np.array_equal(r["dp"]["x"], dp["x"]), "ranks disagree on the batch axis"
    print(f"dryrun_multichip({n}): dp ok, solved {dp['solved']}/{B}, sharded == single-device", flush=True)

    for r in ranks[1:]:
        assert r["rows"]["status"] == r0["rows"]["status"] and np.array_equal(r["rows"]["x"], r0["rows"]["x"]), \
            "ranks disagree on the row axis"
    print(f"dryrun_multichip({n}): rows ok, status={r0['rows']['status']}", flush=True)

    d2 = r0["2d"]
    nb, nr, B2 = d2["nb"], d2["nr"], d2["B"]
    assert d2["solved"] == B2, f"2-D mesh: only {d2['solved']}/{B2} solved"
    for r in ranks[1:nb * nr]:
        assert np.array_equal(r["2d"]["x"], d2["x"]), "ranks disagree on the 2-D mesh"
    print(f"dryrun_multichip({n}): 2-D mesh ({nb}x{nr}) ok, solved {d2['solved']}/{B2}", flush=True)
    return r0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = None if args.device == "cuda" else "cpu"
    fn, fargs = entry(device)
    out = fn(*fargs)
    print("entry ok:", tuple(tuple(o.shape) for o in out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
