"""``brown_almost_linear+linear`` in float32 under the battery's rescue 1b
(``kkt='condensed', multiplier_refit=True``, atol = 0, rtol = 1e-5): a
float32 knife edge, not a fault of the port.

The JAX package ends ``first_order`` (iter 36, nfact 121) and the port
ends ``exception`` ("Dϕ ≥ 0", iter 35, nfact 130) on this CPU.  The
evidence, each point a test below:

* the logic agrees: from every float32 state of JAX's own trajectory up to
  outer iteration 28, one outer step of the port takes JAX's decisions
  (ρ-ladder rung, inner iterations, backtracks, refit, status) and lands
  within 128 ulp of JAX's x;
* the trajectories part by rounding: from identical inputs the first
  outer step already moves x by up to 120 ulp in both float32 and float64
  (498 ulp; ``brown_almost_linear``'s Jacobian is nearly rank-deficient),
  and in float64 the two packages end the same solve with every counter
  equal;
* the decision is not fixed by float32: from JAX's state 28, JAX itself
  takes 109 to 128 factorizations (one run 10,088) when one coordinate of
  x moves by one ulp; the port's step from the unmoved state (101) lies in
  that scatter.  The first outer iteration of the two whole runs whose
  decision differs is 25 (ρ 16.554153 in JAX, 132.43323 in the port),
  from states 24 that already differ by a median 4.2e6 ulp per coordinate
  of x (35 relative at most: one coordinate changed sign).

The float32 JAX runs need ``jax_enable_x64`` off, so they run in a child
process (this test process has it on).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cannoles_tpu_torch.battery import collect  # noqa: E402
from cannoles_tpu_torch.core.solver import CaNNOLeSSolver  # noqa: E402
from cannoles_tpu_torch.utils.convert import state_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "brown_almost_linear+linear"
TOL = dict(atol=0.0, rtol=1e-5)
# outer iterations whose step from JAX's state the port matches
AGREE = range(1, 29)
# the first step from JAX's states whose decision the port does not take;
# the child process also runs JAX's step there with x[j] moved one ulp
SPLIT_STEP = 29
X_ULP_BAR = 128

_CHILD = r"""
import json, sys
import numpy as np
from cannoles_tpu.utils.testing import force_cpu
force_cpu()
import jax
jax.config.update("jax_enable_x64", False)
import jax.numpy as jnp
from cannoles_tpu import CaNNOLeSSolver
from cannoles_tpu.core.solver import SolverState
from cannoles_tpu.models import constrained, mgh_problem
out = sys.argv[1]
pb = constrained(mgh_problem("brown_almost_linear"), "linear")
s = CaNNOLeSSolver(pb, kkt="condensed", multiplier_refit=True, matmul_precision="highest")
states = []
def cb(p, st, stats):
    states.append({k: np.asarray(v) for k, v in st._asdict().items() if k != "data"})
st = s.solve(atol=0.0, rtol=1e-5, max_time=1e9, callback=cb)
cfg = s.make_config(atol=0.0, rtol=1e-5)
moved = []
base = states[SPLIT - 1]
for j in range(pb.nvar):
    for d in (np.inf, -np.inf):
        f = dict(base)
        x = f["x"].copy()
        x[j] = np.nextafter(x[j], np.float32(d))
        f["x"] = x
        o = s._outer_fn(SolverState(**{k: jnp.asarray(v) for k, v in f.items()}, data=None), cfg)
        moved.append(int(o.nfact))
np.savez(out + ".npz", **{f"{i}__{k}": v for i, d in enumerate(states) for k, v in d.items()})
json.dump(dict(status=st.status, iter=st.iter, nfact=st.solver_specific["nfact"],
               nlinsolve=st.solver_specific["nlinsolve"], moved=moved), open(out + ".json", "w"))
""".replace("SPLIT", str(SPLIT_STEP))


@pytest.fixture(scope="module")
def jax_f32(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fault_a") / "jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _CHILD, out], check=True, env=env, cwd=str(ROOT), timeout=600)
    z = np.load(out + ".npz")
    n = 1 + max(int(k.split("__")[0]) for k in z.files)
    states = [{k.split("__")[1]: z[k] for k in z.files if k.startswith(f"{i}__")} for i in range(n)]
    return states, json.load(open(out + ".json"))


def _port_solver(dtype):
    make = next(it[2] for it in collect() if it[1] == NAME)
    pb = make(dtype=dtype, device="cpu")
    return pb, CaNNOLeSSolver(pb, kkt="condensed", multiplier_refit=True)


def _step(solver, fields):
    st = state_from_numpy(fields, device="cpu", dtype=torch.float32)
    return solver._outer_step(st, solver.make_config(**TOL), torch.ones(1, dtype=torch.bool))


def _ulp32(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_port_step_takes_jax_decisions_from_jax_states(jax_f32):
    states, _ = jax_f32
    _, s = _port_solver(torch.float32)
    for k in AGREE:
        out, ref = _step(s, states[k - 1]), states[k]
        for f in ("nfact", "nlinsolve", "nbk", "inner_iter", "status", "msg"):
            assert int(getattr(out, f)[0]) == int(ref[f]), (k, f)
        assert float(out.rho[0]) == float(ref["rho"]), k
        assert _ulp32(out.x[0].numpy(), ref["x"]) <= X_ULP_BAR, k


def test_split_decision_is_not_fixed_by_float32(jax_f32):
    """At step 29 one ulp in one coordinate of x moves JAX's own count of
    ρ-ladder attempts; the port's count from the unmoved state is inside
    the scatter."""
    states, summary = jax_f32
    ref = int(states[SPLIT_STEP]["nfact"])
    moved = summary["moved"]
    assert len(set(moved)) > 3 and any(m != ref for m in moved)
    _, s = _port_solver(torch.float32)
    got = int(_step(s, states[SPLIT_STEP - 1]).nfact[0])
    assert got != ref and min(moved + [ref]) - 10 <= got <= max(moved)


def test_whole_runs_pinned(jax_f32):
    """The recorded outcomes of the two float32 runs and the outer
    iteration where their decisions first part."""
    states, summary = jax_f32
    assert (summary["status"], summary["iter"], summary["nfact"]) == ("first_order", 36, 121)
    pb, s = _port_solver(torch.float32)
    mine = []
    st = s.solve(max_time=1e9, callback=lambda p, S, t: mine.append((int(S.nfact[0]), float(S.rho[0]))),
                 **TOL)
    assert (st.status, st.iter, st.solver_specific["nfact"]) == ("exception", 35, 130)
    first = next(k for k, (n, r) in enumerate(mine) if (n, r) != (int(states[k]["nfact"]), float(states[k]["rho"])))
    assert first == 25
    assert (mine[first][1], float(states[first]["rho"])) == (np.float32(132.43323), np.float32(16.554153))


def test_float64_rescue_1b_equals_jax():
    """In float64 the same solve ends alike in both packages: status and
    counters equal, Σf² to 1e-12 relative.  x only to 1e-6 of its scale: J
    is nearly rank-deficient, so x is fixed along its near-null direction
    to rounding over σ_min (the unconstrained row parts by 3.9e-3 between
    the packages, ``tests/test_torch_battery_dx.py``)."""
    from cannoles_tpu import CaNNOLeSSolver as JSolver
    from cannoles_tpu.models import constrained, mgh_problem

    pj = constrained(mgh_problem("brown_almost_linear"), "linear")
    a = JSolver(pj, kkt="condensed", multiplier_refit=True).solve(max_time=1e9, **TOL)
    _, s = _port_solver(torch.float64)
    b = s.solve(max_time=1e9, **TOL)
    assert (b.status, b.iter) == (a.status, a.iter) == ("first_order", 26)
    for k in ("nfact", "nlinsolve", "nbk"):
        assert b.solver_specific[k] == a.solver_specific[k], k
    xa = np.asarray(a.solution)
    np.testing.assert_allclose(b.solution, xa, rtol=0, atol=1e-6 * max(1.0, np.abs(xa).max()))
    assert abs(b.objective - a.objective) <= 1e-12 * a.objective
