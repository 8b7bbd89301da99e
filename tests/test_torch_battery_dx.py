"""PyTorch port, the battery's ill-conditioned rows against the JAX package
in float64 on the CPU: the uniform pass (``linsolve='ldlt'``, ``atol=0``,
``rtol=1e-5``, no time budget) of the problems that ``chip_smoke.py``
names in ``BATTERY_DX``, whose card and CPU solutions part by more than
1e-10.  Two implementations of the same steps on one CPU part by the same
order here, which shows that the exit leaves x that loosely determined.

Status equal; ``iter``, ``nfact``, ``nlinsolve`` equal except for the
knife edges named below (ROADMAP.md queue 3); the relative distance of
the solutions and of Σf² within the bars below, ten times the reading
of this test (printed with ``-s``).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
from cannoles_tpu_torch import CaNNOLeSSolver  # noqa: E402
from cannoles_tpu_torch import battery  # noqa: E402

# name -> (bar on max |x_port − x_jax| / max(1, max |x_jax|), bar on
# |Σf²_port − Σf²_jax| / max(1, Σf²_jax))
BARS = {
    "brown_almost_linear": (4e-2, 5.7e-6), "wood": (4.8e-8, 1.4e-9), "wood+linear": (7.9e-7, 1.3e-8),
    "watson_12": (7.6e-8, 1e-10), "linear_rank1_zero": (5.6e-9, 2.6e-10),
    "brown_almost_linear_25": (1.7e-8, 1e-10), "powell_badly_scaled": (6.5e-9, 3.2e-10),
    "meyer": (4.6e-9, 2.4e-8), "variably_dimensioned": (3e-9, 2.2e-9), "vardim_20": (3.6e-9, 1e-10),
    "linear_full_rank": (1.2e-9, 1e-10), "linear_full_rank_40_60": (5.7e-9, 1e-10),
    "ext_rosenbrock+linear": (1.2e-8, 1e-10), "variably_dimensioned+linear": (2.6e-9, 1e-10),
    "hs50": (1.1e-9, 1e-10),
}
# name -> (JAX (iter, nfact, nlinsolve), port's): the ρ = 0 inertia test
# of variably_dimensioned's second iteration (tests/test_torch_battery_mgh.py)
KNIFE_EDGES = {"variably_dimensioned": ((8, 15, 8), (8, 16, 8)), "vardim_20": ((8, 15, 8), (8, 16, 8))}



def _jax_items():
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "full_battery.py"
    spec = importlib.util.spec_from_file_location("full_battery_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {it[1]: it for it in mod.collect()}


JAX_ITEMS = _jax_items()
ITEMS = {it[1]: it for it in battery.collect()}


def _counters(st):
    return st.iter, st.solver_specific["nfact"], st.solver_specific["nlinsolve"]


@pytest.mark.parametrize("name", sorted(BARS))
def test_ill_conditioned_row_matches_jax(name):
    kw = dict(atol=0.0, rtol=1e-5, max_time=float("inf"))
    a = jc.CaNNOLeSSolver(JAX_ITEMS[name][2](), linsolve="ldlt").solve(**kw)
    pt = ITEMS[name][2](dtype=torch.float64, device="cpu")
    b = CaNNOLeSSolver(pt, linsolve="ldlt").solve(**kw)
    assert a.status == b.status == "first_order", (name, a.status, b.status)
    assert (_counters(a), _counters(b)) == KNIFE_EDGES.get(name, (_counters(a),) * 2), name
    xa = np.asarray(a.solution)
    dx = float(np.abs(np.asarray(b.solution) - xa).max() / max(1.0, np.abs(xa).max()))
    df = abs(2 * b.objective - 2 * a.objective) / max(1.0, 2 * a.objective)
    print(f"{name}: port vs JAX, relative |dx| {dx:.3e}, |dΣf²| {df:.3e}")
    bar_x, bar_f = BARS[name]
    assert dx <= bar_x and df <= bar_f, (name, dx, df)
