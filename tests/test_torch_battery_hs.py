"""PyTorch port, the Hock–Schittkowski battery against the JAX package in
float64: all 16 problems with the configuration of ``tests/test_hs.py``
(newton, full KKT, ldlt).

Status, ``iter``, ``nfact``, ``nlinsolve`` and ``nbk`` equal and solutions
within 1e-8 relative to their scale, except for the knife edge named
below (ROADMAP.md queue 3), which must still agree on the status.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models import hs_suite as jhs  # noqa: E402
from cannoles_tpu_torch.models import hs_suite as ths  # noqa: E402
from test_torch_battery_mgh import assert_solve_parity  # noqa: E402

HS = {t.name: (j, t) for j, t in zip(jhs(), ths())}

# hs27 with the default configuration runs to max_eval (100,000 evaluations
# in both packages; tests/test_hs.py calls it HARD): with δ at its floor
# √eps the multiplier update λ ← λ − c/δ multiplies rounding by ~7e7, so
# the two trajectories part within the first 500 evaluations (max_eval=500:
# JAX iter 8, nfact 133, nlinsolve 50; the port 8, 139, 52).  Held here to
# the status under a budget of 2,000 evaluations; its documented repair,
# delta_min=1e-4, is held to every counter below.
HS_KNIFE_EDGES = {"hs27": ((8, 466, 182), (8, 529, 207))}


@pytest.mark.parametrize("name", sorted(HS))
def test_hs_solve_matches_jax(name):
    js, ts = HS[name]
    kw = dict(max_time=600.0, max_eval=2000) if name in HS_KNIFE_EDGES else dict(max_time=600.0)
    a = jc.CaNNOLeSSolver(js.make()).solve(**kw)
    b = tc.CaNNOLeSSolver(ts.make(device="cpu")).solve(**kw)
    assert_solve_parity(a, b, name, HS_KNIFE_EDGES)
    if name in HS_KNIFE_EDGES:
        assert b.status == "max_eval"
        fixed = [S(mk, delta_min=1e-4).solve(max_time=600.0)
                 for S, mk in ((jc.CaNNOLeSSolver, js.make()), (tc.CaNNOLeSSolver, ts.make(device="cpu")))]
        assert_solve_parity(*fixed, name, {})
        assert fixed[1].status == "first_order" and abs(2 * fixed[1].objective - ts.fstar) < 1e-6
        return
    assert b.status in ("first_order", "small_residual"), (name, b.status)
    assert b.primal_feas < 1e-6
