"""PyTorch port, the Lukšan–Vlček battery, constrained MGH rows of the
battery runner and the KKT oracle against the JAX package in float64:

* all 5 Lukšan–Vlček problems with the configuration of
  ``tests/test_lvcon.py`` (condensed KKT, rtol 1e-7), certified by the
  solver-independent KKT oracle in both packages;
* 4 constrained MGH rows of the battery (``sum(x) = 1`` attached) through
  the battery runner's uniform pass;
* the oracle's residuals themselves, at one point and for a batch, to
  1e-12 relative.

Status, ``iter``, ``nfact``, ``nlinsolve`` and ``nbk`` equal and solutions
within 1e-8 relative to their scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.models import constrained as jcon  # noqa: E402
from cannoles_tpu.models import lvcon_problem as jlv, mgh_problem as jmgh  # noqa: E402
from cannoles_tpu.utils.kkt import is_kkt_point as jis_kkt, kkt_residuals as jkkt  # noqa: E402
from cannoles_tpu_torch.battery import collect, solve_row  # noqa: E402
from cannoles_tpu_torch.models import LVCON_NAMES, lvcon_problem as tlv  # noqa: E402
from cannoles_tpu_torch.utils.kkt import is_kkt_point, kkt_residuals  # noqa: E402
from test_torch_battery_mgh import assert_solve_parity  # noqa: E402


@pytest.mark.parametrize("name", LVCON_NAMES)
def test_lvcon_solve_matches_jax_with_independent_certificate(name):
    kw = dict(method="newton", linsolve="ldlt", kkt="condensed", max_iter=200, rtol=1e-7,
              max_time=600.0)
    pj, pt = jlv(name), tlv(name, device="cpu")
    a, b = jc.cannoles(pj, **kw), tc.cannoles(pt, **kw)
    assert_solve_parity(a, b, name, {})
    assert b.status == "first_order"
    assert jis_kkt(pj, a.solution, a.multipliers, tol=1e-5)
    assert is_kkt_point(pt, b.solution, b.multipliers, tol=1e-5)


BATTERY_ROWS = ["rosenbrock+linear", "helical_valley+linear", "brown_almost_linear+linear",
                "chebyquad+linear"]


@pytest.mark.parametrize("name", BATTERY_ROWS)
def test_battery_constrained_mgh_row_matches_jax(name):
    """The runner's uniform pass (ldlt, eigh on exception, atol = 0,
    rtol = 1e-5) against the same sequence in the JAX package."""
    item = next(it for it in collect() if it[1] == name)
    row = solve_row(*item, dtype=torch.float64, device="cpu", max_time=600.0, rescue=False)
    pj = jcon(jmgh(name.split("+")[0]), "linear")
    a = jc.CaNNOLeSSolver(pj, linsolve="ldlt").solve(atol=0.0, rtol=1e-5, max_time=600.0)
    if a.status == "exception":
        a = jc.CaNNOLeSSolver(pj, linsolve="eigh").solve(atol=0.0, rtol=1e-5, max_time=600.0)
    assert (row["family"], row["nvar"], row["ncon"]) == ("mgh_con", pj.nvar, 1)
    assert row["status"] == a.status and row["solved_uniform"] and row["rescue"] is None
    assert (row["iter"], row["nfact"], row["nlinsolve"]) == (
        a.iter, a.solver_specific["nfact"], a.solver_specific["nlinsolve"])
    xa = np.asarray(a.solution)
    np.testing.assert_allclose(row["solution"], xa, rtol=0, atol=1e-8 * max(1.0, np.abs(xa).max()))


def test_kkt_oracle_matches_jax_one_point_and_batch():
    """The oracle's four residuals at x0 and at a seeded point, with seeded
    multipliers, for one point (as the JAX function) and for the batch."""
    pj, pt = jlv("lvcon_rosenbrock_trigexp"), tlv("lvcon_rosenbrock_trigexp", device="cpu")
    rng = np.random.default_rng(7)
    x = np.stack([np.asarray(pj.x0), np.asarray(pj.x0) + 0.1 * rng.normal(size=pj.nvar)])
    lam = rng.normal(size=(2, pj.ncon))
    batch = kkt_residuals(pt, x, lam)
    for i in range(2):
        ref = jkkt(pj, jnp.asarray(x[i]), jnp.asarray(lam[i]))
        one = kkt_residuals(pt, x[i], lam[i])
        for r, g, gb in zip(ref, one, batch):
            assert g.shape == () and gb.shape == (2,)
            np.testing.assert_allclose(float(g), float(r), rtol=1e-12)
            np.testing.assert_allclose(float(gb[i]), float(r), rtol=1e-12)


def test_kkt_oracle_rejects_non_solution():
    pt = tlv("lvcon_rosenbrock_trigexp", device="cpu")
    assert not is_kkt_point(pt, pt.x0, None, tol=1e-5)
    assert float(kkt_residuals(pt, pt.x0).feasibility) > 1.0  # x0 is infeasible
    st = tc.cannoles(pt, kkt="condensed", rtol=1e-7, max_iter=200)
    both = is_kkt_point(pt, np.stack([pt.x0.numpy(), st.solution]),
                        np.stack([np.zeros(pt.ncon), st.multipliers]), tol=1e-5)
    assert both.tolist() == [False, True]
    un = tc.models.mgh_problem("rosenbrock", device="cpu")
    assert float(kkt_residuals(un, [1.0, 1.0]).stationarity) == 0.0
