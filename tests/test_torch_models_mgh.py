"""PyTorch port, the 55 specs of ``models/mgh.py`` (the 35 standard
problems and the 20 extended variants) against the JAX package in float64,
through ``test_torch_models.check_builder``: F, Jᵀ, Jc, ``hess_res`` and
``hess_cons`` at x0 and at a seeded point, to 1e-12 relative to the
largest entry of each array."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu.models as jm  # noqa: E402
import cannoles_tpu_torch.models as tm  # noqa: E402
from test_torch_models import CPU, check_builder  # noqa: E402

SPECS = {t.name: (j, t) for j, t in zip(jm.mgh_suite(extended=True), tm.mgh_suite(extended=True))}


@pytest.mark.parametrize("name", list(SPECS))
def test_mgh_spec_matches_jax(name):
    js, ts = SPECS[name]
    assert js.name == ts.name and js.fmin == ts.fmin
    check_builder(f"mgh:{name}", js.make, lambda: ts.make(**CPU))


def test_all_55_specs():
    assert len(SPECS) == 55 and len(tm.MGH_NAMES) == 35
