"""PyTorch port, ``matmul_precision`` against the JAX package on the CPU.

On the CPU every matmul is IEEE under every mode in both packages (XLA:CPU
ignores the precision, the port sets only the card's flags), so the modes
differ only in the quality gate's tolerance (``_gate_eps``), and the two
packages must agree under each: status, iter, nfact, nbk, nlinsolve and
internal_msg equal, float32 solutions within ``F32_DX`` and float64 ones
within 1e-12.  Also: the scoped flags (restored after a solve and after an
exception inside one, never written by a constructor), the pinned sites'
IEEE scope inside a reduced-precision solve, ``bf16_pass_reference``
against JAX's one-pass bf16 product, the rescue siblings and the battery's
rescue 1b.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu_torch import battery  # noqa: E402
from cannoles_tpu_torch.core.status import ExecutionStats  # noqa: E402
from cannoles_tpu_torch.utils import precision as tp  # noqa: E402

MODES = [None, "highest", "float32", "bfloat16", "tensorfloat32"]
# float32: the packages sum in other orders (XLA's fused multiply-adds, its
# reductions); 1e-5 is ~80 float32 ulps of the solutions' |x| ≤ 1.
F32_DX = 1e-5


def _rosen(dtype):
    """Rosenbrock + one linear constraint (tests/test_multiprecision.py)."""
    x0 = np.array([-1.2, 1.0])
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    pj = jc.nls_problem(lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
                        jnp.asarray(x0, jdt), 2, lambda x: jnp.array([jnp.sum(x) - 1]), [0.0], [0.0])
    pt = tc.nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), x0, 2,
                        lambda x: torch.stack([x.sum() - 1]), [0.0], [0.0], device="cpu", dtype=dtype)
    return pj, pt, {}


def _gn(dtype):
    """The 48×16 linear Gauss–Newton problem of
    tests/test_precision_trajectory.py (condensed, ``chol``, gate on)."""
    rng = np.random.default_rng(0)
    m, n = 48, 16
    npdt = np.float32 if dtype == torch.float32 else np.float64
    A = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(npdt)
    b = (A @ rng.normal(size=n).astype(npdt)).astype(npdt)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.as_tensor(A), torch.as_tensor(b)
    pj = jc.nls_problem(lambda x: Aj @ x - bj, jnp.zeros(n, A.dtype), m)
    pt = tc.nls_problem(lambda x: At @ x - bt, np.zeros(n), m, device="cpu", dtype=dtype)
    return pj, pt, dict(method="gauss_newton", kkt="condensed", linsolve="chol", quality_gate=True)


PROBLEMS = {"rosen_linear": _rosen, "gn_48x16": _gn}


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.float64


def _assert_same(a, b, dx):
    assert (b.status, b.iter) == (a.status, a.iter)
    for k in ("nfact", "nbk", "nlinsolve", "internal_msg"):
        assert b.solver_specific[k] == a.solver_specific[k], k
    np.testing.assert_allclose(b.solution, np.asarray(a.solution, np.float64), rtol=0, atol=dx)


@pytest.fixture
def flags():
    """The card's matmul flags as the test found them, restored after it."""
    m = torch.backends.cuda.matmul
    saved = (m.fp32_precision, m.allow_bf16_reduced_precision_reduction)
    yield m
    m.fp32_precision, m.allow_bf16_reduced_precision_reduction = saved


def test_validation_in_both():
    pj, pt, _ = _rosen(torch.float32)
    with pytest.raises(ValueError, match="matmul_precision"):
        jc.CaNNOLeSSolver(pj, matmul_precision="fp8")
    with pytest.raises(ValueError, match="matmul_precision"):
        tc.CaNNOLeSSolver(pt, matmul_precision="fp8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
def test_gate_eps_equals_jax(mode, dtype):
    pj, pt, _ = _rosen(dtype)
    a = jc.CaNNOLeSSolver(pj, dtype=_jdt(dtype), matmul_precision=mode)
    b = tc.CaNNOLeSSolver(pt, dtype=dtype, matmul_precision=mode)
    assert b._gate_eps == a._gate_eps == tp.gate_eps(mode, dtype)
    assert b.matmul_precision == a.matmul_precision == mode


@pytest.mark.parametrize("mode", [None, "highest", "tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_float32_solve_equals_jax(name, mode):
    pj, pt, kw = PROBLEMS[name](torch.float32)
    a = jc.CaNNOLeSSolver(pj, dtype=jnp.float32, matmul_precision=mode, **kw).solve()
    b = tc.CaNNOLeSSolver(pt, dtype=torch.float32, matmul_precision=mode, **kw).solve()
    assert b.status in ("first_order", "small_residual")
    _assert_same(a, b, F32_DX)


@pytest.mark.parametrize("mode", ["bfloat16", "tensorfloat32"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_float64_solve_equals_jax(name, mode):
    """float64 under a reduced mode: IEEE float64 arithmetic, the gate at
    the mode's tolerance; the round's float64 bar."""
    pj, pt, kw = PROBLEMS[name](torch.float64)
    a = jc.CaNNOLeSSolver(pj, dtype=jnp.float64, matmul_precision=mode, **kw).solve()
    b = tc.CaNNOLeSSolver(pt, dtype=torch.float64, matmul_precision=mode, **kw).solve()
    _assert_same(a, b, 1e-12)


def test_gate_booleans_equal_jax():
    """The unit gate case of tests/test_precision_trajectory.py: a solution
    with a 2e-3 relative error passes the bf16 gate and fails the float32
    one, in both packages."""
    rng = np.random.default_rng(0)
    rng.normal(size=(48, 16)), rng.normal(size=16)  # the problem's draws come first there
    W = np.eye(16) + 0.01 * rng.normal(size=(16, 16))
    W = (0.5 * (W + W.T) + 2 * np.eye(16)).astype(np.float32)
    sol = rng.normal(size=16).astype(np.float32)
    rhs = (W @ sol).astype(np.float32)
    noisy = (sol * (1 + 2e-3)).astype(np.float32)
    pj, pt, kw = _gn(torch.float32)
    for mode, want in (("bfloat16", True), (None, False)):
        a = jc.CaNNOLeSSolver(pj, dtype=jnp.float32, matmul_precision=mode, **kw)
        b = tc.CaNNOLeSSolver(pt, dtype=torch.float32, matmul_precision=mode, **kw)
        ja = bool(a._solve_quality_ok(jnp.asarray(W), jnp.asarray(noisy), jnp.asarray(rhs)))
        tb = bool(b._solve_quality_ok(*(torch.as_tensor(v)[None] for v in (W, noisy, rhs)))[0])
        assert ja == tb == want, mode


def test_vsolve_rescue_siblings_carry_the_mode():
    """vsolve under 'bfloat16' (tests/test_multiprecision.py): 4 clean lanes
    all solved in both packages; with a fifth, poisoned lane the rescue's
    siblings are built, and in both they keep the mode."""
    pj, pt, _ = _rosen(torch.float32)
    x0 = np.array([[-1.2, 1.0]] * 4 + [[np.nan, 1.0]], np.float32)
    sj = jc.CaNNOLeSSolver(pj, dtype=jnp.float32, matmul_precision="bfloat16")
    st = tc.CaNNOLeSSolver(pt, dtype=torch.float32, matmul_precision="bfloat16")
    rj = jc.vsolve(pj, jnp.asarray(x0[:4]), solver=sj, max_iter=100, rescue=True)
    rt = tc.vsolve(pt, x0[:4], solver=st, max_iter=100, rescue=True)
    assert rj.solved_mask().all() and rt.solved_mask().all()
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    rj = jc.vsolve(pj, jnp.asarray(x0), solver=sj, max_iter=100, rescue=True)
    rt = tc.vsolve(pt, x0, solver=st, max_iter=100, rescue=True)
    np.testing.assert_array_equal(rt.status, np.asarray(rj.status))
    kinds = sorted(st._rescue_siblings)
    assert kinds == sorted(sj._rescue_siblings) == ["eigh", "gated"]
    for k in kinds:
        assert st._rescue_siblings[k].matmul_precision == sj._rescue_siblings[k].matmul_precision == "bfloat16"


def test_reset_and_cannoles_carry_the_mode():
    _, pt, _ = _rosen(torch.float32)
    s = tc.CaNNOLeSSolver(pt, matmul_precision="tensorfloat32")
    assert s.reset(pt).matmul_precision == "tensorfloat32"
    seen = []
    st = tc.cannoles(pt, matmul_precision="bfloat16",
                     callback=lambda p, S, t: seen.append(torch.backends.cuda.matmul.fp32_precision))
    assert st.status == "first_order" and set(seen) == {"tf32"}


def test_bf16_pass_reference_against_jax():
    """Operands rounded to bf16 bit for bit as JAX rounds them; the product
    within 2·K·u·(|a|·|b|) of JAX's ``preferred_element_type=float32``
    product (exact products, float32 sums in another order)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 24, 200)).astype(np.float32)
    b = rng.normal(size=(3, 200, 24)).astype(np.float32)
    ja = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    ta = torch.as_tensor(a).bfloat16().float().numpy()
    assert np.array_equal(ja.view(np.int32), ta.view(np.int32))
    ref = np.asarray(jnp.matmul(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    got = tp.bf16_pass_reference(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32
    ab = torch.as_tensor(b).bfloat16().float().numpy()
    bound = 2 * 200 * 2.0**-24 * (np.abs(ta).astype(np.float64) @ np.abs(ab).astype(np.float64))
    assert (np.abs(got.numpy().astype(np.float64) - ref) <= bound).all()


@pytest.mark.parametrize("mode", MODES)
def test_critical_matmul_is_ieee_on_the_cpu(mode):
    """On the CPU the condensation's product is IEEE under every mode, as
    XLA:CPU's."""
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.normal(size=(2, 16, 48)).astype(np.float32))
    assert torch.equal(tp.critical_matmul(a, a.mT, mode), a @ a.mT)


def test_constructors_write_no_flags(flags):
    flags.fp32_precision = "tf32"
    flags.allow_bf16_reduced_precision_reduction = True
    _, pt, _ = _rosen(torch.float32)
    tc.CaNNOLeSSolver(pt)
    tc.MatrixFreeSolver(pt)
    assert (flags.fp32_precision, flags.allow_bf16_reduced_precision_reduction) == ("tf32", True)


@pytest.mark.parametrize("caller", ["none", "tf32", "ieee"])
@pytest.mark.parametrize("mode", MODES)
def test_scope_restores_the_callers_flags(flags, mode, caller):
    """Inside a solve the flag is the mode's (TF32 for the reduced modes,
    IEEE otherwise), and after it the caller's again; also after an
    exception raised inside the solve."""
    flags.fp32_precision = caller
    _, pt, _ = _rosen(torch.float32)
    s = tc.CaNNOLeSSolver(pt, matmul_precision=mode)
    inside = []
    s.solve(callback=lambda p, S, t: inside.append(flags.fp32_precision))
    assert set(inside) == {"tf32" if mode in ("bfloat16", "tensorfloat32") else "ieee"}
    assert flags.fp32_precision == caller and flags.allow_bf16_reduced_precision_reduction

    def boom(p, S, t):
        raise RuntimeError("callback failed")

    with pytest.raises(RuntimeError, match="callback failed"):
        s.solve(callback=boom)
    assert flags.fp32_precision == caller and flags.allow_bf16_reduced_precision_reduction


def test_run_and_matfree_scopes(flags):
    """``run`` (vsolve's and multistart's path) takes the mode's scope;
    ``MatrixFreeSolver.solve`` is IEEE; both restore the caller's flag."""
    flags.fp32_precision = "tf32"
    pj, pt, _ = _rosen(torch.float64)
    s = tc.CaNNOLeSSolver(pt, matmul_precision="highest")
    seen = []
    orig = s._outer  # one outer step of run(), on the run's bank
    s._outer = lambda *a: (seen.append(flags.fp32_precision), orig(*a))[1]
    tc.multistart(pt, n_starts=4, solver=s)
    assert set(seen) == {"ieee"} and flags.fp32_precision == "tf32"
    mf = tc.MatrixFreeSolver(pt)
    st = mf.solve(callback=lambda p, S, t: seen.append(("mf", flags.fp32_precision)))
    assert st.status == "first_order" and ("mf", "ieee") in seen and flags.fp32_precision == "tf32"


@pytest.mark.parametrize("mode", MODES)
def test_pinned_sites_run_ieee(flags, monkeypatch, mode):
    """Inside a solve the factorization attempts run in IEEE under every
    mode, and so does the gate residual inside the mode's scope."""
    from cannoles_tpu_torch.core import solver as sm

    _, pt, kw = _gn(torch.float32)
    s = tc.CaNNOLeSSolver(pt, dtype=torch.float32, matmul_precision=mode, **kw)
    seen = []
    orig = s._attempt_backend
    s._attempt_backend = lambda *a: (seen.append(flags.fp32_precision), orig(*a))[1]
    assert s.solve().status == "first_order"
    assert seen and set(seen) == {"ieee"}
    seen.clear()
    mv = sm._mv
    monkeypatch.setattr(sm, "_mv", lambda A, v: (seen.append(flags.fp32_precision), mv(A, v))[1])
    W = torch.eye(16)[None]
    with s._matmul_scope():
        s._gate_residual(W, torch.ones(1, 16), torch.ones(1, 16))
    assert seen == ["ieee"]


def test_battery_rescue_1b_uses_highest(monkeypatch):
    """Rescue 1b builds its solver with ``matmul_precision='highest'``, as
    ``benchmarks/full_battery.py:133`` does."""
    made = []

    class Fake:
        host_syncs = 0

        def __init__(self, pb, **kw):
            made.append(kw)
            self.kw = kw

        def solve(self, **_):
            st = ExecutionStats()
            st.status = "first_order" if self.kw.get("kkt") == "condensed" else "max_iter"
            st.objective, st.iter, st.solution = 0.0, 1, np.zeros(2)
            return st

    monkeypatch.setattr(battery, "CaNNOLeSSolver", Fake)
    _, pt, _ = _rosen(torch.float64)
    row = battery.solve_row("test", "rosen", lambda dtype, device: pt, None)
    assert row["rescue"] == "condensed_refit"
    assert made[-1] == dict(kkt="condensed", multiplier_refit=True, matmul_precision="highest")
    assert all("matmul_precision" not in kw for kw in made[:-1])


def test_top_level_exports_match_jax():
    assert tc.AVAILABLE_METHODS == jc.AVAILABLE_METHODS
    assert tc.AVAILABLE_LINSOLVE == jc.AVAILABLE_LINSOLVE
    assert {f for f in vars(tc.Counters())} == {f for f in vars(jc.Counters())}
