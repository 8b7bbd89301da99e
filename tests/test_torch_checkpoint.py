"""PyTorch port, checkpoints, ``solve(resume_from=...)`` and profiling
against the JAX package in float64 on the CPU.

* the 5 tests of ``tests/test_aux.py`` (the JAX package's in-graph
  ``debug_print`` has no counterpart: its test becomes the port's
  ``verbose`` log);
* the old-``Jx`` migration of ``tests/test_round5.py:130``;
* checkpoints across the packages: a JAX dense state and a JAX ``MFState``
  saved at iteration k resume in the port and finish on JAX's
  straight-through trajectory (status and counters equal, solution within
  1e-10 of its scale); a port checkpoint resumes in the JAX package;
* ``trace`` writes a Chrome trace.

A resume in one package is bit for bit its straight-through solve.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import cannoles_tpu as jc  # noqa: E402
import cannoles_tpu_torch as tc  # noqa: E402
from cannoles_tpu.core.ba import SchurBASolver as JSchur  # noqa: E402
from cannoles_tpu.models.ba_large import large_bundle_adjustment as jscene  # noqa: E402
from cannoles_tpu.utils.checkpoint import load_state as jload  # noqa: E402
from cannoles_tpu.utils.checkpoint import save_state as jsave  # noqa: E402
from cannoles_tpu_torch.models.ba_large import large_bundle_adjustment as tscene  # noqa: E402
from cannoles_tpu_torch.utils.checkpoint import load_state, save_state  # noqa: E402
from cannoles_tpu_torch.utils.profiling import stage_timings, trace  # noqa: E402

SOL_TOL = 1e-10
COUNTERS = ("nfact", "nlinsolve", "nbk")


def _problem(mod):
    if mod == "jax":
        return jc.nls_problem(lambda x: jnp.array([x[0] - 1, 10 * (x[1] - x[0] ** 2)]),
                              jnp.array([-1.2, 1.0]), 2, lambda x: jnp.array([x[0] + x[1] - 1]),
                              [0.0], [0.0])
    return tc.nls_problem(lambda x: torch.stack([x[0] - 1, 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                          lambda x: (x[0] + x[1] - 1).reshape(1), [0.0], [0.0], device="cpu")


def _data_problem(mod):
    if mod == "jax":
        return jc.nls_problem(lambda x, d: jnp.array([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]),
                              jnp.array([-1.2, 1.0]), 2, data=jnp.array([2.0]))
    return tc.nls_problem(lambda x, d: torch.stack([x[0] - d[0], 10 * (x[1] - x[0] ** 2)]), [-1.2, 1.0], 2,
                          data=torch.tensor([2.0], dtype=torch.float64), device="cpu")


def _tall(mod):
    A = np.random.default_rng(0).normal(size=(62, 2))
    y = A @ np.array([1.0, -2.0])
    if mod == "jax":
        return jc.nls_problem(lambda x, d: jnp.asarray(A) @ x - jnp.asarray(y), jnp.zeros(2), 62, name="tall")
    At, yt = torch.as_tensor(A), torch.as_tensor(y)
    return tc.nls_problem(lambda x: At @ x - yt, np.zeros(2), 62, name="tall", device="cpu")


def assert_parity(a, b, keys=COUNTERS):
    assert (b.status, b.iter) == (a.status, a.iter)
    for k in keys:
        assert b.solver_specific[k] == a.solver_specific[k], k
    xa = np.asarray(a.solution)
    np.testing.assert_allclose(b.solution, xa, rtol=0, atol=SOL_TOL * max(1.0, np.abs(xa).max()))


def test_checkpoint_roundtrip(tmp_path):
    solver = tc.CaNNOLeSSolver(_problem("torch"))
    stats1 = solver.solve(max_iter=2)
    assert stats1.status == "max_iter"
    ckpt = tmp_path / "state.npz"
    save_state(ckpt, solver.last_state)
    restored = load_state(ckpt, device="cpu")
    for name in tc.SolverState._fields[:-1]:
        assert torch.equal(getattr(restored, name), getattr(solver.last_state, name)), name
    stats2 = solver.solve(resume_from=restored)
    assert stats2.status == "first_order"
    assert np.allclose(stats2.solution, [0.6188, 0.3812], atol=1e-4)
    straight = tc.CaNNOLeSSolver(_problem("torch")).solve()
    assert stats2.iter == straight.iter
    assert np.array_equal(stats2.solution, straight.solution)
    assert_parity(jc.CaNNOLeSSolver(_problem("jax")).solve(), straight)


def test_checkpoint_with_data(tmp_path):
    pb = _data_problem("torch")
    solver = tc.CaNNOLeSSolver(pb)
    solver.solve(max_iter=1)
    ckpt = tmp_path / "s.npz"
    save_state(ckpt, solver.last_state)
    restored = load_state(ckpt, data_template=pb.data, device="cpu")
    assert restored.data.shape == (1, 1) and float(restored.data[0, 0]) == 2.0
    stats = solver.solve(resume_from=restored)
    assert stats.status == "first_order"
    assert np.allclose(stats.solution, [2.0, 4.0], atol=1e-6)
    assert_parity(jc.CaNNOLeSSolver(_data_problem("jax")).solve(), stats)


def test_stage_timings():
    t = stage_timings(tc.CaNNOLeSSolver(_problem("torch")), reps=2)
    assert set(t) == {"init", "outer_step", "newton_system"}
    assert all(v > 0 for v in t.values())
    t = stage_timings(tc.CaNNOLeSSolver(_tall("torch"), method="gauss_newton", kkt="condensed"), reps=2)
    assert set(t) == {"init", "outer_step", "newton_system"}
    assert all(v > 0 for v in t.values())


def test_verbose_log(capfd):
    """The counterpart of the JAX package's debug_print test: the log rows."""
    stats = tc.CaNNOLeSSolver(_problem("torch")).solve(verbose=1)
    assert stats.status == "first_order"
    out = capfd.readouterr().out
    assert "‖∇L‖" in out and "iter" in out and len(out.splitlines()) == stats.iter + 2


def test_checkpoint_mfstate_roundtrip(tmp_path):
    """An MFState saved mid-run (SchurBASolver, 3×12 scene) and resumed
    equals the straight-through solve bit for bit, as in the JAX package."""
    pt, _ = tscene(3, 12, noise=0.0, seed=0, dtype=torch.float64, device="cpu")
    tol = dict(atol=1e-14, rtol=0.0)
    solver = tc.SchurBASolver(pt, 3, 12)
    stats1 = solver.solve(max_iter=2, **tol)
    assert stats1.status == "max_iter"
    ckpt = tmp_path / "mf.npz"
    save_state(ckpt, solver.last_state)
    restored = load_state(ckpt, data_template=pt.data, device="cpu")
    assert type(restored).__name__ == "MFState"
    for name in tc.MFState._fields[:-1]:
        assert torch.equal(getattr(restored, name), getattr(solver.last_state, name)), name
    for k in pt.data:
        assert torch.equal(restored.data[k], solver.last_state.data[k]), k
    stats2 = solver.solve(resume_from=restored, **tol)
    straight = tc.SchurBASolver(pt, 3, 12).solve(**tol)
    assert (stats2.status, stats2.iter) == (straight.status, straight.iter)
    assert np.array_equal(stats2.solution, straight.solution)


def test_checkpoint_jx_migration(tmp_path):
    """A file with the old dense-Jacobian field Jx (m, n) loads as JxT."""
    pb = _tall("torch")
    s = tc.CaNNOLeSSolver(pb, method="gauss_newton", kkt="full")
    cfg = s.make_config()
    state = s._init_state(pb.x0[None], pb.y0[None], cfg, None)
    path = tmp_path / "new.npz"
    save_state(path, state)
    with np.load(path, allow_pickle=False) as z:
        leaves = {k: z[k] for k in z.files}
    meta = json.loads(str(leaves.pop("__meta__")))
    meta["fields"] = ["Jx" if f == "JxT" else f for f in meta["fields"]]
    leaves["Jx"] = np.swapaxes(leaves.pop("JxT"), -2, -1)
    old_path = tmp_path / "old.npz"
    np.savez(old_path, __meta__=json.dumps(meta), **leaves)
    loaded = load_state(old_path, device="cpu")
    assert torch.equal(loaded.JxT, state.JxT)
    st = s.solve(resume_from=loaded, max_time=60.0)
    assert st.status in ("first_order", "small_residual"), st.status
    # the same file through the JAX package
    assert np.array_equal(np.asarray(jload(old_path).JxT), state.JxT[0].numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_jax_dense_checkpoint_resumes_in_port(tmp_path, k):
    """JAX stops at iteration k and saves; the port resumes from the file
    and finishes on JAX's straight-through trajectory."""
    pj, pt = _problem("jax"), _problem("torch")
    js = jc.CaNNOLeSSolver(pj)
    js.solve(max_iter=k)
    jsave(tmp_path / "j.npz", js.last_state)
    straight = jc.CaNNOLeSSolver(pj).solve()
    b = tc.CaNNOLeSSolver(pt).solve(resume_from=load_state(tmp_path / "j.npz", device="cpu"))
    assert_parity(straight, b)


def test_jax_mfstate_checkpoint_resumes_in_port(tmp_path):
    pj, _ = jscene(3, 12, noise=0.0, seed=0, dtype=jnp.float64)
    pt, _ = tscene(3, 12, noise=0.0, seed=0, dtype=torch.float64, device="cpu")
    tol = dict(atol=1e-14, rtol=0.0)
    js = JSchur(pj, 3, 12)
    js.solve(max_iter=2, **tol)
    jsave(tmp_path / "jmf.npz", js.last_state)
    straight = JSchur(pj, 3, 12).solve(**tol)
    loaded = load_state(tmp_path / "jmf.npz", data_template=pt.data, device="cpu")
    assert type(loaded).__name__ == "MFState" and loaded.x.shape == (1, pt.nvar)
    b = tc.SchurBASolver(pt, 3, 12).solve(resume_from=loaded, **tol)
    assert_parity(straight, b, keys=("nfact", "ncg", "nlinsolve", "nbk"))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port saves its B = 1 state without the batch axis; the JAX
    package loads it and finishes on its own trajectory's counters."""
    pj, pt = _problem("jax"), _problem("torch")
    ts = tc.CaNNOLeSSolver(pt)
    ts.solve(max_iter=2)
    save_state(tmp_path / "t.npz", ts.last_state)
    loaded = jload(tmp_path / "t.npz")
    assert loaded.x.shape == (pj.nvar,) and loaded.iter.shape == ()
    a = jc.CaNNOLeSSolver(pj).solve(resume_from=loaded)
    assert_parity(jc.CaNNOLeSSolver(pj).solve(), a)


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        tc.CaNNOLeSSolver(_problem("torch")).solve()
    doc = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert doc["traceEvents"]
