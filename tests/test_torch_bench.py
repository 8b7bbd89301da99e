"""PyTorch port, ``cannoles_tpu_torch.bench`` against the repo-root
``bench.py`` (the JAX script, loaded as ``tests/test_scripts.py`` loads
it), in float64 on the CPU.

* ``flop_model`` equals the JAX script's on a grid of arguments.
* ``run_config`` at B = 8 (no chunk) and B = 64 (chunks of 16) with
  ``linsolve="ldlt"``, reps 1: the draws each function hands to ``vsolve``
  are bit-equal, the ``summary()`` counts and the failure breakdown before
  the rescue are equal, and the final runs agree lane by lane (status,
  ``iter``, ``nfact``, ``nlinsolve`` equal; solutions within 1e-10).
* The BA rung at 8 scenes and the large rung at 512×64, against the JAX
  package's ``CaNNOLeSSolver`` with the JAX script's settings: status and
  counters equal, solutions within 1e-10, the large rung's error equal
  within 1e-10.  (The JAX script hard-codes B = 256 and 8192×1024, so the
  JAX side is built here at the small shapes.  Its BA rung runs
  ``linsolve="ldlt"``, the Pallas kernel's plain reference: the Pallas
  kernel in interpret mode takes minutes at N = 73 on the CPU, and the two
  agree on every counter there.)
* ``main(["--device", "cpu", ...])``: its last stdout line parses, with
  exactly the JAX line's keys plus ``backend``, ``device_name`` and
  ``power_limit``; on the CPU the device keys are null.
* The module imports nothing of JAX or ``cannoles_tpu``; without a card and
  without ``--device cpu`` it raises.
"""

import importlib.util
import itertools
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cannoles_tpu.parallel.batch as jbatch  # noqa: E402
import cannoles_tpu_torch.parallel.batch as tbatch  # noqa: E402
from cannoles_tpu_torch import bench as tb  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-10


@pytest.fixture(scope="module")
def jb():
    spec = importlib.util.spec_from_file_location("bench_torch_parity", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(monkeypatch, module):
    """Replace ``module.vsolve`` by a wrapper that keeps each call's
    (x0_batch, data_batch, result)."""
    calls = []
    orig = module.vsolve

    def vsolve(problem, x0_batch, *a, **kw):
        r = orig(problem, x0_batch, *a, **kw)
        calls.append((np.asarray(x0_batch), np.asarray(kw["data_batch"]), r))
        return r

    monkeypatch.setattr(module, "vsolve", vsolve)
    return calls


def _lanes_equal(t_states, j_states):
    for f in ("status", "iter", "nfact", "nlinsolve"):
        np.testing.assert_array_equal(getattr(t_states, f).cpu().numpy(), np.asarray(getattr(j_states, f)), err_msg=f)
    np.testing.assert_allclose(t_states.x.cpu().numpy(), np.asarray(j_states.x), rtol=0, atol=TOL)


def test_flop_model_equals_jax(jb):
    grid = itertools.product((2, 66, 1024), (2, 96, 8192), (0, 1, 7), ("full", "condensed"), (0, 1, 13),
                             (0, 2, 29), (0, 192, 4 * 8192 * 1024))
    for n, m, p, kkt, nl, nf, rf in grid:
        kw = dict(n=n, m=m, p=p, kkt=kkt, nlinsolve=nl, nfact=nf, residual_flops=rf)
        assert tb.flop_model(**kw) == jb.flop_model(**kw), kw


@pytest.mark.parametrize("B,chunk", [(8, None), (64, 16)])
def test_run_config_matches_jax(jb, monkeypatch, B, chunk):
    from cannoles_tpu_torch.models.families import lm_bench_family

    jcalls, tcalls = _recording(monkeypatch, jbatch), _recording(monkeypatch, tbatch)
    jv, jsumm, jdt = jb.run_config(jb.build_problem(jnp.float64), "ldlt", B, chunk, jnp.float64, reps=1)
    tv, tsumm, tdt = tb.run_config(lm_bench_family(torch.float64, "cpu"), "ldlt", B, chunk, torch.float64, reps=1)
    assert tv > 0 and tdt > 0 and tv == pytest.approx(B / tdt)
    assert tsumm == {**jsumm, "mean_iter": tsumm["mean_iter"]} and tsumm["mean_iter"] == pytest.approx(jsumm["mean_iter"])
    assert tsumm["breakdown_pre_rescue"] == jsumm["breakdown_pre_rescue"]
    assert len(tcalls) == len(jcalls) == 3  # pre-rescue, warm, one timed run
    for (tx, td, tr), (jx, jd, jr) in zip(tcalls, jcalls):
        assert np.array_equal(tx, jx) and np.array_equal(td, jd)  # the draws, bit for bit
        _lanes_equal(tr.states, jr.states)


def test_ba_rung_matches_jax(monkeypatch):
    from cannoles_tpu import CaNNOLeSSolver
    from cannoles_tpu.models.families import bundle_adjustment_batch

    scenes = 8
    tcalls = _recording(monkeypatch, tbatch)
    sps, sps_dev, solved, mfu, dt = tb.run_ba_rung(reps=1, device="cpu", scenes=scenes, dtype=torch.float64)
    assert sps == pytest.approx(scenes / dt) and sps_dev is None and mfu is None
    pb, x0s, datas, _ = bundle_adjustment_batch(scenes, *tb.BA_SHAPE[1:], dtype=jnp.float64)
    s = CaNNOLeSSolver(pb, **{**tb.BA_SOLVER, "linsolve": "ldlt"}, dtype=jnp.float64)
    jr = jbatch.vsolve(pb, x0s, data_batch=datas, solver=s, max_iter=tb.BA_MAX_ITER)
    assert solved == f"{jr.summary()['solved']}/{scenes}"
    assert len(tcalls) == 2  # one warm-up, one timed run (no profiled run on the CPU)
    for tx, td, tr in tcalls:
        assert np.array_equal(tx, np.asarray(x0s))
        _lanes_equal(tr.states, jr.states)


def test_large_rung_matches_jax(monkeypatch):
    import jax

    from cannoles_tpu import CaNNOLeSSolver, nls_problem

    m, n = 512, 64
    states = []
    orig = tb._large_solve
    monkeypatch.setattr(tb, "_large_solve", lambda pb, s: states.append(orig(pb, s)) or states[-1])
    ms, ms_dev, ms_bf16, mfu, status, err = tb.run_large_rung("cpu", m, n, torch.float64, reps=1)
    assert ms > 0 and ms_dev is None and ms_bf16 is None and mfu is None

    # the JAX script's problem and solver (bench.py:run_large_rung) at m x n
    rng = np.random.default_rng(0)
    B1 = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n))
    B2 = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n))
    xtrue = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def model(x, d):
        return d["B1"] @ x + 0.1 * jnp.sin(d["B2"] @ x)

    data = {"B1": B1, "B2": B2}
    data["y"] = model(xtrue, data)
    pb = nls_problem(lambda x, d: model(x, d) - d["y"], jnp.zeros(n, jnp.float64), m, data=data)
    s = CaNNOLeSSolver(pb, **tb.LARGE_SOLVER, dtype=jnp.float64)
    st = s._run_fn(pb.x0, pb.y0, s.make_config(max_iter=tb.LARGE_MAX_ITER), pb.data)
    jax.block_until_ready(st.x)
    jerr = float(jnp.max(jnp.abs(st.x - xtrue)))

    assert status == int(st.status) == 1
    assert abs(err - jerr) <= TOL
    assert len(states) == 2  # one warm-up, one timed solve
    for t in states:
        for f in ("status", "iter", "nfact", "nlinsolve"):
            assert int(getattr(t, f)[0]) == int(getattr(st, f)), f
        np.testing.assert_allclose(t.x[0].numpy(), np.asarray(st.x), rtol=0, atol=TOL)


EXTRA_KEYS = {
    # bench.py:415-475
    "ba_scenes_per_s", "ba_scenes_per_s_device", "ba_solved", "ba_mfu_pct", "large_ms_per_solve",
    "large_ms_device", "large_ms_device_bf16", "large_mfu_pct", "warmup_s", "total_s", "headline_solved",
    "headline_failures_pre_rescue",
    # the port's
    "backend", "device_name", "power_limit",
}
DEVICE_KEYS = {"ba_scenes_per_s_device", "ba_mfu_pct", "large_ms_device", "large_ms_device_bf16", "large_mfu_pct",
               "power_limit"}


def test_main_prints_the_jax_line_on_the_cpu(capsys):
    rc = tb.main(["--device", "cpu", "--B", "32", "--chunk", "16", "--ba-scenes", "2", "--large", "256", "32"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 0, out.err
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "batched_lm_instances_per_s_per_chip" and line["unit"] == "instances/s"
    assert line["value"] > 0 and line["vs_baseline"] == round(line["value"] / 1000.0, 3)
    extra = line["extra"]
    assert set(extra) == EXTRA_KEYS
    assert all(extra[k] is None for k in DEVICE_KEYS)
    assert all(extra[k] is not None for k in EXTRA_KEYS - DEVICE_KEYS)
    assert extra["backend"] == "torch-cpu" and extra["headline_solved"] == "32" and extra["ba_solved"] == "2/2"
    assert "# pallas B=32 chunk=16:" in out.err and "# large rung:" in out.err and "status=1" in out.err


def test_imports_no_jax_and_needs_a_card():
    code = ("import sys, cannoles_tpu_torch.bench; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cannoles_tpu.')) "
            "or m == 'cannoles_tpu']; print(bad)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "[]", (r.stdout, r.stderr)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run_ba_rung(scenes=2)
