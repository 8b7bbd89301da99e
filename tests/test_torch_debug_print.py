"""PyTorch port, ``CaNNOLeSSolver(debug_print=True)`` against the JAX
package's rows in float64 on the CPU.

The JAX package prints one row per outer iteration from inside its compiled
step (``jax.debug.print``); the port prints the same row from the host
after each outer iteration, one per lane that took it.  The rows must be
equal string for string:

* ``solve()`` on ``hs26`` (a constrained problem, 24 outer iterations).  The
  JAX package's ``solve()`` runs its first outer step twice (a warm-up step
  whose result it drops), so its first row appears twice; the port's
  warm-up prints nothing.
* a batch of three lanes of the bench family (``run``): per outer
  iteration one row for each lane still running, in lane order, each
  string for string the row of that lane run alone by the port (a lane of
  a batch follows its own trajectory bit for bit).  Against the JAX
  package's run of each lane alone (``_run_fn``) the rows agree in number
  and in their integer columns (``iter``, ``in_it``, ``nbk``); their values
  near convergence differ in rounding (LM at δ ≤ 1e-7: ‖c‖ 2.07e-09
  against 5.86e-09 at iteration 7 of lane 1, 8.0e-12 against 1.9e-11 at
  its end), which the solutions' 1e-10 bar of ``test_torch_vsolve.py``
  covers.
* ``debug_print=False`` prints nothing and leaves the solve's result and
  host checks as they were.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cannoles_tpu as cj  # noqa: E402
import cannoles_tpu_torch as ct  # noqa: E402


def _jax_bench():
    """The repo-root bench.py (the JAX family's ``build_problem``)."""
    spec = importlib.util.spec_from_file_location(
        "bench_debug_print", pathlib.Path(__file__).resolve().parents[1] / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(fn, flush=lambda: None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
        flush()
    return out, buf.getvalue().splitlines()


def test_solve_rows_equal_jax():
    from cannoles_tpu.models.hs import hs_problem as jhs
    from cannoles_tpu_torch.models.hs import hs_problem as ths

    sj, jrows = _rows(lambda: cj.CaNNOLeSSolver(jhs("hs26"), debug_print=True).solve(), jax.effects_barrier)
    st, trows = _rows(lambda: ct.CaNNOLeSSolver(ths("hs26", device="cpu"), debug_print=True).solve())
    assert st.status == sj.status == "first_order" and st.iter == sj.iter
    assert jrows[0] == jrows[1]  # the JAX warm-up step's row
    assert trows == jrows[1:]
    assert len(trows) == st.iter
    assert trows[0].startswith("iter=1 f=") and " in_it=" in trows[0]


def _ints(row: str):
    return [f for f in row.split() if f.split("=")[0] in ("iter", "in_it", "nbk")]


def test_batch_rows_per_active_lane():
    from cannoles_tpu_torch.models.families import lm_bench_batch, lm_bench_family

    x0, d = lm_bench_batch(3, seed=2)
    pt = lm_bench_family(torch.float64, "cpu")

    def run(lanes):
        s = ct.CaNNOLeSSolver(pt, method="lm", kkt="full", debug_print=True)
        zeros = torch.zeros(len(lanes), 1, dtype=torch.float64)
        return _rows(lambda: s.run(torch.as_tensor(x0[lanes]), zeros, s.make_config(max_iter=50),
                                   torch.as_tensor(d[lanes])))

    alone = [run([i])[1] for i in range(3)]
    assert len({len(r) for r in alone}) > 1  # lanes finish at different iterations
    st, rows = run([0, 1, 2])
    assert rows == [lane[k] for k in range(max(map(len, alone))) for lane in alone if k < len(lane)]
    assert st.iter.tolist() == [len(r) for r in alone]

    sj = cj.CaNNOLeSSolver(_jax_bench().build_problem(jnp.float64), method="lm", kkt="full", debug_print=True)
    cfg = sj.make_config(max_iter=50)
    for i in range(3):
        _, jrows = _rows(lambda: sj._run_fn(jnp.asarray(x0[i]), jnp.zeros(1), cfg, jnp.asarray(d[i])),
                         jax.effects_barrier)
        assert [_ints(r) for r in jrows] == [_ints(r) for r in alone[i]]


def test_debug_print_off_prints_nothing_and_changes_nothing():
    from cannoles_tpu_torch.models.hs import hs_problem as ths

    runs = {}
    for flag in (False, True):
        s = ct.CaNNOLeSSolver(ths("hs26", device="cpu"), debug_print=flag)
        st, rows = _rows(s.solve)
        runs[flag] = (st, rows, s.host_syncs)
    (off, off_rows, off_syncs), (on, on_rows, on_syncs) = runs[False], runs[True]
    assert off_rows == [] and len(on_rows) == on.iter
    assert np.array_equal(off.solution, on.solution) and off.iter == on.iter
    assert off.solver_specific == on.solver_specific and off_syncs == on_syncs
