"""Whole runs of the harness: the result line's keys, no result without a
card, the reference against the program's solve on the CPU, the control and
the planted faults coming out not correct, and the reduction of a trace."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import run_cell

from portbench.common.trace import Slice

ROSEN_CELLS = ["rosen_con.sweep65536", "rosen_con.sweep4096", "rosen_con.single"]
ALL_CELLS = ROSEN_CELLS + ["dense_fit.m10240"]


def _last(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_result_line_has_the_contract_keys(small_root, workload):
    rc, out, err = run_cell(small_root, workload)
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True, err[-2000:]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {"setup_s", "instances_per_s"} if "sweep" in workload else {"setup_s", "solve_ms", "solve_p95_ms"}
    assert set(res["metrics"]) == names
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] > 0 and res["failed"] == 0
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


def test_no_card_no_result(small_root):
    rc, out, err = run_cell(small_root, "rosen_con.single", card=True)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert rc != 0 and out.strip() == "" and "no result" in err


def _controls(workload, where=None):
    """The controls of the cell's configuration (``where``: those that
    stand the reference or the program in the program's place)."""
    from portbench.common.manifest import Manifest
    from conftest import REPO

    controls = Manifest(REPO).cell(workload).config["controls"]
    return [(workload, name) for name, c in controls.items() if where is None or where in c]


@pytest.mark.parametrize("workload,control", [c for w in ALL_CELLS for c in _controls(w, "reference")])
def test_control_is_not_correct(small_root, workload, control):
    # the program's own lower-precision paths run IEEE on the CPU; the card
    # test below runs them
    rc, out, err = run_cell(small_root, workload, control=control)
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is False, res["checks"]


def test_reduced_precision_kernels_are_told_by_name():
    from portbench.common.tensor_cores import PATTERN

    ieee = ["sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4"
            "_execute_kernel__5x_cublas", "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, "
            "4, false, false>", "void kernel<getrf_wo_pivot_params_<float, 0, 256, 1, 64, 64, 68, 8, 1, 1> >",
            "memcpy128", "ldlt_thread_per_system", "void at::native::elementwise_kernel<128, 2>"]
    reduced = ["sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1_execute_segment_k_off",
               "cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_align4",
               "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x128x64_warpgroupsize1x1x1"]
    assert not any(PATTERN.search(n) for n in ieee)
    assert all(PATTERN.search(n) for n in reduced)


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ALL_CELLS for f in ("state_unchanged", "answer_altered")
] + [(w, "half_batch") for w in ROSEN_CELLS if "sweep" in w])
def test_planted_fault_is_not_correct(small_root, workload, fault):
    rc, out, err = run_cell(small_root, workload, fault=fault)
    assert rc == 0, err[-3000:]
    assert _last(out)["correct"] is False, _last(out)["checks"]


def test_reference_agrees_with_a_cpu_solve():
    from cannoles_tpu_torch import CaNNOLeSSolver, vsolve

    from portbench.common import draws
    from portbench.common.manifest import Manifest
    from conftest import REPO

    cell = Manifest(REPO).cell("rosen_con.sweep4096")
    cfg = dict(cell.config, dtype="float64")
    fam, ref = cell.family(), cell.reference()
    item = fam.draw(cfg, draws.generator(7, "cpu"), 1, 64, "cpu")[0]
    pb = fam.problem(cfg, "cpu")
    s = CaNNOLeSSolver(pb, dtype=torch.float64, device="cpu", **cfg["solver"])
    st = vsolve(pb, item["x0"], data_batch=item["data"], solver=s, max_iter=50, rescue=True).states
    out = dict(x=st.x, r=st.r, lam=st.lam, status=st.status)
    numbers = ref.judge([(item, out)], cfg)
    assert numbers["unsolved_pct"] == 0 and numbers["kkt_ratio"] <= 1.0
    mine = ref.solve(item)
    assert ref.judge([(item, mine)], cfg)["kkt_ratio"] < 1e-3
    same = (mine["x"] - st.x).abs().amax(-1) < 1e-3  # lanes where both found one stationary point
    assert int(same.sum()) >= 32  # the family has two minima in many lanes
    assert torch.allclose(mine["x"][same], st.x[same], atol=1e-6)


def test_dense_reference_agrees_with_a_cpu_solve():
    from cannoles_tpu_torch import CaNNOLeSSolver

    from portbench.common import draws
    from portbench.common.manifest import Manifest
    from conftest import REPO

    cell = Manifest(REPO).cell("dense_fit.m10240")
    cfg = dict(cell.config, dtype="float64", nequ=512, nvar=64)
    fam, ref = cell.family(), cell.reference()
    g = draws.generator(11, "cpu")
    shared = fam.shared_inputs(cfg, g, "cpu")
    item = fam.draw(cfg, g, 1, 1, "cpu", shared)[0]
    s = CaNNOLeSSolver(fam.problem(cfg, "cpu", shared), dtype=torch.float64, device="cpu", **cfg["solver"])
    st = s.run(item["x0"], s.problem.y0.expand(1, 0), s.make_config(max_iter=30), item["data"])
    numbers = ref.judge([(item, dict(x=st.x, r=st.r, status=st.status))], cfg, shared)
    assert numbers["unsolved_pct"] == 0 and numbers["kkt_ratio"] <= 1.0 and numbers["x_err"] < 1e-6


def test_trace_reduction():
    # device operations at 0-10 and 30-40 us inside a slice of 0-100 us; the
    # host in a vsolve call from 0 to 60, synchronizing from 60 to 100
    sl = Slice(window_s=1e-4, busy_s=2e-5, device_ops=[("k1", 0.0, 10.0), ("k2", 30.0, 40.0)],
               host_spans=[("slice", 0.0, 100.0), ("vsolve", 0.0, 60.0), ("synchronize", 60.0, 100.0)],
               outputs=[], calls=1)
    assert sl.op_seconds() == [("k1", 1e-5), ("k2", 1e-5)]
    assert sl.idle_gaps((0.0, 100.0)) == [("vsolve", 6e-5), ("vsolve", 2e-5)]


def test_a_slice_that_captures_gives_no_result(capsys):
    """A traced slice that captured a graph read another path than the
    window's: no result, and the run exits nonzero."""
    from portbench.common.harness import EXIT_CAPTURED, report

    outcome = {"forbidden": [], "slice_capture_s": 0.25, "lines": ["check x 0 limit 1"], "result": {"correct": True}}
    assert report(outcome) == EXIT_CAPTURED
    out, err = capsys.readouterr()
    assert out == "" and "graph captures inside the traced slice 0.250 s" in err
    assert report(dict(outcome, slice_capture_s=0.0)) == 0
    assert json.loads(capsys.readouterr().out) == {"correct": True}


def test_metric_readers_read_nothing_where_nothing_is_there():
    from portbench.common.manifest import Manifest
    from conftest import REPO

    cell = Manifest(REPO).cell("rosen_con.sweep65536")
    ctx = SimpleNamespace(calls=0, solves=0, host_syncs=0, counters={}, slice=None, config=cell.config,
                          peaks=None, log=print)
    for m in Manifest(REPO).data["per_layer"]:
        assert cell.reader(m["name"]).read(ctx) is None


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ALL_CELLS)
def test_control_on_the_card_at_the_cell_size(card, workload):
    """Each control at the cell's own size on the card fails the committed
    limits, and the program on the same seed meets them."""
    from portbench.common.manifest import Manifest
    from portbench.tests.readings import readings
    from conftest import REPO

    from cannoles_tpu_torch.ops import _native

    _native.load()
    cell = Manifest(REPO).cell(workload)
    checks = cell.config["checks"]

    def ok(numbers):
        return all(numbers[k] is not None and numbers[k] <= c["limit"] for k, c in checks.items())

    assert ok(readings(cell, card, 5_000_000_017)["numbers"])
    for _, control in _controls(workload):
        assert not ok(readings(cell, card, 5_000_000_017, control=control)["numbers"]), control


def _same_bits(a, b) -> bool:
    """Whether two tensors, or dicts of them, hold the same bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    return (a.dtype, a.shape) == (b.dtype, b.shape) and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_the_built_in_entries_make_the_same_calls(small_root, workload):
    """The ``vsolve`` and ``run`` entries (``entries/``) and the bank's
    order give the bits of the calls the generator made before entries were
    kept in files (``frozen_mix.py``), on the same draws."""
    from frozen_mix import FrozenMix

    from portbench.common.manifest import Manifest
    from portbench.common.mix import Mix

    cell = Manifest(small_root).cell(workload)
    ref, cpu, seed = cell.reference(), torch.device("cpu"), 4_000_000_321
    old, new = FrozenMix(cell, cpu, seed, reference=ref), Mix(cell, cpu, seed, reference=ref)
    assert new.batch == old.batch and len(new.bank) == len(old.bank) == cell.traffic["bank"]
    for a, b in zip(old.bank, new.bank):
        assert _same_bits(a, b)
        oa, ob = old.call(a), new.call(b)
        assert oa.keys() == ob.keys() == {"x", "r", "lam", "status", "nfact"}
        for k in oa:
            assert _same_bits(oa[k], ob[k]), k


ENTRY = '''
import torch


class Entry:
    def __init__(self, mix, options):
        from cannoles_tpu_torch import CaNNOLeSSolver

        self.mix = mix
        self.problem = mix.family.problem(mix.cfg, mix.device, mix.shared)
        self.solver = CaNNOLeSSolver(self.problem, dtype=getattr(torch, mix.cfg["dtype"]), device=mix.device,
                                     **options)

    def call(self, item):
        from cannoles_tpu_torch import vsolve

        st = vsolve(self.problem, item["x0"], data_batch=item["data"], solver=self.solver,
                    max_iter=int(self.mix.cfg["max_iter"]), rescue=True).states
        return dict(x=st.x, r=st.r, lam=st.lam, status=st.status, nfact=st.nfact)
'''


def test_a_new_entry_file_runs_without_an_edit(small_root):
    """An entry of its own (``entries/<entry>.py``) and a mix that names it
    run to a result line, with new files and new entries in
    ``BENCHMARK.json`` alone."""
    pb = small_root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    (pb / "entries" / "vsolve_whole.py").write_text(ENTRY)
    (pb / "traffic" / "whole48.json").write_text(json.dumps(
        {"entry": "vsolve_whole", "batch": 48, "bank": 2, "pool_seed": 0, "slice_calls": 1}))
    man = json.loads((small_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "rosen_con.whole48", "config": "rosen_con", "traffic": "whole48",
                             "chips": 1, "why": "w"})
    next(m for m in man["end_to_end"] if m["name"] == "instances_per_s")["workloads"].append("rosen_con.whole48")
    next(m for m in man["per_layer"] if m["name"] == "launches_per_call.sweep")["workloads"].append(
        "rosen_con.whole48")
    (small_root / "BENCHMARK.json").write_text(json.dumps(man))
    assert all(p.read_bytes() == b for p, b in before.items())
    rc, out, err = run_cell(small_root, "rosen_con.whole48")
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is True and res["attempted"] % 48 == 0, res
    assert set(res["metrics"]) == {"setup_s", "instances_per_s"}
