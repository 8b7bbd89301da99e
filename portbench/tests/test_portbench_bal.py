"""The BAL cell at a size the CPU runs in seconds: the harness's result line,
the reference's judgement of the program's solves, the TF32 control coming
out not correct, the entry's counters, and the roofline's count of the work
from the observation structure."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import make_small, run_cell

from portbench.common.manifest import Manifest

CELL = "bal_dubrovnik356.pool4"
# (cameras, points, observations) of the small copy, and its start's scale:
# a 12-camera scene at the cell's 0.1 can take all 50 iterations to meet the
# stated float32 test, so the copy keeps the scale it was written at
SMALL = (12, 400, 2215)
SMALL_X0_SCALE = 1.0


@pytest.fixture
def bal_root(tmp_path):
    root = make_small(tmp_path / "checkout")
    p = root / "portbench" / "configs" / "bal_dubrovnik356.json"
    cfg = json.loads(p.read_text())
    C, P, n = SMALL
    cfg.update(n_cams=C, n_pts=P, n_obs=n, nvar=9 * C + 3 * P, nequ=2 * n, x0_scale=SMALL_X0_SCALE)
    p.write_text(json.dumps(cfg, indent=1))
    t = root / "portbench" / "traffic" / "pool4.json"
    t.write_text(json.dumps(dict(json.loads(t.read_text()), bank=2)))
    return root


def _last(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_the_cell_runs_correct_on_the_cpu(bal_root):
    rc, out, err = run_cell(bal_root, CELL)
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is True, (res["checks"], err[-2000:])
    assert set(res["metrics"]) == {"setup_s", "solve_ms", "solve_p95_ms"}
    assert set(res["checks"]) == {"kkt_ratio", "cost_gap", "unsolved_pct", "tensor_core_ops"}
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_tf32_reference_is_not_correct(bal_root):
    rc, out, err = run_cell(bal_root, CELL, control="reference_tf32")
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is False, res["checks"]


def test_the_entry_returns_the_schur_counters():
    from conftest import REPO

    cell = Manifest(REPO).cell(CELL)
    cfg = dict(cell.config)
    C, P, n = SMALL
    cfg.update(n_cams=C, n_pts=P, n_obs=n, nvar=9 * C + 3 * P, nequ=2 * n, x0_scale=SMALL_X0_SCALE)
    fam, entry = cell.family(), cell.entry()
    g = torch.Generator().manual_seed(2**40 + 3)
    shared = fam.shared_inputs(cfg, g, "cpu")
    items = fam.draw(cfg, g, 1, 1, "cpu", shared)
    mix = SimpleNamespace(cfg=cfg, batch=1, traffic_name="pool4", family=fam, device=torch.device("cpu"),
                          shared=shared)
    e = entry.Entry(mix, dict(cfg["solver"]))
    out = e.call(items[0])
    assert out["assemble"] == int(out["nfact"][0]) > 0
    assert out["pairs"] == out["assemble"] * out["scene"]["pairs"]
    assert out["scene"]["n_obs"] == n and out["scene"]["cd"] == 9
    assert out["x"].shape == (1, 9 * C + 3 * P) and out["r"].shape == (1, 2 * n) and out["lam"].shape == (1, 7)


def test_the_roofline_counts_the_work_from_the_structure():
    from conftest import REPO

    reader = Manifest(REPO).cell(CELL).reader("schur_pairs_roofline.bal")
    # two points: one seen by cameras 0, 1, 2 and one by cameras 1, 2
    scene = reader.structure(torch.tensor([0, 1, 2, 1, 2]), torch.tensor([0, 0, 0, 1, 1]), 3, 9)
    assert scene == {"n_obs": 5, "pairs": 6 + 3, "blocks": 6, "cd": 9}
    nbytes, flops = reader.work(scene)
    assert nbytes == (5 * 2 * 27 + 6 * 81) * 4 + (2 * 9 + 6 + 1) * 4 and flops == 2 * 81 * 3 * 9
    peaks = {"hbm_bytes_s": 1e9, "float32_flop_s": 1e9}
    sl = SimpleNamespace(device_ops=[("void schur_pairs_kernel<float, 9, 4>", 0.0, 2.0 * 1e6)],
                         outputs=[{"assemble": 2, "scene": scene}, {"assemble": 1, "scene": scene}])
    ctx = SimpleNamespace(slice=sl, peaks=peaks, config={"dtype": "float32"}, log=lambda *a: None)
    assert reader.read(ctx) == pytest.approx(100.0 * 3 * max(nbytes, flops) / 1e9 / 2.0)
    sl.outputs = [{"assemble": None, "scene": scene}]  # a program without the counter
    assert reader.read(ctx) is None
    per_solve = Manifest(REPO).cell(CELL).reader("schur_assemblies_per_solve.bal")
    sl.outputs = [{"assemble": 4}, {"assemble": 2}]
    assert per_solve.read(ctx) == 3.0
    sl.outputs = [{"assemble": None}]
    assert per_solve.read(ctx) is None
