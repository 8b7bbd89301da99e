"""The manifest's names resolve to their files, new files are found without
an edit to an existing one, the draws follow the seed, and no module of
JAX or the JAX package is loaded."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch
from conftest import REPO, make_small

from portbench.common import draws, guard
from portbench.common.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_resolves_by_name():
    man = Manifest(REPO)
    data = man.data
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in man.workloads():
        cell = man.cell(w)
        assert NAME.match(w) and cell.config["name"] == cell.config_name
        fam, ref = cell.family(), cell.reference()
        assert callable(fam.draw) and callable(fam.problem) and callable(ref.judge)
        entry = cell.entry()
        assert callable(entry.Entry) and callable(entry.Entry.call)
        if hasattr(entry, "judge"):
            assert set(entry.LIMITS) <= set(entry.judge([]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            reader = cell.reader(m["name"])
            assert (reader.UNIT, reader.SOURCE, reader.LAYER) == (m["unit"], m["source"], m["layer"])
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for c in data["configs"]:
        assert (REPO / c["file"]).is_file()


def test_new_files_are_found_without_an_edit(tmp_path):
    root = make_small(tmp_path / "checkout")
    pb = root / "portbench"
    (pb / "configs" / "rosen_wide.json").write_text(
        json.dumps(dict(json.loads((pb / "configs" / "rosen_con.json").read_text()), name="rosen_wide")))
    (pb / "configs" / "rosen_wide.py").write_text((pb / "configs" / "rosen_con.py").read_text())
    (pb / "reference" / "rosen_wide.py").write_text((pb / "reference" / "rosen_con.py").read_text())
    (pb / "traffic" / "sweep8.json").write_text(json.dumps({"entry": "vsolve", "batch": 8, "bank": 1, "slice_calls": 1}))
    (pb / "metrics" / "calls.py").write_text(
        'UNIT = "calls"\nSOURCE = "program_counter"\nLAYER = "device"\n'
        "def read(ctx):\n    return ctx.calls\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "rosen_wide", "source": "s", "file": "portbench/configs/rosen_wide.json",
                           "reduced": [], "why": "w"})
    man["workloads"].append({"name": "rosen_wide.sweep8", "config": "rosen_wide", "traffic": "sweep8",
                             "chips": 1, "why": "w"})
    man["end_to_end"][0]["workloads"].append("rosen_wide.sweep8")
    man["per_layer"].append({"name": "calls.sweep", "unit": "calls", "better": "higher",
                             "source": "program_counter", "layer": "device", "moves": "instances_per_s",
                             "workloads": ["rosen_wide.sweep8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = Manifest(root).cell("rosen_wide.sweep8")
    assert cell.config["name"] == "rosen_wide" and cell.traffic["batch"] == 8
    assert [m["name"] for m in cell.per_layer] == ["calls.sweep"]
    assert cell.reader("calls.sweep").read(type("C", (), {"calls": 3})()) == 3
    assert cell.family().draw(cell.config, draws.generator(1, "cpu"), 1, 8, "cpu")[0]["x0"].shape == (8, 2)


def test_a_split_quantity_has_one_reader():
    man = Manifest(REPO)
    solve, sweep = man.cell("dense_fit.m10240"), man.cell("rosen_con.sweep4096")
    assert solve.reader("device_idle_pct.solve") is not None
    assert {m["moves"] for m in solve.per_layer if m["name"].startswith("device_idle_pct.")} == {"solve_ms"}
    assert {m["moves"] for m in sweep.per_layer if m["name"].startswith("device_idle_pct.")} == {"instances_per_s"}
    assert solve.reader("device_idle_pct.solve").__file__ == sweep.reader("device_idle_pct.sweep").__file__


def test_a_per_layer_metric_without_workloads_is_refused(tmp_path):
    root = make_small(tmp_path / "checkout")
    man = json.loads((root / "BENCHMARK.json").read_text())
    del man["per_layer"][0]["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="lists no workloads"):
        Manifest(root).cell("rosen_con.single")


def test_draws_follow_the_seed():
    seed = 2**31 + 12345  # seeds may pass 32 bits
    a = draws.rosen_batch(draws.generator(seed, "cpu"), 64, torch.float32, "cpu")
    b = draws.rosen_batch(draws.generator(seed, "cpu"), 64, torch.float32, "cpu")
    c = draws.rosen_batch(draws.generator(seed + 1, "cpu"), 64, torch.float32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and a[0].shape == c[0].shape and a[1].shape == (64, 3)
    g1, g2 = draws.generator(seed, "cpu"), draws.generator(seed, "cpu")
    m1, m2 = draws.dense_matrices(g1, 64, 16, torch.float32, "cpu"), draws.dense_matrices(g2, 64, 16, torch.float32, "cpu")
    y1, y2 = draws.dense_targets(g1, *m1, 3)[0], draws.dense_targets(g2, *m2, 3)[0]
    assert torch.equal(m1[0], m2[0]) and torch.equal(y1, y2) and y1.shape == (3, 64)


def test_a_pool_is_the_same_work_in_the_seed_s_order():
    pool = [dict(x0=torch.arange(8.0)[:, None] + 10 * k, data=torch.arange(8.0)[:, None]) for k in range(3)]
    a, b, c = draws.order(pool, 2**40 + 1), draws.order(pool, 2**40 + 1), draws.order(pool, 2**40 + 2)
    assert all(torch.equal(x["x0"], y["x0"]) for x, y in zip(a, b))
    assert any(not torch.equal(x["x0"], y["x0"]) for x, y in zip(a, c))
    flat = sorted(torch.cat([x["x0"] for x in a])[:, 0].tolist())
    assert flat == sorted(torch.cat([x["x0"] for x in pool])[:, 0].tolist())
    for x in a:  # each lane keeps its own data
        assert torch.equal(x["x0"] % 10, x["data"])


@pytest.mark.parametrize("blocks", [2, 4])
def test_on_k_cards_each_rank_keeps_its_lanes(blocks):
    """On k cards the seed moves lanes only inside each rank's block, so
    every rank solves the same lanes of each input on every seed."""
    pool = [dict(x0=torch.arange(16.0)[:, None] + 100 * k, data=torch.arange(16.0)[:, None]) for k in range(3)]
    a, c = draws.order(pool, 2**40 + 1, blocks), draws.order(pool, 2**40 + 2, blocks)
    assert any(not torch.equal(x["x0"], y["x0"]) for x, y in zip(a, c))
    w = 16 // blocks
    for x in a + c:
        src = pool[int(x["x0"][0, 0]) // 100]["x0"]
        assert torch.equal(x["x0"] % 100, x["data"])
        for j in range(blocks):
            assert sorted(x["x0"][j * w:(j + 1) * w, 0].tolist()) == src[j * w:(j + 1) * w, 0].tolist()
    with pytest.raises(ValueError, match="equal blocks"):
        draws.order(pool, 1, 3)


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules(["cannoles_tpu_torch", "cannoles_tpu_torch.core", "jaxtyping"]) == []
    assert guard.forbidden_modules(["cannoles_tpu.core.solver", "jax.numpy", "flax"]) == [
        "cannoles_tpu", "flax", "jax"]


def test_the_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.common.harness, "
            "portbench.common.mix, portbench.tests.readings, cannoles_tpu_torch; "
            "from portbench.common.manifest import Manifest; m = Manifest(sys.argv[1]); "
            "[(c.family(), c.reference(), [c.reader(x['name']) for x in c.per_layer], "
            "c.entry()) "
            "for c in map(m.cell, m.workloads())]; "
            "import portbench.common.ranks, portbench.tests.faults; "
            "from portbench.common.guard import forbidden_modules; print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
