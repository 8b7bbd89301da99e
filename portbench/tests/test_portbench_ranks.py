"""A cell on several cards, run as 4 gloo ranks on the CPU: one result line
from rank 0 over every gathered lane, planted faults in one rank coming out
not correct or with no result, and a rank that raises ending the run."""

from __future__ import annotations

import json
import time

import pytest
from conftest import run_cell

MESH = "rosen_con.sweep102400.mesh4"


def _last(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_ranks_give_one_result_over_the_whole_batch(small_root):
    rc, out, err = run_cell(small_root, MESH)
    assert rc == 0, err[-3000:]
    assert len(out.strip().splitlines()) == 1
    res = _last(out)
    assert res["correct"] is True, res["checks"]
    batch = json.loads((small_root / "portbench" / "traffic" / "sweep102400.mesh4.json").read_text())["batch"]
    calls = int(err.split("# window ")[1].split(" calls")[0].split(", ")[1])
    assert res["attempted"] == calls * batch and calls % 2 == 0 and res["failed"] == 0
    assert res["device"]["count"] == 4 and set(res["metrics"]) == {"setup_s", "instances_per_s"}
    assert res["checks"]["stats_gap"] == {"value": 0, "limit": 0}
    assert "4 ranks, backend gloo" in err and "4 ranks hold the same outputs" in err


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "rank_answer_altered",
                                   "stats_off"])
def test_planted_rank_fault_is_not_correct(small_root, fault):
    rc, out, err = run_cell(small_root, MESH, fault=fault)
    assert rc == 0, err[-3000:]
    assert _last(out)["correct"] is False, _last(out)["checks"]


@pytest.mark.parametrize("fault", ["exchange_skipped", "rank_copy_altered"])
def test_outputs_that_differ_between_ranks_give_no_result(small_root, fault):
    from portbench.common.ranks import EXIT_DIFFER

    rc, out, err = run_cell(small_root, MESH, fault=fault)
    assert rc == EXIT_DIFFER and out.strip() == "", err[-3000:]
    assert "differ from rank 0's" in err


def test_a_rank_that_raises_ends_the_run(small_root):
    t0 = time.monotonic()
    rc, out, err = run_cell(small_root, MESH, fault="rank_raises", seconds=30.0)
    assert rc != 0 and out.strip() == ""
    assert "planted: rank 1 raises" in err and "rank 1 ended with exit code 1" in err
    assert time.monotonic() - t0 < 60  # at once, not at the end of the window or a collective's timeout


def test_control_is_not_correct_on_ranks(small_root):
    rc, out, err = run_cell(small_root, MESH, control="reference_bf16")
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is False and "stats_gap" not in res["checks"], res["checks"]
