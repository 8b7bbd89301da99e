"""The PyTorch port's examples (``examples/torch_0{1,2,3,4}_*.py``) on the CPU.

Each runs with ``--cpu`` in a subprocess of its own (all four started at
once, each waited for with its own timeout), must exit 0 and must print the
statuses its JAX twin (``examples/0{1,2,3,4}_*.py --cpu``) prints.  Example
03's row-sharded solve runs on 8 spawned ranks, as its twin's on 8 virtual
devices.  Without a card and without ``--cpu`` an example raises.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

# per example: (timeout in s, [(line prefix, statuses the JAX twin prints on it)])
EXPECTED = {
    "torch_01_basics.py": (400, [
        ("rosenbrock:", ["first_order"]),
        ("from [0.0, 0.0]:", ["first_order"]),
        ("from [3.0, -2.0]:", ["first_order"]),
        ("from [-5.0, 5.0]:", ["max_eval"]),
    ]),
    "torch_02_batched_sweep.py": (200, [
        ("sweep:", ["'solved': 512", "'first_order': 512", "'exception': 0"]),
        ("freudenstein_roth:", ["single start Σf² = 48.98"]),
    ]),
    "torch_03_large_and_sharded.py": (300, [
        ("curve fit 8192 rows:", ["first_order"]),
        ("row-sharded:", ["first_order"]),
        ("bundle adjustment:", ["first_order"]),
    ]),
    "torch_04_bundle_adjustment.py": (400, [
        ("batched scenes:", ["'solved': 8", "'first_order': 8"]),
        ("schur 10c/500p:", ["first_order"]),
        ("matfree:", ["first_order"]),
        ("schur constrained:", ["first_order"]),
        ("matfree constrained:", ["first_order"]),
        ("continuation:", ["first_order"]),
    ]),
}


@pytest.fixture(scope="module")
def runs():
    """All four examples started at once; one intra-op thread each."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / name), "--cpu"], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name in EXPECTED}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_example_runs_on_the_cpu(name, runs):
    timeout, expected = EXPECTED[name]
    out, err = runs[name].communicate(timeout=timeout)
    assert runs[name].returncode == 0, err[-3000:]
    lines = out.splitlines()
    for prefix, marks in expected:
        line = next((s for s in lines if s.startswith(prefix)), None)
        assert line is not None, (prefix, out)
        for mark in marks:
            assert mark in line, (mark, line)
    if name == "torch_02_batched_sweep.py":
        best = float(re.search(r"multistart Σf² = (\S+)", out).group(1))
        assert best < 1e-6, out  # the global minimum, 0 (the JAX twin: 6.156e-09)


def test_example_without_card_or_cpu_flag_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_02_batched_sweep.py")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
