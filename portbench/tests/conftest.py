"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``).

``small_root``: a copy of the benchmark at sizes the CPU runs in seconds
(the same files, with smaller batches, banks and dense sizes), with the
program linked in, and ``run_cell`` to run one cell of it in a child
process on the CPU, the harness's look for a card replaced, optionally with
a fault planted in the program first (in each rank's process, for a cell on
several cards: its ranks run on the CPU over gloo).  ``card``: the first CUDA device, or
the test skips; decided inside the fixture, never at import.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))  # ``portbench`` as a package, from this checkout

# (file under portbench/, key, value) of the small copy
SMALL = [
    ("traffic/sweep65536.json", "batch", 128), ("traffic/sweep65536.json", "chunk", 32),
    ("traffic/sweep65536.json", "bank", 2), ("traffic/sweep4096.json", "batch", 64),
    ("traffic/sweep4096.json", "bank", 2), ("traffic/single.json", "bank", 8),
    ("traffic/m10240.json", "bank", 4), ("traffic/single.json", "slice_calls", 4),
    ("traffic/m10240.json", "slice_calls", 4), ("configs/rosen_con.json", "straggler_from_batch", 128),
    ("configs/dense_fit.json", "nequ", 256), ("configs/dense_fit.json", "nvar", 32),
    ("traffic/sweep102400.mesh4.json", "batch", 128), ("traffic/sweep102400.mesh4.json", "bank", 2),
]

# the ranks of a cell on several cards start by ``spawn``, which imports this
# script again: the run lies under the ``__main__`` check
DRIVE = textwrap.dedent('''
    import json, pathlib, sys
    import torch
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    if __name__ == "__main__":
        spec = json.loads(sys.argv[1])
        prepare = None
        if spec.get("fault"):
            from portbench.tests import faults
            prepare = getattr(faults, spec["fault"])
        from portbench.common import harness
        require = None if spec.get("card") else (lambda chips: torch.device("cpu"))
        sys.exit(harness.main(spec["argv"], root=root, require=require, control=spec.get("control"),
                              prepare=prepare))
''')


def make_small(dst: pathlib.Path) -> pathlib.Path:
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / "cannoles_tpu_torch", dst / "cannoles_tpu_torch")
    for rel, key, value in SMALL:
        p = dst / "portbench" / rel
        d = json.loads(p.read_text())
        d[key] = value
        p.write_text(json.dumps(d, indent=1))
    (dst / "drive.py").write_text(DRIVE)
    return dst


@pytest.fixture
def small_root(tmp_path):
    return make_small(tmp_path / "checkout")


def run_cell(root: pathlib.Path, workload: str, *, seed: int = 4_000_000_123, seconds: float = 1.0,
             trace: int = 0, fault: str = None, control: str = None, card: bool = False):
    """(exit code, stdout, stderr) of one run of ``workload`` in ``root``
    (``control``: a control of the configuration in the program's place)."""
    spec = {"argv": ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], "fault": fault, "control": control, "card": card}
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH="")
    p = subprocess.run([sys.executable, str(root / "drive.py"), json.dumps(spec)], cwd=root,
                       capture_output=True, text=True, timeout=600, env=env)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)
