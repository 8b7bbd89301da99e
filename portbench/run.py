"""The benchmark of cannoles_tpu_torch on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cells, metrics and configurations are
those of ``BENCHMARK.json`` beside this folder; ``common/harness.py`` says
what a run does.  The program is imported from this checkout, and every
cache a run writes lies inside it, at fixed paths: the program's kernels in
``cannoles_tpu_torch/_build`` (keyed by their sources' hash), any other
kernel cache under ``.portbench_cache/``.
"""

from __future__ import annotations

import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _environment():
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"  # no library of the process may load JAX on its own


if __name__ == "__main__":
    _environment()
    sys.path.insert(0, str(ROOT))
    from portbench.common.harness import main

    sys.exit(main(sys.argv[1:], root=ROOT))
