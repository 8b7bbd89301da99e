"""Accuracy envelope of ``matmul_precision`` over the MGH battery.

Port of ``benchmarks/bf16_envelope.py``.  For each of the 35 standard MGH
problems:

* solve in float64 (``method='newton'``) as the truth, on the same device
  (the H100 has float64; the TPU had none, so the JAX script solves it on
  the host CPU);
* re-solve in float32 under ``matmul_precision`` in ('highest',
  'bfloat16');
* report per mode the solved count and the max/median deviation of the
  returned solution from the float64 one (max |x₃₂ − x₆₄|, on the rows that
  both solved).

Each row is printed as it is solved and, with ``--json``, the file is
rewritten after every row, so that a run cut short keeps the rows it
reached.  On the CPU every matmul is IEEE under every mode, so the two
modes differ there only in the quality gate's tolerance.

Usage::

    python -m cannoles_tpu_torch.bf16_envelope [--device {cuda,cpu}] [--json OUT]
        [--max-time S]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from .core.solver import CaNNOLeSSolver
from .models.mgh import mgh_suite

__all__ = ["MODES", "solve_row", "summarize", "main"]

MODES = ("highest", "bfloat16")
_SOLVED = ("first_order", "small_residual")


def solve_row(spec, device, max_time: float = 120.0) -> dict:
    """One MGH problem: the float64 truth, then a float32 solve per mode.
    A solve that raises is recorded as ``error: ...`` and the row goes on."""
    t0 = time.perf_counter()
    row = {"name": spec.name}
    x64 = None
    try:
        pb = spec.make(dtype=torch.float64, device=device)
        s64 = CaNNOLeSSolver(pb, method="newton", dtype=torch.float64).solve(max_time=max_time)
        x64 = np.asarray(s64.solution, np.float64)
        row["f64_status"] = s64.status
    except Exception as e:  # noqa: BLE001 (the envelope survives one bad problem)
        row["f64_status"] = f"error: {e}"
    for mp in MODES:
        try:
            pb = spec.make(dtype=torch.float32, device=device)
            s = CaNNOLeSSolver(pb, method="newton", dtype=torch.float32,
                               matmul_precision=mp).solve(max_time=max_time)
            ok = s.status in _SOLVED
            dev = (float(np.max(np.abs(np.asarray(s.solution, np.float64) - x64)))
                   if ok and x64 is not None else None)
            row[mp] = {"status": s.status, "dev": dev, "obj": float(s.objective), "iter": s.iter}
        except Exception as e:  # noqa: BLE001
            row[mp] = {"status": f"error: {e}", "dev": None}
    row["wall_s"] = time.perf_counter() - t0
    return row


def summarize(rows) -> dict:
    """Per mode: solved count, max and median deviation from float64."""
    out = {}
    for mp in MODES:
        solved = [r for r in rows if r[mp]["status"] in _SOLVED]
        devs = [r[mp]["dev"] for r in solved if r[mp]["dev"] is not None]
        out[mp] = {
            "solved": len(solved),
            "n": len(rows),
            "max_dev": max(devs) if devs else None,
            "median_dev": float(np.median(devs)) if devs else None,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default=None)
    ap.add_argument("--max-time", type=float, default=120.0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bf16_envelope: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    meta = {"device": args.device, "torch": torch.__version__}
    if args.device == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(0)
    print(json.dumps(meta), flush=True)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    rows = []
    for spec in mgh_suite():
        rows.append(solve_row(spec, args.device, args.max_time))
        print(json.dumps(rows[-1]), flush=True)
        if args.json:
            pathlib.Path(args.json).write_text(json.dumps(dict(meta, rows=rows), indent=1))
    summary = summarize(rows)
    for mp, s in summary.items():
        print(f"{mp}: solved {s['solved']}/{s['n']}  max_dev={s['max_dev']}  "
              f"median_dev={s['median_dev']}", flush=True)
    meta.update(summary=summary, wall_s=time.perf_counter() - t0)
    print(json.dumps(meta), flush=True)
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(dict(meta, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
