"""The readings that a cell's limits are set from: the numbers compared, for
the program on many seeds and for the configuration's control on a few,
each over the cell's whole bank of inputs at the cell's own sizes.

    python3 portbench/tests/readings.py --workload rosen_con.sweep65536 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --json chiprun_out/readings.json

For each seed the cell is set up from the seed as a run sets it up, every
input of its bank is run once to build what the window replays, then once
more through the timed call, then the slice of a run where the
configuration's checks read the card's operations, and the configuration's
reference judges those outputs.  Each of the configuration's ``controls``
(``configs/<config>.json``; ``--controls`` picks some) stands in the
program's place on the control seeds.  ``--fault`` plants one of
``faults.py``'s faults in the program first.  On the card only, unless
``--device cpu`` (the kernels' plain versions; sizes from a smaller copy of
the benchmark given by ``--root``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def readings(cell, device, seed: int, control: str = None) -> dict:
    """The numbers of one seed (``control``: the name of a control in the
    program's place): the judge's, and the calls' walls."""
    import torch

    from portbench.common.harness import Run, _slice

    run = Run(cell, device, seed, control=control)
    run.warm()
    walls = [run.call(k) for k in range(len(run.mix.bank))]
    sl = _slice(run, device)[0] if run.reads_the_trace() else None
    run.mix.free()
    numbers = run.judge(sl)
    del run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "control": control, "numbers": numbers,
            "wall_s": {"min": min(walls), "max": max(walls), "sum": sum(walls)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="", help="names of the configuration's controls (default: all)")
    ap.add_argument("--fault", default=None, help="a fault of faults.py to plant in the program")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root)
    sys.path.insert(0, str(root))
    import torch

    from portbench.common.manifest import Manifest

    cell = Manifest(root).cell(args.workload)
    device = torch.device(args.device)
    if args.fault:
        from portbench.tests import faults

        getattr(faults, args.fault)()
    if device.type == "cuda":
        from cannoles_tpu_torch.ops import _native

        _native.load()
    rows = []
    controls = [c for c in args.controls.split(",") if c] or list(cell.config["controls"])
    plan = [(int(s), None) for s in args.seeds.split(",") if s] + \
           [(int(s), c) for c in controls for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        t0 = time.perf_counter()
        row = readings(cell, device, seed, control)
        row["seconds"] = time.perf_counter() - t0
        row["fault"] = args.fault
        rows.append(row)
        print(json.dumps(row), flush=True)
    for control in [None] + controls:
        sel = [r["numbers"] for r in rows if r["control"] == control]
        for name in cell.config["checks"]:
            vals = [n[name] for n in sel if n.get(name) is not None]
            if vals:
                print(f"# {control or 'program'}{' with ' + args.fault if args.fault else ''} {name}: "
                      f"min {min(vals)} max {max(vals)} over {len(vals)} seeds", file=sys.stderr)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
