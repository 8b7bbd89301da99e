"""Scaling harness (BASELINE config 5): a large instance batch over 1..K
ranks, throughput and efficiency.

Port of ``benchmarks/scaling.py``.  Its family and draw (the bench
family: Rosenbrock residual with one linear constraint; x0 and data from
``default_rng(0)``, ``models.families.lm_bench_batch``), float32, through
``parallel.multihost.scaling_bench`` (LM, condensed, ``max_iter=50``, 3
reps) on K spawned ranks (``parallel.launch``).  Every row is labelled by
what its ranks ran on:

* ``virtual_cpu_shared_core``: ranks on the CPU (the JAX script's label
  for its virtual CPU devices): a check of the sharded program;
* ``one_card_shared``: more ranks than cards, so ranks share a card: a
  check of the sharded program, not scaling;
* ``hardware``: each rank has a card of its own.

    python -m cannoles_tpu_torch.scaling [-B 4096] [--ranks K] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

__all__ = ["run", "mesh_kind", "main"]


def mesh_kind(k: int, device=None) -> str:
    """The label of rows taken with k ranks on ``device`` (None: the card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "virtual_cpu_shared_core"
    return "hardware" if torch.cuda.device_count() >= k else "one_card_shared"


def _rank(B: int, device=None, reps: int = 3) -> list:
    """One rank's ``scaling_bench`` on the family and draw."""
    from .models.families import lm_bench_batch, lm_bench_family
    from .parallel.mesh import make_batch_mesh
    from .parallel.multihost import scaling_bench

    dev = make_batch_mesh(device=device).device
    pb = lm_bench_family(torch.float32, dev)
    x0s, datas = lm_bench_batch(B, seed=0)
    return scaling_bench(pb, x0s, datas, reps=reps, device=device)


def run(B: int = 4096, ranks: int = 1, device=None, reps: int = 3) -> list:
    """``scaling_bench``'s rows over ``ranks`` spawned ranks, each labelled
    (``"mesh"``); ``device`` None is the card."""
    from .parallel.launch import launch

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: scaling runs on the card by default; pass device=\"cpu\"")
    out = launch(_rank, int(ranks), int(B), None if device is None else str(device), reps)
    kind = mesh_kind(int(ranks), device)
    return [dict(row, mesh=kind) for row in out[0]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-B", type=int, default=4096)
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawned ranks (default: the cards' count, 4 on the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("scaling: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    device = None if args.device == "cuda" else "cpu"
    ranks = args.ranks or (torch.cuda.device_count() if device is None else 4)
    kind = mesh_kind(ranks, device)
    if kind != "hardware":
        print(f"# NOTE: {ranks} ranks share {'the CPU' if device else 'one card'}: efficiency numbers "
              "here validate the sharded program, not hardware scaling.", flush=True)
    rows = run(args.B, ranks, device)
    for r in rows:
        print(f"devices={r['devices']:<3d} throughput={r['throughput']:.0f}/s "
              f"speedup={r['speedup']:.2f} efficiency={r['efficiency'] * 100:.0f}% [{r['mesh']}]", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
