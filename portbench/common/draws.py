"""The benchmark's draws of starts and data, made from the seed.

Frozen copies of the distributions of ``lm_bench_batch`` and of
``large_rung_problem``'s draws (``cannoles_tpu_torch/models/families.py`` at
commit 1ca66b23abd7dda613dfa1e36f885e66d5322e60, themselves the repo-root
``bench.py:142-150`` and ``:281-296``).  The program's versions draw with
numpy on the host from one fixed seed; here each draw is made on the run's
device by a ``torch.Generator`` seeded from ``--seed``, in a few large
calls, in the type the solver runs in, so that a seed gives the same inputs
on the same device and every seed gives inputs of the same sizes.
"""

from __future__ import annotations

import math

import torch

__all__ = ["generator", "order", "rosen_batch", "dense_matrices", "dense_targets", "ieee"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number
    below 2**63; seeds may pass 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def order(bank: list, seed: int, blocks: int = 1) -> list:
    """The inputs of ``bank`` in an order drawn from ``seed``, and the lanes
    of each (the leading axis of every tensor of an input) too; drawn on the
    host, so that a seed gives one order on every device.  ``blocks``: the
    lanes move only inside each of that many equal contiguous blocks (one
    rank's lanes on a mesh of that many ranks)."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    out = []
    for k in torch.randperm(len(bank), generator=g).tolist():
        item = bank[k]
        B = item["x0"].shape[0]
        if B % blocks:
            raise ValueError(f"{B} lanes do not split into {blocks} equal blocks")
        w = B // blocks
        lanes = torch.cat([torch.randperm(w, generator=g) + j * w for j in range(blocks)])
        out.append(_take(item, lanes.to(item["x0"].device)))
    return out


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree[idx]


def rosen_batch(g: torch.Generator, B: int, dtype, device):
    """``lm_bench_batch``'s distribution: x0 = N(0, 0.5^2) + (-1.2, 1.0),
    (B, 2); d = (1 + 0.2 N, 0.1 N, 1 + 0.2 N), (B, 3)."""
    x0 = 0.5 * torch.randn((B, 2), generator=g, dtype=dtype, device=device)
    x0 += torch.tensor([-1.2, 1.0], dtype=dtype, device=device)
    z = torch.randn((B, 3), generator=g, dtype=dtype, device=device)
    d = z * torch.tensor([0.2, 0.1, 0.2], dtype=dtype, device=device)
    d += torch.tensor([1.0, 0.0, 1.0], dtype=dtype, device=device)
    return x0, d


def dense_matrices(g: torch.Generator, m: int, n: int, dtype, device):
    """``large_rung_problem``'s B1 and B2: N(0, 1) / sqrt(n), each (m, n)."""
    B1 = torch.randn((m, n), generator=g, dtype=dtype, device=device) / math.sqrt(n)
    B2 = torch.randn((m, n), generator=g, dtype=dtype, device=device) / math.sqrt(n)
    return B1, B2


def dense_targets(g: torch.Generator, B1, B2, K: int):
    """K targets y_k = B1 x_k + 0.1 sin(B2 x_k) with x_k ~ N(0, 1)
    (``large_rung_problem``'s x_true, one per solve), in IEEE products:
    (K, m) targets and the (K, n) x_k."""
    n = B1.shape[1]
    X = torch.randn((K, n), generator=g, dtype=B1.dtype, device=B1.device)
    with ieee():
        Y = X @ B1.T + 0.1 * torch.sin(X @ B2.T)
    return Y, X


class ieee:
    """float32 matmuls in IEEE float32 (TF32 off) inside the block."""

    def __enter__(self):
        m = torch.backends.cuda.matmul
        # PyTorch >= 2.9 has fp32_precision ('ieee' | 'tf32'), older ones allow_tf32
        self._key = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
        self._old = getattr(m, self._key)
        setattr(m, self._key, "ieee" if self._key == "fp32_precision" else False)

    def __exit__(self, *exc):
        setattr(torch.backends.cuda.matmul, self._key, self._old)
