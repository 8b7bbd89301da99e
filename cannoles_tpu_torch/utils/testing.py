"""Seeded inputs shared by the port's tests and ``chip_smoke.py``.

Inputs are made with numpy so that the JAX package and the port (and the
card and the CPU) see the same numbers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["quasi_definite", "copy_layout", "copy_pairs", "copy_expected"]


def quasi_definite(B: int, N: int, seed: int, skip: bool = True):
    """A batch of symmetric quasi-definite systems [[A, Cᵀ], [C, -D]] with
    A (n1, n1) and D positive definite, n1 = ⌈N/2⌉: the inertia the ρ ladder
    asks of a KKT matrix with nvar = n1.  With ``skip``, lane 0 has a zero
    first pivot and lane 1 a second pivot that is exactly zero after one
    elimination step, so the skipped-pivot rule runs.

    Returns float64 arrays ``W`` (B, N, N), ``rhs`` (B, N) and ``n1``."""
    rng = np.random.default_rng(seed)
    n1 = max(1, (N + 1) // 2)
    G = rng.normal(size=(B, N, N))
    S = G @ G.transpose(0, 2, 1) / N + np.eye(N)
    W = 0.15 * (G + G.transpose(0, 2, 1))
    W[:, :n1, :n1] = S[:, :n1, :n1]
    W[:, n1:, n1:] = -S[:, n1:, n1:]
    if skip and B > 1:
        W[0, 0, 0] = 0.0
    if skip and B > 2 and N >= 2:
        W[1, 0, :] = W[1, :, 0] = 0.0
        W[1, :2, :2] = 1.0
    return W, rng.normal(size=(B, N)), n1


_COPY_DTYPES = (("uint8", 1), ("bool", 1), ("int16", 2), ("int32", 4), ("float32", 4), ("float64", 8))


def copy_layout(seed: int, n: int, max_numel: int):
    """A random store for ``ops/bank_copy.py``: n destinations laid out
    disjointly in one pool of bytes, each with a dtype, a length below
    ``max_numel`` and an offset that is a multiple of its item size but
    often not of 16; about a third of the sources lie in the same pool
    (sharing memory with destinations, their own included), the others in
    a second pool, and one in ten is strided (every other element).

    Returns the two pools as numpy byte arrays of zeros and ones (which
    every dtype of the list reads and writes back bit for bit) and the
    entries, each ``(dtype name, numel, dst_offset, source_in_pool,
    src_offset, step)``."""
    rng = np.random.default_rng(seed)
    entries, off, other = [], 0, 0
    for _ in range(n):
        name, item = _COPY_DTYPES[rng.integers(len(_COPY_DTYPES))]
        numel = int(rng.integers(1, max_numel))
        off = -(-off // item) * item + item * int(rng.integers(0, 4))
        entries.append([name, numel, off])
        off += numel * item
    pool = off + 64
    for e in entries:
        name, numel, _ = e
        item = dict(_COPY_DTYPES)[name]
        step = 2 if rng.random() < 0.1 else 1
        span = numel * step * item
        if rng.random() < 0.35 and span <= pool:
            e += [True, item * int(rng.integers(0, (pool - span) // item + 1)), step]
        else:
            other = -(-other // item) * item + item * int(rng.integers(0, 4))
            e += [False, other, step]
            other += span
    return (rng.integers(0, 2, pool, dtype=np.uint8), rng.integers(0, 2, other + 64, dtype=np.uint8),
            [tuple(e) for e in entries])


def copy_pairs(entries, pool, other):
    """The (destination, source) tensors of ``copy_layout``'s entries, as
    views of the byte tensors ``pool`` and ``other``."""
    import torch

    pairs = []
    for name, numel, dst, in_pool, src, step in entries:
        dtype = getattr(torch, name)
        item = dict(_COPY_DTYPES)[name]
        base = pool if in_pool else other
        pairs.append((pool[dst:dst + numel * item].view(dtype),
                      base[src:src + numel * step * item].view(dtype)[::step]))
    return pairs


def copy_expected(entries, pool, other):
    """The pool (a numpy byte array) after the store: every destination
    holds its source's bytes from before it."""
    out = pool.copy()
    for name, numel, dst, in_pool, src, step in entries:
        item = dict(_COPY_DTYPES)[name]
        base = pool if in_pool else other
        got = base[src:src + numel * step * item].reshape(-1, step * item)[:, :item].reshape(-1)
        out[dst:dst + numel * item] = got
    return out
