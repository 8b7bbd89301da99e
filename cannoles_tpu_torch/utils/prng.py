"""JAX's counter-based random draws, bit for bit, in numpy.

The matrix-free solver's ``precond='jacobi'`` estimates a diagonal from
Hutchinson probes, ``jax.random.rademacher(jax.random.PRNGKey(0),
(probes, n))`` in the JAX package.  torch's generators cannot give the same
bits, so this module computes them the way JAX does (threefry-2x32 with 20
rounds, the partitionable counter layout of ``jax_threefry_partitionable``,
the default since JAX 0.5):

* the counter of element i (row-major over ``shape``) is the 64-bit i split
  into its high and low 32-bit words, encrypted under the key;
* a 32-bit draw is the XOR of the two output words, a 64-bit draw is the
  high word shifted over the low one;
* ``rademacher`` is ``2·(uniform < 0.5) − 1``, so +1 where the draw's top
  bit is 0 and −1 where it is 1.

JAX draws the uniform behind ``bernoulli(p=0.5)`` in its default float
type: 64 bits with ``jax_enable_x64``, 32 bits without.  ``bits`` selects
which of the two draws to reproduce.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "random_bits", "rademacher"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1``
    (uint32 arrays) under ``key`` = (k0, k1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = (np.asarray(x0, np.uint32) + ks[0]).astype(np.uint32)
    x1 = (np.asarray(x1, np.uint32) + ks[1]).astype(np.uint32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape, bits: int):
    """``jax.random.bits``'s draw for ``PRNGKey(seed)`` (seed < 2³²), as
    uint32 (``bits=32``) or uint64 (``bits=64``)."""
    size = int(np.prod(shape, dtype=np.int64))
    i = np.arange(size, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32((0, seed), hi, lo)
    if bits == 32:
        out = b1 ^ b2
    elif bits == 64:
        out = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    else:
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    return out.reshape(shape)


def rademacher(seed: int, shape, bits: int) -> np.ndarray:
    """``jax.random.rademacher(PRNGKey(seed), shape)`` as a float64 array of
    ±1, for JAX's ``bits``-wide default float (see the module docstring)."""
    top = random_bits(seed, shape, bits) >> np.uint64(bits - 1)
    return 1.0 - 2.0 * top.astype(np.float64)
