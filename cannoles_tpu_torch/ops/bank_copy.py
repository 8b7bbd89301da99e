"""Batched copy of a segment's outputs into the bank's buffers: the CUDA
kernel and its plain version.

No TPU kernel is replaced: on the TPU a segment's outputs are a jitted
function's results.  The port's graph route (``core/segments.py``) copies
each output leaf into its persistent buffer, and in a captured graph each
``copy_`` is one memcpy node of ~1.2-1.5 µs however few bytes it moves.
:func:`store` copies a whole store in one launch of ``csrc/bank_copy.cu``
(two where sources that share memory with a destination must be staged
first); the design note is at the top of that file.

* :func:`plan` decides, from what each (destination, source) pair shows,
  which pairs fold into the kernel: both contiguous, one dtype, one shape,
  one device, and at most :data:`CUT_BYTES`.  Larger ones, where one memcpy
  node already runs at bandwidth, stay on ``copy_``, as do strided and
  converting copies.  Folded pairs go in launches of at most :data:`CAP`: a
  store of at most :data:`CAP` entries and :data:`STAGE_BYTES` takes the
  kernel's one-block path, which reads every source before it writes, so
  an aliased source needs no clone; a larger store stages its aliased
  sources in one scratch buffer first.
* :func:`store` runs the plan on a CUDA device: the kernel's launches,
  then ``copy_`` for the pairs left.  On the CPU it runs the plain version,
  :func:`plain`: a clone of every source that shares storage with a buffer
  written by the store, then one ``copy_`` a pair.
* ``"bank_copy"`` counts the kernel's launches that succeeded,
  ``("bank_copy", "entries")`` and ``("bank_copy", "left")`` the pairs of a
  card's stores folded into them and left to ``copy_``; the plain version
  counts nothing.  ``core.segments.counters()`` reads them, a replayed graph
  adding what its capture counted.
"""

from __future__ import annotations

import array
import functools
from ctypes import c_int, c_void_p

import torch

from ..utils import spans

__all__ = ["store", "plan", "plain", "CAP", "STAGE_BYTES", "CUT_BYTES"]

# entries a launch: the kernel's descriptor, passed by value, must fit the
# 4 KB kernel parameter space (the library's kCap)
CAP = 128
# the one-block path's shared-memory stage (the library's kStageBytes)
STAGE_BYTES = 40 * 1024
# a pair above this size stays on ``copy_``, where one memcpy node moves it
# at bandwidth: on an H100 (``python -m cannoles_tpu_torch.bench_copy
# --cut``, PERF.md), one entry beside 20 of 16 KB took 9.78 us a store
# folded against 10.90 us left at 16 MiB, 32.15 against 32.53 us at 40 MiB,
# and 96.97 against 92.74 us at 128 MiB, where the memcpy node's ~3.0 TB/s
# beats the kernel's ~2.8
CUT_BYTES = 16 << 20

_ENTRIES, _LEFT = ("bank_copy", "entries"), ("bank_copy", "left")
spans.declare("bank_copy", _ENTRIES, _LEFT)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _padded(nbytes: int) -> int:
    """An entry's bytes in the kernel's shared memory or the staging
    buffer, each entry starting at a multiple of 16."""
    return -(-nbytes // 16) * 16


def _folds(d: torch.Tensor, s: torch.Tensor) -> bool:
    return (d.dtype == s.dtype and d.shape == s.shape and d.device == s.device and d.nbytes <= CUT_BYTES
            and d.is_contiguous() and s.is_contiguous())


def plan(pairs, written):
    """The launches for ``pairs`` ((destination, source) tensors) and the
    pairs left to ``copy_``: ``([(one_block, [(dst, src), ...]), ...],
    left)``.  ``written``: the storages of every destination of the store;
    a folded source in one of them is staged, when the store is too large
    for the one-block path, into a scratch buffer allocated here, and its
    pair then reads from the buffer after a launch that fills it."""
    fold, left = [], []
    for d, s in pairs:
        (fold if _folds(d, s) else left).append((d, s))
    fold = [(d, s) for d, s in fold if d.nbytes]
    if not fold:
        return [], left
    if len(fold) <= CAP and sum(_padded(d.nbytes) for d, _ in fold) <= STAGE_BYTES:
        return [(True, fold)], left
    launches, staged = [], []
    aliased = [k for k, (_, s) in enumerate(fold) if _storage(s) in written]
    if aliased:
        offsets = [0]
        for k in aliased:
            offsets.append(offsets[-1] + _padded(fold[k][1].nbytes))
        buf = torch.empty(offsets[-1], dtype=torch.uint8, device=fold[0][0].device)
        for k, o in zip(aliased, offsets):
            d, s = fold[k]
            v = buf[o:o + s.nbytes].view(s.dtype).view(s.shape)
            staged.append((v, s))
            fold[k] = (d, v)
    for items in (staged, fold):
        launches += [(False, items[a:a + CAP]) for a in range(0, len(items), CAP)]
    return launches, left


def store(pairs):
    """Copy each (destination, source) pair's source into its destination;
    every destination gets the value its source held before the store,
    whatever memory they share and in whatever order the copies run."""
    if not pairs:
        return
    written = {_storage(d) for d, _ in pairs}
    if not pairs[0][0].is_cuda:
        plain(pairs, written)
        return
    launches, left = plan(pairs, written)
    spans.count(_ENTRIES, len(pairs) - len(left))
    spans.count(_LEFT, len(left))
    left = [(d, s.clone() if _storage(s) in written else s) for d, s in left]
    for one_block, items in launches:
        _launch(items, one_block)
    for d, s in left:
        d.copy_(s)


def plain(pairs, written):
    """The store's plain version: every source in a storage of ``written``
    cloned first, then one ``copy_`` a pair."""
    for d, s in [(d, s.clone() if _storage(s) in written else s) for d, s in pairs]:
        d.copy_(s)


@functools.lru_cache(maxsize=None)
def _function():
    """The kernel's C function, bound on the first call (which builds the
    library); the library's limits must be this module's."""
    from . import _native

    lib = _native.library("bank_copy.cu")
    limits = (_native.function(lib, "cannoles_bank_copy_cap", [])(),
              _native.function(lib, "cannoles_bank_copy_stage_bytes", [])())
    if limits != (CAP, STAGE_BYTES):
        raise RuntimeError(f"bank_copy: the library's limits {limits} are not ({CAP}, {STAGE_BYTES})")
    return _native.function(lib, "cannoles_bank_copy", [c_void_p, c_int, c_int, c_void_p])


def _launch(items, one_block: bool):
    """One launch of the kernel over ``items``, on the current stream of
    the destinations' device, counted as ``"bank_copy"``."""
    dev = items[0][0].device
    table = array.array("q")
    for d, s in items:
        if not d.is_cuda or s.device != dev:
            raise ValueError(f"bank_copy: a pair on {d.device} and {s.device} in a launch on {dev}")
        table.extend((s.data_ptr(), d.data_ptr(), d.nbytes))
    fn = _function()
    if dev.index == torch.cuda.current_device():
        err = fn(table.buffer_info()[0], len(items), int(one_block), torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(table.buffer_info()[0], len(items), int(one_block), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bank_copy: kernel launch failed with error {err} ({len(items)} entries, "
                           f"one_block={one_block})")
    spans.count("bank_copy")
