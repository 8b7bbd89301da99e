"""The bank store's batched copy (``ops/bank_copy.py``) against what it
replaces and against PyTorch's own multi-tensor copy, on the card.

* :func:`store_row`: the first ``outer_post`` store of a headline-family
  ``vsolve`` at B on the graph route (float32, LM, full KKT, the fused
  LDLᵀ kernel), its pairs taken as the bank made them.  Run three ways on
  copies of the pairs' storages (so that every source shares memory with
  the destinations it shared it with): ``bank_copy.store`` (the kernel),
  ``bank_copy.plain`` (a clone of every aliased source, then one ``copy_``,
  a memcpy node in a graph, a pair: the store before the kernel) and
  :func:`library_store`; ``equal`` says whether the three leave the same
  bytes.  Then each is timed on the pairs themselves: device ms a store
  inside a captured graph (:func:`graph_ms`).
* :func:`cut_rows`: one entry of each size beside 20 of 16 KB, folded into
  the kernel's launch against left to a memcpy node, and the kernel and
  the memcpy node alone: the readings behind ``bank_copy.CUT_BYTES``.

    python -m cannoles_tpu_torch.bench_copy [--batches 1,16384] [--cut] [--json F]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .ops import bank_copy

BATCHES = (1, 16_384)
CUT_SIZES = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20, 10_240 * 1024 * 4, 128 << 20)


def graph_ms(fn, k: int = 20, reps: int = 30) -> float:
    """Device ms of one ``fn()`` inside a captured graph: ``k`` calls
    captured in one graph, replayed ``reps`` times between two CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * k)


def library_store(pairs):
    """The store with PyTorch's kernels: the pairs ``bank_copy`` folds copied
    as bytes by one ``torch._foreach_copy_`` (multi-tensor apply), their
    sources that share storage with a destination first staged by one
    ``torch.cat``; the other pairs by ``copy_``, as ``bank_copy.store``
    leaves them."""
    written = {bank_copy._storage(d) for d, _ in pairs}
    fold = [(d, s) for d, s in pairs if bank_copy._folds(d, s) and d.nbytes]
    left = [(d, s.clone() if bank_copy._storage(s) in written else s)
            for d, s in pairs if not bank_copy._folds(d, s)]
    dst = [d.reshape(-1).view(torch.uint8) for d, _ in fold]
    src = [s.reshape(-1).view(torch.uint8) for _, s in fold]
    aliased = [k for k, (_, s) in enumerate(fold) if bank_copy._storage(s) in written]
    if aliased:
        buf, o = torch.cat([src[k] for k in aliased]), 0
        for k in aliased:
            src[k], o = buf[o:o + src[k].numel()], o + src[k].numel()
    if fold:
        torch._foreach_copy_(dst, src)
    for d, s in left:
        d.copy_(s)


def segment_store(dev, B: int, name: str = "outer_post"):
    """The (buffer, source) pairs of the first store of segment ``name`` in
    a headline-family ``vsolve`` at B on the graph route (float32, LM, full
    KKT, the fused kernel), its sources kept alive."""
    from . import CaNNOLeSSolver, vsolve
    from .core import segments
    from .models.families import lm_bench_batch, lm_bench_family

    seen = []
    store = segments._store

    def record(bank, upd, capturing=False, adopt=()):
        if bank.last == name and not seen and not capturing:
            seen.append((bank, dict(upd)))
        return store(bank, upd, capturing, adopt)

    x0, d = lm_bench_batch(B, seed=0)
    pb = lm_bench_family(torch.float32, dev)
    s = CaNNOLeSSolver(pb, method="lm", linsolve="pallas", kkt="full", dtype=torch.float32, device=dev)
    segments._store = record
    try:
        vsolve(pb, torch.as_tensor(x0, dtype=torch.float32, device=dev),
               data_batch=torch.as_tensor(d, dtype=torch.float32, device=dev), solver=s, max_iter=2, rescue=False)
    finally:
        segments._store = store
    torch.cuda.synchronize()
    bank, upd = seen[0]
    pairs = []
    for k, v in upd.items():
        pairs += [(a, b) for a, b in zip(segments._leaves(bank.__dict__[k]), segments._leaves(v))
                  if a is not b and not segments._same_memory(a, b)]
    return pairs


def _copies(pairs):
    """The pairs as views of copies of their storages, every storage copied
    once, so that sources share memory with destinations as they did; and
    the copies, as byte tensors."""
    copies = {}

    def view(t):
        st = t.untyped_storage()
        if st.data_ptr() not in copies:
            copies[st.data_ptr()] = torch.empty(0, dtype=torch.uint8, device=t.device).set_(st).clone()
        c = copies[st.data_ptr()].untyped_storage()
        return torch.empty(0, dtype=t.dtype, device=t.device).set_(c, t.storage_offset(), t.size(), t.stride())

    return [(view(d), view(s)) for d, s in pairs], list(copies.values())


def store_row(dev, B: int) -> dict:
    """The ``outer_post`` store at B: its pairs, bytes, aliased sources, the
    kernel's launches and the pairs it leaves; whether the kernel, the
    plain version and the library store leave the same bytes; and the
    device ms a store of each inside a captured graph."""
    pairs = segment_store(dev, B)
    written = {bank_copy._storage(d) for d, _ in pairs}
    plan, left = bank_copy.plan(pairs, written)
    out = {}
    for way in ("kernel", "plain", "library"):
        copy, out[way] = _copies(pairs)
        if way == "plain":
            bank_copy.plain(copy, {bank_copy._storage(d) for d, _ in copy})
        else:
            (bank_copy.store if way == "kernel" else library_store)(copy)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(out["kernel"], out["plain"], out["library"]))
    return dict(B=B, pairs=len(pairs), bytes=sum(d.nbytes for d, _ in pairs),
                clones=sum(bank_copy._storage(s) in written for _, s in pairs),
                launches=len(plan), left=len(left), equal=equal,
                folded_ms=graph_ms(lambda: bank_copy.store(pairs)),
                memcpy_ms=graph_ms(lambda: bank_copy.plain(pairs, written)),
                library_ms=graph_ms(lambda: library_store(pairs)))


def cut_rows(dev, sizes=CUT_SIZES) -> list:
    """One entry of each size beside 20 of 16 KB: the store with the entry
    folded into the kernel's launch against left to a memcpy node, and the
    kernel and the memcpy node on the entry alone (device ms)."""
    cut0, rows = bank_copy.CUT_BYTES, []
    base = [(torch.empty(4096, device=dev), torch.randn(4096, device=dev)) for _ in range(20)]
    try:
        for size in sizes:
            big = [(torch.empty(size // 4, device=dev), torch.randn(size // 4, device=dev))]
            bank_copy.CUT_BYTES = size
            fold = graph_ms(lambda: bank_copy.store(base + big))
            bank_copy.CUT_BYTES = size - 1
            left = graph_ms(lambda: bank_copy.store(base + big))
            rows.append(dict(bytes=size, folded_ms=fold, left_ms=left,
                             kernel_ms=graph_ms(lambda: bank_copy._launch(big, False)),
                             memcpy_ms=graph_ms(lambda: big[0][0].copy_(big[0][1]))))
            del big
    finally:
        bank_copy.CUT_BYTES = cut0
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--cut", action="store_true", help="also the size sweep behind bank_copy.CUT_BYTES")
    ap.add_argument("--json", help="write the result here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_copy times the kernel on a CUDA device; none is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = dict(device=torch.cuda.get_device_name(dev), cut_bytes=bank_copy.CUT_BYTES,
               stores=[store_row(dev, int(b)) for b in args.batches.split(",")])
    if args.cut:
        out["cut_rows"] = cut_rows(dev)
    text = json.dumps(out)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    return 0 if all(r["equal"] for r in out["stores"]) else 1


if __name__ == "__main__":
    sys.exit(main())
