"""The solver's straight-line segments between host checks, run eagerly or
replayed as CUDA graphs.

A solve is a chain of segments (init, the system build and first ρ attempt,
one ρ attempt, the trial step, one line-search trip, the acceptance, the
outer bookkeeping) separated by host checks, the reads of a few flags that
decide which segment runs next.  A segment is a function of a
:class:`Bank`, the named tensors that the solve keeps between segments, and
returns the entries it replaces.  No segment reads the device on the host
except where ``bank._host_reads`` allows it (CGLS's early exit, which
changes no result).

* Eager route (the CPU, a row mesh, ``linsolve='cpp'``): the returned
  tensors replace the entries; nothing is copied.
* Graph route (a CUDA device otherwise): every entry is a persistent
  buffer.  The first run of a segment is eager, and its results are copied
  into the buffers; then the segment is captured once, with those copies,
  as a ``torch.cuda.CUDAGraph`` that reads and writes the buffers in place,
  and every later run is one replay with no copies in.  A segment marked
  ``eager`` (the eigh attempts: cuSOLVER's ``syevj`` checks its error code
  on the host) runs eagerly with the same copies.  A segment whose capture
  fails raises :class:`GraphCaptureError`, naming the problem and the
  segment; the solve never falls back to the eager route on its own.
  Every allocation inside a capture is a temporary (the buffers exist
  before it), so the graphs of one solver share one memory pool
  (``Bank(pool=)``), whatever order they replay in.

The counters of ``utils/spans.py`` count at capture time, where nothing
runs, so a capture records what it counted and each replay adds it.
Each run of a segment is a span, ``cannoles.replay``, ``cannoles.capture``
or ``cannoles.eager``, with the segment's name in its args; the bank keeps
the name of its last segment (``Bank.last``), whose flags the next host
check reads.
"""

from __future__ import annotations

import time

import torch

from ..ops import bank_copy
from ..utils import spans
from ..utils.spans import span

__all__ = ["Bank", "GraphCaptureError", "run_segment", "clone_tree", "load", "counters", "restore_counters"]


class GraphCaptureError(RuntimeError):
    """A segment of a solve could not be captured as a CUDA graph."""


class Bank:
    """A solve's tensors between segments, as attributes, on ``route``
    ('eager' or 'graph').  On the graph route the entries are persistent
    buffers and the segments are captured into one memory pool, shared by
    the banks that share the holder ``pool`` (a one-item list, filled at
    the first capture)."""

    def __init__(self, route: str, label: str, pool=None):
        self._graphed = route == "graph"
        self._host_reads = route == "eager"
        self._label = label
        self.last = None  # the name of the segment that ran last
        self._pool = pool if pool is not None else [None]
        self._graphs: dict = {}
        # the buffers of a run's data by id, which no segment writes: every
        # entry that carries them (the data, each state's ``data``) keeps
        # these one buffers (held here, so that no id is reused)
        self._shared: dict = {}

    def replays(self) -> dict:
        """Replays per captured segment since the bank was made."""
        return {name: g.replays for name, g in self._graphs.items()}


def _leaves(v):
    if v is None:
        return []
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, dict):
        return [x for k in v for x in _leaves(v[k])]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _leaves(e)]
    return []


def clone_tree(v, keep=frozenset()):
    """A copy of a pytree of tensors (NamedTuple, tuple, list, dict); the
    tensors whose ids are in ``keep`` are not copied."""
    if isinstance(v, torch.Tensor):
        return v if id(v) in keep else v.clone()
    if isinstance(v, dict):
        return {k: clone_tree(x, keep) for k, x in v.items()}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*[clone_tree(x, keep) for x in v])
    if isinstance(v, (list, tuple)):
        return type(v)(clone_tree(x, keep) for x in v)
    return v


def _data_leaves(k, v):
    """The data leaves of a bank entry: the whole entry ``data``, or the
    field ``data`` of a NamedTuple entry (a state)."""
    if k == "data":
        return _leaves(v)
    if isinstance(v, tuple) and "data" in getattr(v, "_fields", ()):
        return _leaves(v.data)
    return []


def _same_memory(a, b):
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride())


def _store(bank: Bank, upd: dict, capturing: bool = False, adopt=()):
    """Copy ``upd`` into the bank's buffers; an entry seen for the first
    time gets buffers of its own (never inside a capture: the buffers must
    outlive the graph's temporaries), but for its data leaves that are
    already the bank's (one buffer per data leaf, whatever entries carry
    it), and an entry named in ``adopt`` is taken by reference: its tensors
    become the buffers.  A source that shares storage with a buffer written
    here is read before it is written, so that every entry gets the value
    the segment computed, whatever the order of the copies: the copies go
    through ``ops/bank_copy.py``, one batched launch for the whole store on
    a card (two when aliased sources must be staged), ``copy_`` for what it
    does not fold."""
    pairs = []
    for k, v in upd.items():
        cur = bank.__dict__.get(k)
        old = _leaves(cur)
        new = _leaves(v)
        if cur is None or len(old) != len(new) or any(a.shape != b.shape for a, b in zip(old, new)):
            if capturing:
                raise RuntimeError(f"entry {k!r} has no buffer of its shape from the segment's eager run")
            bank.__dict__[k] = v if k in adopt else clone_tree(v, bank._shared)
            bank._shared.update((id(x), x) for x in _data_leaves(k, bank.__dict__[k]))
            continue
        pairs += [(d, s) for d, s in zip(old, new) if d is not s and not _same_memory(d, s)]
    bank_copy.store(pairs)


def load(bank: Bank, adopt=(), **entries):
    """Put a run's inputs into the bank (copied into its buffers on the
    graph route).  An entry named in ``adopt`` that the bank does not hold
    yet is taken by reference, not copied: an input that the caller keeps
    unchanged for the bank's life (a problem's own data), which the graphs
    then read where it lies."""
    if bank._graphed:
        _store(bank, entries, adopt=adopt)
    else:
        bank.__dict__.update(entries)


def counters() -> dict:
    """The process's counters (``utils/spans.py``), and ``"host_syncs"``,
    the sum of the ``("host_syncs", site)`` counts: the custom kernels'
    launches by name (the fused LDLT kernel's also by (N, B) under
    ``("fused_ldlt", (N, B))``), the bank stores' batched copies
    (``"bank_copy"``, launches, and ``("bank_copy", "entries")`` and
    ``("bank_copy", "left")``, the pairs folded into them and left to
    ``copy_``), the Schur pair kernel's launches (``"schur_pairs"``), the
    list route's products over observations (``"obs_products"``, the
    kernel's launches, and ``("obs_products", kind)``, the product calls of
    each kind on any device), and the solver's ``("host_syncs", site)``,
    ``("all_false", site)``, ``("rescue_lanes", stage)`` and ``("schur",
    "assemble" | "pairs")``."""
    c = dict(spans.COUNTERS)
    c["host_syncs"] = sum(n for k, n in spans.COUNTERS.items() if isinstance(k, tuple) and k[0] == "host_syncs")
    return c


def _credit(delta: dict):
    """Add what a replayed graph's capture counted (``_capture``'s delta),
    but for the derived ``"host_syncs"``."""
    c = spans.COUNTERS
    for k, n in delta.items():
        if k != "host_syncs":
            c[k] = c.get(k, 0) + n


def restore_counters(before: dict):
    """Put the counters back to ``counters()``'s reading."""
    spans.COUNTERS.clear()
    spans.COUNTERS.update((k, n) for k, n in before.items() if k != "host_syncs")


class _Graph:
    def __init__(self, graph, delta):
        self.graph = graph
        self.delta = delta
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        if self.delta:
            _credit(self.delta)


# seconds spent capturing graphs, over every bank of the process
CAPTURE_SECONDS = [0.0]


def _capture(bank: Bank, name: str, fn) -> _Graph:
    before = counters()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    if bank._pool[0] is None:
        bank._pool[0] = torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.graph(graph, pool=bank._pool[0]):
            _store(bank, fn(bank), capturing=True)
    except Exception as e:  # noqa: BLE001 - re-raised with the segment named
        restore_counters(before)
        raise GraphCaptureError(
            f"{bank._label}: segment {name!r} cannot be captured as a CUDA graph "
            f"({type(e).__name__}: {e}); a residual or constraint that builds tensors "
            "from host data (torch.tensor(...), .item(), Python branches on values) must "
            "make them when the problem is built"
        ) from e
    after = counters()
    restore_counters(before)
    CAPTURE_SECONDS[0] += time.perf_counter() - t0
    delta = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    return _Graph(graph, delta)


def run_segment(bank: Bank, name: str, fn, eager: bool = False):
    """Run one segment ``fn(bank) -> {entry: value}`` on the bank's route."""
    bank.last = name
    if not bank._graphed:
        with span("cannoles.eager", {"segment": name}):
            bank.__dict__.update(fn(bank))
        return
    g = bank._graphs.get(name)
    if g is not None:
        with span("cannoles.replay", {"segment": name}):
            g.replay()
        return
    with span("cannoles.eager", {"segment": name}):
        _store(bank, fn(bank))  # the first run, eager: it also warms the libraries up
    if not eager:
        with span("cannoles.capture", {"segment": name}):
            bank._graphs[name] = _capture(bank, name, fn)
