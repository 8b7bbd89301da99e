"""The port's spans and counters.

* :func:`span`: a named range of the host's work, recorded while a
  ``torch.profiler`` session runs and nothing but one
  ``_profiler_enabled()`` check otherwise (no name or args string is
  built).  Turning tracing on means running a profiler session.  The ranges
  are the profiler's function events (``_RecordFunctionFast``), so they
  share the device trace's clock, and an idle gap of the card can be put
  down to the innermost span open on the host at its start.  They are not
  user annotations: a ``record_function`` range also comes back as a
  device-side annotation spanning the kernels launched inside it, which a
  reader of the device's operations would count as busy time.  Every name
  starts with ``cannoles.``; variable data (lanes, B, a segment's name, a
  call number) goes in ``args``, a dict of ints, floats, bools and strings,
  which the profiler keeps as the event's keyword inputs under
  ``record_shapes=True``.
* The process's counts, in one registry, :data:`COUNTERS`, by key, counted
  with tracing on or off (one dict increment) and read through
  ``core.segments.counters()``.  A module that counts declares its keys
  that read 0 before their first count (:func:`declare`) and counts with
  :func:`count`: the custom kernels' launches by name (``ops/``), and the
  keys of the solver's layers, ``(kind, name)``:

  - ``("host_syncs", site)``: the host syncs by site, ``check:<segment>``
    for each host check of the dense solver, named after the segment whose
    flags it reads, ``check:matfree.<loop>`` for the matrix-free solver's,
    and ``rescue.status`` for each read of the lanes' statuses by
    ``vsolve``'s rescue.  Every solver of the process counts here, the
    rescue's siblings included, so the sum is the process's host syncs;
  - ``("all_false", site)``: the checks whose flags were all false (no lane
    took the branch);
  - ``("rescue_lanes", stage)``: the lanes that each rescue stage re-ran;
  - ``("schur", "assemble" | "pairs")``: the camera-Schur engine's camera
    systems assembled (one a lane per ρ attempt) and the pair blocks
    X_i W_jᵀ summed into them on an observation list (``core/ba.py``).

  The engine's spans: ``cannoles.schur.blocks`` (per-observation blocks, U,
  V, W, the right-hand side), ``.assemble`` (V⁻¹, X, the pair sums, S),
  ``.factor`` (the scaling and Cholesky of S) and ``.solve``
  (substitutions, refinement, the backward-error gate).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "count", "count_check", "declare", "COUNTERS"]

_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

# every count of the process since it started, by key
COUNTERS: dict = {}
# a segment's ("host_syncs", "check:<segment>") and ("all_false", ...) keys,
# so that a check builds no string or tuple
_SITES: dict = {}
_OFF = contextlib.nullcontext()


def span(name: str, args: dict = None):
    """A context manager: the profiler's range ``name`` (with ``args``)
    while a profiler session runs, else a shared object that does nothing."""
    if not _enabled():
        return _OFF
    return _Range(name) if args is None else _Range(name, [], args)


def declare(*keys):
    """Let each of ``keys`` read 0 before its first count."""
    for key in keys:
        COUNTERS.setdefault(key, 0)


def count(key, n: int = 1):
    """Add ``n`` to the count ``key``."""
    COUNTERS[key] = COUNTERS.get(key, 0) + n


def count_check(segment: str, hit: bool):
    """Count one host check of ``segment``'s flags; ``hit``: any flag set."""
    keys = _SITES.get(segment)
    if keys is None:
        site = f"check:{segment}"
        keys = _SITES[segment] = (("host_syncs", site), ("all_false", site))
    COUNTERS[keys[0]] = COUNTERS.get(keys[0], 0) + 1
    if not hit:
        COUNTERS[keys[1]] = COUNTERS.get(keys[1], 0) + 1
