"""The port's spans and host-sync counts.

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
* The host syncs by site, counted with tracing on or off (one dict
  increment): ``check:<segment>`` for each host check of the dense
  solver, named after the segment whose flags it reads, and
  ``check:matfree.<loop>`` for the matrix-free solver's; ``rescue.status``
  for each read of the lanes' statuses by ``vsolve``'s rescue.  Every
  solver of the process counts here, the rescue's siblings included, so the
  sum is the process's host syncs.  ``ALL_FALSE`` counts the checks whose
  flags were all false (no lane took the branch), by site;
  ``RESCUE_LANES`` the lanes that each rescue stage re-ran.  Read them
  through ``core.segments.counters()`` (``COUNTS`` names them there).
* The camera-Schur engine's work (``core/ba.py``), also counted with
  tracing on or off: ``SCHUR["assemble"]`` the camera systems assembled (one
  a lane per ρ attempt) and ``SCHUR["pairs"]`` the pair blocks X_i W_jᵀ
  summed into them on an observation list, read as ``("schur", ...)``.
  Its spans: ``cannoles.schur.blocks`` (per-observation blocks, U, V, W, the
  right-hand side), ``.assemble`` (V⁻¹, X, the pair sums, S),
  ``.factor`` (the scaling and Cholesky of S) and ``.solve``
  (substitutions, refinement, the backward-error gate).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "count_check", "count_read", "count_rescue", "count_schur", "SYNCS", "ALL_FALSE", "RESCUE_LANES",
           "SCHUR", "COUNTS"]

_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

# host syncs by site, since the process started
SYNCS: dict = {}
# of the checks, those whose flags were all false, by site
ALL_FALSE: dict = {}
# lanes re-run by rescue stage
RESCUE_LANES: dict = {}
# the Schur engine's camera systems and pair blocks
SCHUR: dict = {}
# the counts by their name in ``core.segments.counters()``
COUNTS = {"host_syncs": SYNCS, "all_false": ALL_FALSE, "rescue_lanes": RESCUE_LANES, "schur": SCHUR}
# "check:<segment>" by segment, so that a check builds no string
_SITES: dict = {}
_OFF = contextlib.nullcontext()


def span(name: str, args: dict = None):
    """A context manager: the profiler's range ``name`` (with ``args``)
    while a profiler session runs, else a shared object that does nothing."""
    if not _enabled():
        return _OFF
    return _Range(name) if args is None else _Range(name, [], args)


def count_check(segment: str, hit: bool):
    """Count one host check of ``segment``'s flags; ``hit``: any flag set."""
    site = _SITES.get(segment)
    if site is None:
        site = _SITES[segment] = f"check:{segment}"
    SYNCS[site] = SYNCS.get(site, 0) + 1
    if not hit:
        ALL_FALSE[site] = ALL_FALSE.get(site, 0) + 1


def count_read(site: str):
    """Count one host read of the device outside the checks."""
    SYNCS[site] = SYNCS.get(site, 0) + 1


def count_rescue(stage: str, lanes: int):
    """Count the ``lanes`` that one pass of rescue ``stage`` re-runs."""
    RESCUE_LANES[stage] = RESCUE_LANES.get(stage, 0) + lanes


def count_schur(kind: str, n: int):
    """Count ``n`` of the Schur engine's ``kind`` (``"assemble"``, ``"pairs"``)."""
    SCHUR[kind] = SCHUR.get(kind, 0) + n
