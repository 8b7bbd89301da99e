"""One run of one cell: set-up, the measured window, the traced slice, the
judgement against the plain reference, and the result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, process start to the first timed call): the program's
kernels are built or loaded, the inputs are drawn from the seed on the card,
the program's problem and solver are built and every input of the bank runs
once.  The window then runs calls back to back, each ending in
``torch.cuda.synchronize()``, in whole passes over the bank, and ends with
the first pass that ends after ``--seconds``.  ``--trace 1`` runs the same
window (its program counters give the counter metrics) and then a profiled
slice of further calls, the mix's ``slice_calls``; a run of a configuration
whose checks read the card's operations (``tensor_core_ops``,
``common/tensor_cores.py``) profiles that slice whatever ``--trace`` says.
The slice replays what set-up built: a rank that captures a graph inside
it gives no result.
Once the window and the slice are over, the peak device memory is read, the
program's solver is freed, and the configuration's plain reference judges
every output of the window and the slice.

A cell on k > 1 cards runs the same steps as k ranks in lockstep, one per
card (``common/ranks.py``); rank 0's clock, counters and traced slice give
the metrics, and rank 0 judges the outputs, which every rank holds whole.

The last line on stdout is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit, also printed as the
last lines on stderr.  A run on a machine without the cards the cell asks
for, or whose process holds JAX or the JAX package once the window has
closed, prints no result and exits nonzero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import sys
import time
from types import SimpleNamespace

from .peaks import for_device
from .tensor_cores import PATTERN, reduced_precision_ops

__all__ = ["main", "parser", "Run", "Solo", "measure", "report"]

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
EXIT_SETUP = 5
EXIT_CAPTURED = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def _quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of ``values``, linear between order
    statistics (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[round(q * 100) - 1]


class Solo:
    """The ranks of a run in one process: rank 0 of 1.  ``first(flag)``
    gives every rank rank 0's flag, ``all(flag)`` whether every rank's flag
    is set; ``barrier()`` waits for every rank (``ranks.Team`` on k ranks)."""

    rank, size = 0, 1

    def first(self, flag: bool) -> bool:
        return flag

    def all(self, flag: bool) -> bool:
        return flag

    def barrier(self):
        pass


class Run:
    """A cell's set-up and window, callable piece by piece (the tests and
    the readings of ``tests/readings.py`` drive it without ``main``)."""

    def __init__(self, cell, device, seed: int, control: str = None):
        import torch

        from .mix import Mix

        self.cell, self.device, self.seed = cell, device, seed
        self.reference = cell.reference()
        self.mix = Mix(cell, device, seed, control=control, reference=self.reference)
        self.spans = torch.profiler.record_function
        self.outputs = []  # (input, output) of every call of the window and the slice

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        """Every input of the bank once (set-up: the shapes and graphs the
        window replays)."""
        for item in self.mix.bank:
            self.mix.call(item)
        self.sync()

    def call(self, k: int, inputs=None):
        """One timed call on input ``k`` of ``inputs`` (default: the bank):
        its wall in seconds."""
        inputs = self.mix.bank if inputs is None else inputs
        t0 = time.perf_counter()
        with self.spans("portbench.draw"):
            item = inputs[k % len(inputs)]
        with self.spans(f"portbench.{self.mix.kind}"):
            out = self.mix.call(item)
        with self.spans("portbench.synchronize"):
            self.sync()
        wall = time.perf_counter() - t0
        self.outputs.append((item, out))
        return wall

    def window(self, seconds: float, first):
        """Calls back to back in whole passes over the bank, until a pass
        ends after ``seconds``: (walls, the window's seconds).  Whole passes
        make the window's work the same whatever the order of the bank.
        ``first(flag)``: rank 0's decision at each pass's end, which every
        rank follows (``Solo.first``), so that every rank makes as many calls."""
        walls, k, K = [], 0, len(self.mix.bank)
        t_start = time.perf_counter()
        while True:
            walls.append(self.call(k))
            k += 1
            if k % K == 0 and first(time.perf_counter() - t_start >= seconds):
                break
        return walls, time.perf_counter() - t_start

    def solved(self, out) -> int:
        import torch

        st = out["status"]
        return int(((st == 1) | (st == 2)).sum().to(torch.int64))

    def reads_the_trace(self) -> bool:
        """Whether a check of the configuration reads the card's operations."""
        return "tensor_core_ops" in self.cell.config["checks"]

    def judge(self, sl=None) -> dict:
        """The numbers compared: the reference's judgement of every output,
        those of a file's entry (``Mix.judge``), and where the configuration
        checks it, the reduced-precision operations of the profiled slice
        ``sl``."""
        numbers = self.reference.judge(self.outputs, self.cell.config, self.mix.shared)
        numbers.update(self.mix.judge(self.outputs))
        if self.reads_the_trace():
            numbers["tensor_core_ops"] = reduced_precision_ops(sl, self.device)
            if numbers["tensor_core_ops"]:
                names = sorted({name for name, _, _ in sl.device_ops if PATTERN.search(name)})
                log(f"# {len(names)} reduced-precision kernels in the slice, e.g. {names[0]}")
        return numbers

    def limits(self) -> dict:
        """Each number compared and its limit: the configuration's checks,
        then those of a file's entry."""
        limits = {name: spec.get("limit") for name, spec in self.cell.config["checks"].items()}
        limits.update(self.mix.limits())
        return limits


def _checks(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): each number against its limit; a
    number with no reading, or with no limit set, is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, checks


def _read_counters():
    """The program's counters that a run reads: the fused LDLT kernel's
    launches (graph replays included) and the seconds spent capturing graphs."""
    from cannoles_tpu_torch.core import segments

    return {"fused_ldlt": segments.counters()["fused_ldlt"], "capture_s": segments.CAPTURE_SECONDS[0]}


def checksum(pairs) -> str:
    """A digest of the outputs of ``pairs`` of (input, output), every bit
    of every tensor: the ranks of a run compare theirs."""
    import torch

    h = hashlib.sha256()
    for _, out in pairs:
        for key in sorted(out):
            v = out[key]
            if isinstance(v, torch.Tensor):
                h.update(f"{key} {tuple(v.shape)} {v.dtype}".encode())
                h.update(v.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
            else:
                h.update(f"{key} {json.dumps(v, sort_keys=True)}".encode())
    return h.hexdigest()


def main(argv=None, *, root: pathlib.Path = None, require=None, control: str = None, prepare=None) -> int:
    """One run; returns the exit code.  ``root`` holds ``BENCHMARK.json``
    (default: the checkout this file lies in); ``require(chips)`` gives the
    device (default: ``card.require``, the card or ``NoCard``); ``control``
    names a control of the configuration to run in the program's place;
    ``prepare()``, a function importable by name, runs in the process of
    each rank before its set-up (the tests plant faults with it)."""
    args = parser().parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[2] if root is None else pathlib.Path(root)
    from . import card, guard
    from .manifest import Manifest

    start = card.process_start_s()
    phases = {"python and torch": card.since(start)}  # set-up's parts, for its log line
    cell = Manifest(root).cell(args.workload)
    try:
        device = (require or card.require)(cell.chips)
    except card.NoCard as e:
        log(f"# no result: {e}")
        return EXIT_NO_CARD
    import torch

    phases["card"] = card.since(start)
    import cannoles_tpu_torch

    where = pathlib.Path(cannoles_tpu_torch.__file__).absolute()
    if root.absolute() not in where.parents:
        log(f"# no result: the program was imported from {where}, not from this checkout ({root})")
        return EXIT_SETUP
    bad = guard.forbidden_modules()
    if bad:
        log(f"# no result: the process holds {', '.join(bad)} after the program's imports")
        return EXIT_FORBIDDEN
    phases["program"] = card.since(start)
    if device.type == "cuda":
        from cannoles_tpu_torch.ops import _native

        _native.load()  # before any profiler session, and before ranks start: they find it built
    phases["kernels"] = card.since(start)
    if cell.chips > 1:
        from .ranks import run_ranks

        return run_ranks(args, root, cell, device, control, prepare, start, phases)
    if prepare is not None:
        prepare()
    log(f"# cell {cell.name}, seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"card {card.kind(device)}; torch {torch.__version__}")
    return report(measure(args, cell, device, control, start, phases, Solo()))


def measure(args, cell, device, control, start: float, phases: dict, team) -> dict:
    """One rank's run (``team``: its place among the ranks, ``Solo`` for
    one): set-up, window, slice, and on rank 0 the judgement.  Returns the
    rank's outcome: the forbidden modules its process holds, its peak
    memory and slice's busy seconds, with several ranks a checksum of its
    outputs, and on rank 0 the result line and the checks' lines."""
    import torch

    from . import card, guard

    lead = team.rank == 0
    run = Run(cell, device, args.seed, control=control)
    phases["inputs and solver"] = card.since(start)
    run.warm()
    team.barrier()
    setup_s = card.since(start)
    phases["warm"] = setup_s
    marks = list(phases.items())
    if lead:
        log(f"# set-up {setup_s:.3f} s (bank of {len(run.mix.bank)} inputs of {run.mix.batch}): "
            + ", ".join(f"{name} {t - (marks[k - 1][1] if k else 0.0):.3f}" for k, (name, t) in enumerate(marks)))

    syncs0 = run.mix.solver.host_syncs
    counters0 = _read_counters()
    walls, window_s = run.window(args.seconds, team.first)
    counters1 = _read_counters()
    syncs = run.mix.solver.host_syncs - syncs0
    calls = len(walls)
    window_outputs = [out for _, out in run.outputs]
    if lead:
        slowest = sorted(range(calls), key=lambda i: -walls[i])[:3]
        log(f"# window {window_s:.3f} s, {calls} calls ({window_s - sum(walls):.4f} s outside them; slowest "
            + ", ".join(f"#{i} {walls[i]:.4f} s" for i in slowest)
            + f"); graph captures inside it {counters1['capture_s'] - counters0['capture_s']:.3f} s")

    sl = window_span = None
    slice_capture_s = 0.0
    if args.trace or run.reads_the_trace():
        capture0 = _read_counters()["capture_s"]
        sl, window_span = _slice(run, device, team.all)
        slice_capture_s = _read_counters()["capture_s"] - capture0
        log(f"# rank {team.rank}: graph captures inside the slice {slice_capture_s:.3f} s")

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run.mix.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    kind = card.kind(device)
    if lead:
        log(f"# card {kind}, power limit {card.power_limit(device)}")
    outcome = {"rank": team.rank, "forbidden": guard.forbidden_modules(), "peak": int(peak),
               "busy_s": None if sl is None else sl.busy_s, "slice_capture_s": slice_capture_s}
    if team.size > 1:
        outcome["checksum"] = checksum(run.outputs)
    if outcome["forbidden"] or not lead:
        return outcome

    unit = run.mix.batch
    solved = sum(run.solved(out) for out in window_outputs)
    attempted = calls * unit
    result = {"correct": False, "attempted": attempted, "failed": attempted - solved}
    metrics = {}
    if args.trace:
        ctx = SimpleNamespace(
            calls=calls, solves=attempted, host_syncs=syncs, lanes=slice(0, unit // team.size),
            counters={k: counters1[k] - counters0[k] for k in counters1},
            slice=sl, config=cell.config, peaks=for_device(kind), log=log,
        )
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {
            "setup_s": setup_s,
            "instances_per_s": solved / window_s,
            "solve_ms": 1e3 * window_s / calls,
            "solve_p95_ms": 1e3 * _quantile(walls, 0.95),
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": kind, "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace and sl is not None:
        result["device"].update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["breakdown"] = {"device_ops": [list(kv) for kv in sl.op_seconds()[:10]],
                               "idle_gaps": [list(kv) for kv in sl.idle_gaps(window_span)[:10]]}

    t0 = time.perf_counter()
    numbers = run.judge(sl)
    ok, checks = _checks(numbers, run.limits())
    result["correct"] = ok
    result["checks"] = checks
    log(f"# judged {len(run.outputs)} calls in {time.perf_counter() - t0:.3f} s")
    outcome.update(result=result, lines=[f"check {name} {c['value']} limit {c['limit']}" for name, c in checks.items()])
    return outcome


def report(outcome: dict) -> int:
    """Rank 0's outcome as the run's last lines: the checks on stderr, the
    result on stdout; no result where the process holds a forbidden module,
    or where the slice captured graphs (it would not read the path that the
    window replays)."""
    from . import guard

    bad = sorted(set(outcome["forbidden"]) | set(guard.forbidden_modules()))
    if bad:
        log(f"# no result: the process holds {', '.join(bad)} once the window has closed")
        return EXIT_FORBIDDEN
    if outcome["slice_capture_s"] > 0:
        log(f"# no result: graph captures inside the traced slice {outcome['slice_capture_s']:.3f} s")
        return EXIT_CAPTURED
    for line in outcome["lines"]:
        log(line)
    print(json.dumps(outcome["result"]), flush=True)
    return 0


def _slice(run, device, agree=None):
    """The profiled slice after the window: the mix's ``slice_calls``
    calls on its first inputs as drawn (``Mix.slice``).  None off the card.
    ``agree(flag)``: whether every rank's flag is set (``Solo.all``), so
    that every rank profiles as many sessions."""
    import torch

    from .profiling import profile_device
    from .trace import reduce_events

    if device.type != "cuda":
        return None, None
    start = len(run.outputs)

    def fn():
        torch.cuda.synchronize()  # the spin before the session is no part of the slice
        del run.outputs[start:]
        with torch.profiler.record_function("portbench.slice"):
            for k in range(len(run.mix.slice)):
                run.call(k, run.mix.slice)
        return len(run.mix.slice)

    calls, events, _ = profile_device(fn, "the traced slice", log=log, agree=agree)
    if events is None:
        log("# torch.profiler does not trace this card: the slice's metrics are not measured")
        return None, None
    outs = [out for _, out in run.outputs[start:]]
    sl, span = reduce_events(events, outs, calls)
    log(f"# slice {sl.window_s:.3f} s, {calls} calls, busy {sl.busy_s:.4f} s, "
        f"{len(sl.device_ops)} device operations")
    return sl, span
