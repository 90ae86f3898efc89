"""Tracing and timing of the card, and the CLI's per-batch statistics:
the counterparts of ``transform360_tpu.utils.profiling``.

* :func:`span` marks a stretch of the port's own call path (the API call,
  each plane executor's key, re-pointing and replay, each kernel
  wrapper's launch).  A span is on exactly while a torch profiler records
  in this process (``torch.profiler.profile``, :func:`device_trace`): it
  then enters a ``record_function`` named ``t360.<name>``, so that it lies
  in the profiler's Chrome trace beside CUPTI's kernels on the
  profiler's clock, and appends a record to an in-memory table
  (:func:`traced`).  Off, it costs one flag test.
* :data:`COUNTERS` counts events of the call path (kernel launches per
  sample width, graph node updates, plane copies) from the process's
  start: :func:`count` adds to it, a dict increment.  The table tallies
  what they counted while the profiler recorded.
* :func:`device_trace` records a ``torch.profiler`` trace (CPU and CUDA
  activity) into a Chrome trace file, where the JAX package records a
  ``jax.profiler`` trace; :func:`trace_kernels` sums its kernels by name.
* :func:`time_chain` and :func:`time_frame_step` are the chain-difference
  timers (``time_jitted`` and ``time_frame_step`` there): two chains of
  calls of different lengths, each ending with one synchronize, and the
  difference of their minima over the difference of their lengths, so
  the fixed costs of a chain (its first launch, the synchronize) cancel.
* :class:`StageStats`: the CLI's JSON stats line.

The span names: ``t360.transform`` (``Transform360.transform``, one per
API call), ``t360.executor`` (a plane executor's call), inside it
``t360.executor.key`` (the plane checks, the planes' descriptions, the
graph key and its lookup), ``t360.executor.repoint`` (the graph's nodes
re-pointed at the caller's planes and a fresh output),
``t360.executor.replay`` (``CUDAGraph.replay`` alone),
``t360.executor.stage`` (a host plane copied into a graph's buffer) and
``t360.executor.capture`` (a graph captured, once per kind of call), and
``t360.k1.launch``, ``t360.k3.launch``, ``t360.k4.launch`` (the kernel
wrappers ``blur_px``, ``remap_window_px``, ``area_px``: checks, output
allocation and launch, or the plain version on the CPU).  The counters:
``blur.launches``, ``window.launches``, ``area.launches`` (uint8),
``window.tiles`` and ``window.tiles_wide`` (K3's tiles, and those of its
launches of more than two frames a pass), their ``_u16`` twins,
``nodes.updates`` and ``pipeline.plane_copies``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _torch_profiler

# Where torch's fast record_function is missing, the plain one (slower,
# but the same span in the trace).
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function

# The table holds at most this many span records per profiler session;
# the spans past it are counted in ``Traced.dropped``.
TABLE_RECORDS = 1 << 20

# Events of the call path since the process started, by name (a missing
# name reads 0).
COUNTERS: "collections.Counter[str]" = collections.Counter()


class Record(NamedTuple):
    """One span: its name (``t360.<name>``), its start and end
    (``time.perf_counter_ns``), the index of the span it lies in (-1:
    none, or one the table did not keep), and its call: the index of the
    outermost span it lies in (its own, for an outermost span), so that
    the spans of one API call share it."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int


class Traced(NamedTuple):
    """What the table holds: the spans that ended, in the order they were
    entered; what each counter counted while the profiler recorded (only
    those that moved); and the spans past the table's bound that it did
    not keep."""

    spans: List[Record]
    counts: Dict[str, int]
    dropped: int


class _Table:
    """The spans since a profiler session began, each kept as it ends:
    (entry number, name, start, end, entry number of the span it lies in,
    of its outermost span); and the counters as they stood when the
    session began and when it ended (``None`` while it records)."""

    def __init__(self, ended: bool = False):
        self.entries = itertools.count()
        self.spans: List[tuple] = []
        self.dropped = 0
        self.lock = threading.Lock()  # for ``dropped``
        self.counted = dict(COUNTERS)
        self.counted_end: Optional[Dict[str, int]] = self.counted if ended else None


_TABLE = _Table(ended=True)  # no session yet
_LOCAL = threading.local()  # .open: this thread's open spans, innermost last
_now = time.perf_counter_ns


class _Off:
    """The span while no profiler records: it does nothing, and entering
    and leaving it run no Python code (``"".format`` takes any arguments
    and returns ``""``, which lets an exception through)."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Span:
    """The span while a profiler records: a ``record_function``, and a
    record in the table as it ends."""

    __slots__ = ("_name", "_rf", "_table", "_entry", "_outer", "_call", "_start")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        rf = self._rf = _RecordFunction(self._name)
        rf.__enter__()
        try:
            opened = _LOCAL.open
        except AttributeError:
            opened = _LOCAL.open = []
        t = self._table = _TABLE
        entry = self._entry = next(t.entries)
        outer = opened[-1] if opened else None
        if outer is not None and outer._table is t:
            self._outer, self._call = outer._entry, outer._call
        else:
            self._outer, self._call = -1, entry
        opened.append(self)
        self._start = _now()

    def __exit__(self, exc_type, exc, tb):
        end = _now()
        t = self._table
        if len(t.spans) < TABLE_RECORDS:
            t.spans.append((self._entry, self._name, self._start, end, self._outer, self._call))
        else:
            with t.lock:
                t.dropped += 1
        _LOCAL.open.pop()
        self._rf.__exit__(exc_type, exc, tb)
        return False


def span(name: str):
    """A context manager around a stretch of the call path, named
    ``t360.<name>``: on while a torch profiler records in this process
    (see the module's docstring), else a no-op."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span("t360." + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] += n


def traced() -> Traced:
    """The spans and counter tallies recorded since the profiler last came
    on (or those of the last session, after it ended)."""
    t = _TABLE
    kept = sorted(t.spans)
    index = {r[0]: i for i, r in enumerate(kept)}
    spans = [Record(name, start, end, index.get(outer, -1), index.get(call, -1))
             for _, name, start, end, outer, call in kept]
    end = COUNTERS if t.counted_end is None else t.counted_end
    counts = {k: n - t.counted.get(k, 0) for k, n in end.items() if n != t.counted.get(k, 0)}
    return Traced(spans, counts, t.dropped)


def self_ns(spans: List[Record], i: int) -> int:
    """Span ``i``'s nanoseconds less those of the spans directly inside it."""
    s = spans[i]
    return (s.end_ns - s.start_ns) - sum(c.end_ns - c.start_ns for c in spans if c.parent == i)


def _new_table() -> None:
    global _TABLE
    _TABLE = _Table()


def _end_table() -> None:
    _TABLE.counted_end = dict(COUNTERS)


def _follow_sessions() -> None:
    """Start the table anew as each profiler session starts, and close its
    tallies as it ends: torch calls ``_run_on_profiler_start`` and
    ``_run_on_profiler_stop`` of ``torch.autograd.profiler`` there, to
    raise and lower the flag that :func:`span` reads."""
    for hook, ours in (("_run_on_profiler_start", _new_table),
                       ("_run_on_profiler_stop", _end_table)):
        torch_hook = getattr(_torch_profiler, hook, None)
        if torch_hook is not None:

            def run(torch_hook=torch_hook, ours=ours):
                ours()
                torch_hook()

            setattr(_torch_profiler, hook, run)


_follow_sessions()


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Record a ``torch.profiler`` trace of the block into a Chrome trace
    file in ``log_dir`` (open it in Perfetto or ``chrome://tracing``).

    Yields the trace file's path; the file is written when the block
    exits.  On ``device="cuda"`` it traces CPU and CUDA activity and
    synchronizes before the trace stops; without a card, or a PyTorch
    without CUPTI tracing, it raises rather than record a trace of the
    CPU alone.  ``device="cpu"`` traces CPU activity only.  The call
    path's spans (:func:`span`) are on while it records, and
    :func:`traced` then holds the block's spans.
    """
    from torch.profiler import ProfilerActivity, profile

    d = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace(device='cuda') but torch.cuda.is_available() is False")
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("device_trace(device='cuda'): this PyTorch has no CUPTI tracing")
        activities.append(ProfilerActivity.CUDA)
    elif d.type != "cpu":
        raise ValueError(f"device_trace traces 'cuda' or 'cpu', not {d.type!r}")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    prof.export_chrome_trace(path)


def trace_kernels(path: str) -> Dict[str, Tuple[int, float]]:
    """``{name: (count, total_ms)}`` of the card's kernels (as CUPTI names
    them) in a Chrome trace written by :func:`device_trace`."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: Dict[str, Tuple[int, float]] = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            n, ms = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, ms + float(e.get("dur", 0.0)) / 1e3)
    return out


def _fence(x: torch.Tensor) -> None:
    """Wait for the work queued on ``x``'s device (the CPU's ops are
    synchronous)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _chain_seconds(step: Callable[[], object], fence: Callable[[], None], n_short: int,
                   n_long: int, repeats: int) -> float:
    def run(n):
        fence()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        fence()
        return time.perf_counter() - t0

    run(n_short)  # warm-up: the first calls build tables and load kernels
    run(n_long)
    ts = min(run(n_short) for _ in range(repeats))
    tl = min(run(n_long) for _ in range(repeats))
    return max(tl - ts, 1e-9) / (n_long - n_short)


def time_chain(
    fn: Callable,
    x: torch.Tensor,
    n_short: int = 2,
    n_long: int = 18,
    repeats: int = 3,
) -> float:
    """Steady-state seconds per call of ``fn(x)`` issued back to
    back on ``x``'s device (``time_jitted`` of the JAX package).

    Each chain issues ``n`` calls and ends with one synchronize.  The
    calls carry no data dependency: in JAX, ``y = y + d`` keeps XLA from
    merging identical calls, but eager PyTorch runs every call, and one
    stream runs them in order; a dependency through a whole plane would
    add its own pass over the plane to every step.  So where the host
    issues calls more slowly than the card runs them (one 4K frame), this
    reads the host's issue rate, and a replayed CUDA graph reads the
    card's time instead.
    """
    return _chain_seconds(lambda: fn(x), lambda: _fence(x), n_short, n_long, repeats)


def time_frame_step(
    plan,
    y,
    u=None,
    v=None,
    n_short: int = 2,
    n_long: int = 26,
    repeats: int = 3,
) -> float:
    """Steady-state seconds per full-frame step (every plane) of
    :func:`..pipeline.transform_batch` on the planes' device: a chain of
    the plane executors' calls (replays of their CUDA graphs at batches
    of at most ``pipeline.GRAPH_MAX_BATCH`` frames, eager launches above).

    The chain-difference method of :func:`time_chain` (no data dependency
    between steps, one synchronize per chain).  Tensors stay on their own
    device; numpy planes are copied to the card once, before timing."""
    from ..pipeline import as_plane, transform_batch

    planes = [as_plane(p, "cuda") for p in (y, u, v) if p is not None]
    return _chain_seconds(lambda: transform_batch(plan, *planes), lambda: _fence(planes[0]),
                          n_short, n_long, repeats)


class StageStats:
    """Structured per-batch throughput logging."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self.frames = 0
        self.batches = 0
        self.seconds = 0.0

    def record(self, n_frames: int, seconds: float) -> None:
        """``seconds`` is the time spent BLOCKED waiting for device
        results; with overlapped IO the compute hidden behind host work
        is excluded by design."""
        self.frames += n_frames
        self.batches += 1
        self.seconds += seconds

    def emit(self, wall_seconds: Optional[float] = None, **extra) -> None:
        """One JSON line.  ``fps`` is end-to-end (frames / wall_seconds)
        when a wall time is given; otherwise frames / blocked time."""
        denom = wall_seconds if wall_seconds is not None else self.seconds
        payload = {
            "frames": self.frames,
            "batches": self.batches,
            # "seconds" kept as an alias of blocked_seconds, as in the
            # JAX package's schema
            "seconds": round(self.seconds, 4),
            "blocked_seconds": round(self.seconds, 4),
            "fps": round(self.frames / denom, 2) if denom else None,
            **({"wall_seconds": wall_seconds} if wall_seconds is not None else {}),
            **extra,
        }
        print(json.dumps(payload), file=self.stream)
