"""A bounded device trace of the window and what the metrics read from it.

:func:`record` runs a few calls under ``torch.profiler`` (CUPTI: the
card's kernels and copies, and the benchmark's own ``record_function``
spans on the host), writes the Chrome trace under ``TMPDIR``, reads it and
deletes it.  The arithmetic is the benchmark's own (a copy of what
``transform360_tpu_torch.utils.profiling.trace_kernels`` sums), so a
change to the program cannot change how its trace is read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
from typing import Callable, Dict, Iterable, List, Tuple

SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.window"
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: float  # microseconds, the trace's clock
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    """The device's kernels and copies that started inside the traced
    window, and the host's spans."""

    kernels: List[Event]
    copies: List[Event]
    spans: List[Event]
    window: Event
    file_bytes: int = 0  # the size of the Chrome trace it was read from

    @property
    def window_s(self) -> float:
        return self.window.dur / 1e6

    def kernel_seconds(self, names: Iterable[str]) -> Tuple[float, int]:
        """(summed device seconds, launches) of the kernels whose CUPTI name
        holds one of ``names`` as a whole identifier."""
        pats = [re.compile(r"(?<![A-Za-z0-9_])" + re.escape(n) + r"(?![A-Za-z0-9_])")
                for n in names]
        hits = [e for e in self.kernels if any(p.search(e.name) for p in pats)]
        return sum(e.dur for e in hits) / 1e6, len(hits)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's kernel and copy intervals, clipped to
        the window."""
        lo, hi = self.window.start, self.window.end
        iv = sorted((max(e.start, lo), min(e.end, hi)) for e in self.kernels + self.copies
                    if e.end > lo and e.start < hi)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The window's stretches with nothing on the device."""
        edges = [self.window.start]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window.end)
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_span_at(self, t: float) -> str:
        """The innermost benchmark span the host was in at ``t``."""
        inside = [s for s in self.spans if s.start <= t < s.end and s.name != WINDOW_SPAN]
        return min(inside, key=lambda s: s.dur).name if inside else "portbench.window (between spans)"

    def breakdown(self, most: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing, each as ``[name, seconds]``."""
        ops: Dict[str, float] = {}
        for e in self.kernels + self.copies:
            ops[short_name(e.name)] = ops.get(short_name(e.name), 0.0) + e.dur / 1e6
        idle: Dict[str, float] = {}
        for a, b in self.gaps():
            k = self.host_span_at(a)
            idle[k] = idle.get(k, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:most]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def short_name(name: str) -> str:
    """A kernel's CUPTI name without its return type, namespaces and
    template or call arguments (a copy's name as it is)."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void\s+", "", n)
    m = re.match(r"[A-Za-z_][A-Za-z0-9_:]*", n)
    return (m.group(0).split("::")[-1] if m else n)[:64]


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies, spans = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ev = Event(str(e.get("name", "")), float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
        kind = _DEVICE_CATS.get(e.get("cat"))
        if kind == "kernel":
            kernels.append(ev)
        elif kind == "copy":
            copies.append(ev)
        elif e.get("cat") == "user_annotation" and ev.name.startswith(SPAN_PREFIX):
            spans.append(ev)
    windows = [s for s in spans if s.name == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW_SPAN} spans, not 1")
    w = windows[0]

    def inside(evs):  # the device's work that started in the window
        return [e for e in evs if w.start <= e.start < w.end]

    return Trace(inside(kernels), inside(copies), spans, w, os.path.getsize(path))


def record(body: Callable[[], None], device, first: Callable[[], None]) -> Trace:
    """Trace ``body`` inside the span ``portbench.window``, after
    ``first`` has run under the profiler outside it (the profiler's own
    start-up would otherwise read as idle time at the window's start);
    the trace file lives under ``TMPDIR`` only until it has been read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
        raise RuntimeError("this PyTorch has no CUPTI tracing")
    d = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(d, "trace.json")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            first()
            torch.cuda.synchronize(device)
            with record_function(WINDOW_SPAN):
                body()
                torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        return parse(path)
    finally:
        shutil.rmtree(d, ignore_errors=True)
