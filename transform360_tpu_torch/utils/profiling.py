"""Tracing and timing of the card, and the CLI's per-batch statistics:
the counterparts of ``transform360_tpu.utils.profiling``.

* :func:`device_trace` records a ``torch.profiler`` trace (CPU and CUDA
  activity) into a Chrome trace file, where the JAX package records a
  ``jax.profiler`` trace; :func:`trace_kernels` sums its kernels by name.
* :func:`time_chain` and :func:`time_frame_step` are the chain-difference
  timers (``time_jitted`` and ``time_frame_step`` there): two chains of
  calls of different lengths, each ending with one synchronize, and the
  difference of their minima over the difference of their lengths, so
  the fixed costs of a chain (its first launch, the synchronize) cancel.
* :class:`StageStats`: the CLI's JSON stats line.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Record a ``torch.profiler`` trace of the block into a Chrome trace
    file in ``log_dir`` (open it in Perfetto or ``chrome://tracing``).

    Yields the trace file's path; the file is written when the block
    exits.  On ``device="cuda"`` it traces CPU and CUDA activity and
    synchronizes before the trace stops; without a card, or a PyTorch
    without CUPTI tracing, it raises rather than record a trace of the
    CPU alone.  ``device="cpu"`` traces CPU activity only.
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
