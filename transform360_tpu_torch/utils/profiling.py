"""Per-batch throughput statistics of the CLI (``StageStats`` of
``transform360_tpu.utils.profiling``; its jax profiler and chain timers
have no counterpart here: the port times the card with CUDA events in
``chip_smoke.py``)."""

from __future__ import annotations

import json
import sys
from typing import Optional


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
