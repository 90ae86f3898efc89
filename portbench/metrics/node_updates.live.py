"""node_updates.live: the graph kernel nodes re-pointed (the program's
counter ``nodes.updates``, tallied while the profiler recorded), per API
call (span ``t360.transform``), over the traced window and the call
before it.  Layer: api + pipeline.  Moves ``frame_p50_ms``.  Program
counter; nothing where no graph was re-pointed (no span
``t360.executor.repoint``: an eager run)."""

from transform360_tpu_torch.utils import profiling


def read(run):
    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    t = traced()
    calls = {s.call for s in t.spans if s.name == "t360.transform"}
    if not calls or not any(s.name == "t360.executor.repoint" for s in t.spans):
        return None
    return t.counts.get("nodes.updates", 0) / len(calls)
