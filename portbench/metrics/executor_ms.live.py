"""executor_ms.live: the host's time inside the plane executors' calls
(the program's span ``t360.executor``, the luma and the chroma executor
summed), per API call (span ``t360.transform``), over the traced window
and the call before it.  Layer: api + pipeline.  Moves ``frame_p50_ms``.
Program span; nothing where the program records no such span."""

from transform360_tpu_torch.utils import profiling

SPAN = "t360.executor"


def read(run):
    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    spans = traced().spans
    calls = {s.call for s in spans if s.name == "t360.transform"}
    ns = [s.end_ns - s.start_ns for s in spans if s.name == SPAN and s.call in calls]
    if not calls or not ns:
        return None
    return sum(ns) / len(calls) / 1e6
