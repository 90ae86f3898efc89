"""transform_max_ms.batch: the longest single API call (the program's span
``t360.transform``, ``Transform360.transform``) over the traced window and
the call before it: a host pause long enough to drain the card's queue
shows here.  Layer: api + pipeline.  Moves ``frames_per_s``.  Program
span; nothing where the program records no such span."""

from transform360_tpu_torch.utils import profiling


def read(run):
    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    ns = [s.end_ns - s.start_ns for s in traced().spans if s.name == "t360.transform"]
    return max(ns) / 1e6 if ns else None
