"""launch_ms.batch: the host's time in the kernel wrappers (the program's
spans ``t360.k1.launch``, ``t360.k3.launch``, ``t360.k4.launch``:
``blur_px``, ``remap_window_px``, ``area_px`` -- their checks, the output's
allocation and the launch), summed per API call (span
``t360.transform``), over the traced window and the call before it.
Layer: kernel wrappers.  Moves ``frames_per_s``.  Program span; nothing
where the program records no such span."""

from transform360_tpu_torch.utils import profiling

SPANS = ("t360.k1.launch", "t360.k3.launch", "t360.k4.launch")


def read(run):
    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    spans = traced().spans
    calls = {s.call for s in spans if s.name == "t360.transform"}
    ns = [s.end_ns - s.start_ns for s in spans if s.name in SPANS and s.call in calls]
    if not calls or not ns:
        return None
    return sum(ns) / len(calls) / 1e6
