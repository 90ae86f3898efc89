"""issue_ms.live: the host's time inside ``Transform360.transform``, from
the call to its return, mean per call over the window (one frame a call
in the live cells).  Layer: api + pipeline (``api.Transform360.transform``,
``pipeline.transform_batch``, the plane executors, ``ops.nodes``).  Moves
``frame_p50_ms``.  Host clock."""

import statistics


def read(run):
    if run.traffic["wait"] != "call" or not run.issue_s:
        return None
    return statistics.fmean(run.issue_s) * 1e3
