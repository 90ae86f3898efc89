"""frame_p95_ms: the 95th percentile of the per-call latency of
``frame_p50_ms``, over every call of the window.  Host clock."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
