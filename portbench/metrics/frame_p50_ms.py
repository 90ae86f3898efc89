"""frame_p50_ms: the median, over every call of the window, of the time
from the call until its outputs are where the caller reads them (on the
host after ``.cpu()``, or on the card after a synchronize).  Host clock."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 50)) * 1e3
