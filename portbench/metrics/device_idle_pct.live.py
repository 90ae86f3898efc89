"""device_idle_pct.live: the share of the traced window in which no kernel
and no copy ran on the card, in percent.  Layer: device.  Moves
``frame_p50_ms``.  Device trace."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
