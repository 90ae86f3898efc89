"""frames_per_s: every frame the window completed over the window's
length, which ends at a synchronize after the last call (closed loop of
back-to-back calls).  Host clock."""


def read(run):
    if run.traffic["wait"] != "end" or run.window_s <= 0:
        return None
    return run.frames / run.window_s
