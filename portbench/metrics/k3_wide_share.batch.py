"""k3_wide_share.batch: the share of K3's tiles, over its launches in the
traced window and the call before it, that were staged more than two
frames a pass (the program's counters ``window.tiles_wide`` over
``window.tiles``, each with its ``_u16`` twin), in percent.  Layer: K3
(``ops.window``, ``csrc/window.cu``).  Moves ``frames_per_s``.  Program
counter; nothing where the program counts no K3 tiles."""

from transform360_tpu_torch.utils import profiling


def read(run):
    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    counts = traced().counts
    tiles = counts.get("window.tiles", 0) + counts.get("window.tiles_u16", 0)
    if not tiles:
        return None
    wide = counts.get("window.tiles_wide", 0) + counts.get("window.tiles_wide_u16", 0)
    return 100.0 * wide / tiles
