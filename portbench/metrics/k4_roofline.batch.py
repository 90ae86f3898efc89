"""k4_roofline.batch: K4, INTER_AREA (``ops.area``, ``csrc/area.cu``).

The least time its work over the traced calls takes at the card's
published peaks (:mod:`portbench.work`), over its summed device time in
the traced window, in percent.  Moves ``frames_per_s``.  Device trace.
``KERNELS``: the CUPTI kernel names it sums."""

from portbench.work import roofline_pct

KERNELS = ("area_kernel",)


def read(run):
    return roofline_pct(run, "k4", KERNELS)
