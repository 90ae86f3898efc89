"""k1_roofline.batch: K1, the prefilter (``ops.blur``, ``csrc/blur.cu``).

The least time its work over the traced calls takes at the card's
published peaks (:mod:`portbench.work`), over its summed device time in
the traced window, in percent.  Moves ``frames_per_s``.  Device trace.
``KERNELS``: the CUPTI kernel names it sums."""

from portbench.work import roofline_pct

KERNELS = ("blur_ring_kernel", "blur_direct_kernel")


def read(run):
    return roofline_pct(run, "k1", KERNELS)
