"""The work each kernel of the filter must do, counted from the plan's
shapes, and the card's published peaks: the yardstick of the roofline
shares.

Counts come from the reference's own plan (:mod:`.reference.plan`), never
from the program or from one implementation's machine code, so they stay
the same whatever implements a kernel:

* bytes: each input sample read once and each output sample written once;
  K3 also reads its plan's per-pixel tables once per plane class and call
  (first-tap row and column as int32, the two 1/32 fraction indices as
  bytes, and the transparent-border mask where the layout has one);
* float operations: the fewest products and sums the function needs.
  K1, a separable filter per band and tile: a symmetric kernel of radius
  r takes r + 1 products and 2r sums per pixel and axis (2r + 1 products
  otherwise).  K3: T*T products and T*T - 1 sums per output sample (T
  taps per axis; the weights come from a table).  K4: per axis, one
  product per nonzero weight and one sum fewer.

A kernel's time cannot beat the larger of bytes over the memory rate and
operations over the float32 rate: that bound over the kernel's time in
the trace is its roofline share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .reference.config import Interpolation, StereoFormat
from .reference.filtering import BlurPlan
from .reference.plan import Plan, PlanePlan

# NVIDIA H100 SXM5 data sheet (80 GB HBM3), at its 700 W power limit:
PEAK_BYTES_PER_S = 3.35e12  # HBM3 bandwidth
PEAK_FP32_PER_S = 67e12  # FP32 outside the tensor cores

TAPS = {Interpolation.NEAREST: 1, Interpolation.LINEAR: 2, Interpolation.CUBIC: 4,
        Interpolation.LANCZOS4: 8}


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    def __mul__(self, n: float) -> "Work":
        return Work(self.bytes * n, self.ops * n)

    def bound_s(self) -> float:
        """The least seconds the card can take for this work."""
        return max(self.bytes / PEAK_BYTES_PER_S, self.ops / PEAK_FP32_PER_S)

    def bound_by(self) -> str:
        return "bytes" if self.bytes / PEAK_BYTES_PER_S >= self.ops / PEAK_FP32_PER_S else "float ops"


def _classes(plan: Plan):
    """(plane plan, image planes that use it) per map plane."""
    out = [(plan.luma, 1)]
    if plan.chroma is not None:
        out.append((plan.chroma, plan.n_planes - 1))
    return out


def _sample_bytes(pp: PlanePlan) -> int:
    return 1 if pp.depth <= 8 else 2


def axis_ops(taps: np.ndarray) -> int:
    """Products and sums per pixel of one 1-D pass with ``taps`` (zero
    padding on either side is not part of the kernel)."""
    nz = np.nonzero(taps)[0]
    if nz.size == 0:
        return 0
    t = taps[nz[0]:nz[-1] + 1]
    r = (t.size - 1) // 2
    products = r + 1 if t.size % 2 and np.array_equal(t, t[::-1]) else t.size
    return products + (t.size - 1)


def blur_ops(bp: BlurPlan) -> float:
    """K1's float operations for one plane."""
    eyes = 2 if bp.stereo in (StereoFormat.LR, StereoFormat.TB) else 1
    total = 0
    for band in bp.bands:
        for t in range(band.kx.shape[0]):
            cols = min(bp.tile_w, bp.eye_w - t * bp.tile_w)
            if cols > 0:
                total += band.height * cols * (axis_ops(band.kx[t]) + axis_ops(band.ky[t]))
    return float(total * eyes)


def k1(plan: Plan, frames: int) -> Optional[Work]:
    """The prefilter's work for one call of ``frames`` frames, or None
    where the plan has no prefilter."""
    w = None
    for pp, n in _classes(plan):
        if pp.blur is None:
            continue
        px = pp.in_h * pp.in_w
        c = Work(bytes=2.0 * px * _sample_bytes(pp), ops=blur_ops(pp.blur)) * (frames * n)
        w = c if w is None else w + c
    return w


def k3(plan: Plan, frames: int) -> Work:
    """The remap's work for one call: planes in, samples out at the
    scaled size, and each plane class's tables."""
    w = Work(0.0, 0.0)
    for pp, n in _classes(plan):
        t = TAPS[pp.spec.interp]
        out_px = pp.scaled_h * pp.scaled_w
        sb = _sample_bytes(pp)
        per_frame = Work(bytes=float(pp.in_h * pp.in_w * sb + out_px * sb),
                         ops=float(out_px * (2 * t * t - 1) if t > 1 else 0))
        tables = out_px * (4 + 4 + 1 + 1 + (pp.spec.valid is not None))
        w = w + per_frame * (frames * n) + Work(float(tables), 0.0)
    return w


def _area_ops(pp: PlanePlan) -> float:
    nr = (pp.area.row.weights != 0).sum(axis=1)
    nc = (pp.area.col.weights != 0).sum(axis=1)
    rows = pp.scaled_w * float((2 * nr - 1).sum())
    cols = pp.out_h * float((2 * nc - 1).sum())
    return rows + cols


def k4(plan: Plan, frames: int) -> Optional[Work]:
    """INTER_AREA's work for one call, or None where the plan does not
    supersample."""
    w = None
    for pp, n in _classes(plan):
        if pp.area is None:
            continue
        sb = _sample_bytes(pp)
        c = Work(bytes=float((pp.scaled_h * pp.scaled_w + pp.out_h * pp.out_w) * sb),
                 ops=_area_ops(pp)) * (frames * n)
        w = c if w is None else w + c
    return w


KERNELS = {"k1": k1, "k3": k3, "k4": k4}


def roofline_pct(run, kernel: str, names) -> Optional[float]:
    """The traced window's share of ``kernel``'s roofline, in percent: its
    work over the traced calls at the peaks, over the summed device time
    of the kernels named ``names`` in the trace; None where the trace has
    none of them or the plan gives the kernel no work."""
    if run.trace is None:
        return None
    w = KERNELS[kernel](run.plan, run.traffic["batch"])
    seconds, launches = run.trace.kernel_seconds(names)
    if w is None or launches == 0 or seconds <= 0:
        return None
    return 100.0 * (w * run.trace_calls).bound_s() / seconds
