"""work.py's byte and operation counts on tiny plans, against hand counts."""

import numpy as np
import pytest

from portbench import work
from portbench.reference.config import StereoFormat
from portbench.reference.filtering import BandSpec, BlurPlan
from portbench.reference.plan import open_plan

CUBE = "cube_edge_length=16:interpolation_alg=cubic:enable_low_pass_filter=1:input_stereo_format=mono"


@pytest.mark.parametrize("taps, ops", [
    ([0.25, 0.5, 0.25], 2 + 2),  # symmetric, r = 1: r + 1 products, 2r sums
    ([0.1, 0.2, 0.4, 0.2, 0.1], 3 + 4),
    ([0.0, 0.25, 0.5, 0.25, 0.0], 2 + 2),  # zero padding is no tap
    ([0.2, 0.3, 0.5], 3 + 2),  # not symmetric: every tap a product
    ([1.0], 1 + 0),
])
def test_axis_ops(taps, ops):
    assert work.axis_ops(np.asarray(taps, np.float32)) == ops


def _band(top, height, kx, ky, tiles=1):
    kx = np.tile(np.asarray(kx, np.float32), (tiles, 1))
    ky = np.tile(np.asarray(ky, np.float32), (tiles, 1))
    return BandSpec(top=top, height=height, kx=kx, ky=ky, kx_col=kx.T, ky_col=ky.T)


def test_blur_ops_by_hand():
    g3, g5 = [0.25, 0.5, 0.25], [0.1, 0.2, 0.4, 0.2, 0.1]
    bp = BlurPlan(bands=(_band(0, 2, g5, g3), _band(2, 3, g3, g3)), eye_w=10, eye_h=5,
                  n_tiles=1, tile_w=10, stereo=StereoFormat.MONO)
    # band 0: 2 rows x 10 columns x (7 + 4); band 1: 3 x 10 x (4 + 4)
    assert work.blur_ops(bp) == 2 * 10 * 11 + 3 * 10 * 8
    tb = BlurPlan(bands=bp.bands, eye_w=10, eye_h=5, n_tiles=1, tile_w=10, stereo=StereoFormat.TB)
    assert work.blur_ops(tb) == 2 * work.blur_ops(bp)  # two eyes
    # two tiles of 6 and 4 columns
    tiles = BlurPlan(bands=(_band(0, 5, g3, g3, tiles=2),), eye_w=10, eye_h=5, n_tiles=2,
                     tile_w=6, stereo=StereoFormat.MONO)
    assert work.blur_ops(tiles) == 5 * 6 * 8 + 5 * 4 * 8


def test_k3_k1_counts_flagship_shape():
    plan = open_plan(CUBE, 64, 32)  # out 48x32, chroma 32x16 -> 24x16
    assert (plan.out_w, plan.out_h) == (48, 32)
    k3 = work.k3(plan, 5)
    px_in, px_out, c_in, c_out = 64 * 32, 48 * 32, 32 * 16, 24 * 16
    assert k3.bytes == 5 * (px_in + px_out) + 10 * (c_in + c_out) + 10 * px_out + 10 * c_out
    assert k3.ops == 5 * (px_out + 2 * c_out) * (16 + 15)  # cubic: 16 products, 15 sums
    k1 = work.k1(plan, 5)
    assert k1.bytes == 5 * 2 * (px_in + 2 * c_in)
    assert k1.ops == 5 * (work.blur_ops(plan.luma.blur) + 2 * work.blur_ops(plan.chroma.blur))
    assert work.k4(plan, 5) is None


def test_k4_counts_2x2():
    plan = open_plan(CUBE + ":width_scale_factor=2:height_scale_factor=2", 64, 32)
    k4 = work.k4(plan, 3)
    # luma: 96x64 -> 48x32; chroma 48x32 -> 24x16, twice; 2 taps an axis
    luma_ops = 96 * 32 * 3 + 32 * 48 * 3
    chroma_ops = 48 * 16 * 3 + 16 * 24 * 3
    assert k4.ops == 3 * (luma_ops + 2 * chroma_ops)
    assert k4.bytes == 3 * ((96 * 64 + 48 * 32) + 2 * (48 * 32 + 24 * 16))
    k3 = work.k3(plan, 3)
    assert k3.ops == 3 * (96 * 64 + 2 * 48 * 32) * 31  # the remap runs at the scaled size


def test_bounds():
    assert work.Work(work.PEAK_BYTES_PER_S, 0.0).bound_s() == 1.0
    w = work.Work(1.0, work.PEAK_FP32_PER_S * 2)
    assert w.bound_s() == 2.0 and w.bound_by() == "float ops"
    assert (w * 3).ops == w.ops * 3


class _Trace:
    def __init__(self, seconds, launches):
        self.r = (seconds, launches)

    def kernel_seconds(self, names):
        return self.r


class _Run:
    def __init__(self, plan, trace, calls, batch):
        self.plan, self.trace, self.trace_calls = plan, trace, calls
        self.traffic = {"batch": batch}


def test_roofline_pct():
    plan = open_plan(CUBE, 64, 32)
    w = work.k3(plan, 4) * 10
    run = _Run(plan, _Trace(2 * w.bound_s(), 40), 10, 4)
    assert work.roofline_pct(run, "k3", ("window_kernel",)) == pytest.approx(50.0)
    assert work.roofline_pct(_Run(plan, _Trace(0.0, 0), 10, 4), "k3", ()) is None
    assert work.roofline_pct(_Run(plan, _Trace(1.0, 2), 10, 4), "k4", ()) is None  # no K4 work
    assert work.roofline_pct(_Run(plan, None, 10, 4), "k1", ()) is None
