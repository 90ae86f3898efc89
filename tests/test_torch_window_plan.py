"""K3's tile plan's launches and its weight table on the CPU.

* The launches: where ``SMALL_SHARE`` of class 0's windows or more are of
  at most ``SMALL_BYTES`` (the 2x2 supersampled 4K cubemap's, not the 4K
  cubemap's), they form one range of tiles, class 0's others another,
  the larger class a third, each in raster order, the global-path tiles
  leading the first; each range takes its frames a pass
  (``WIDE_FRAMES``, 2, 1), and class 0's launches keep four CTAs on an
  SM.  On batches of ``CTA_FRAMES_MIN`` frames or fewer (a replayed
  graph's 8 frames, 16 planes of chroma), class 0 goes out as one launch
  over the same tiles, with the same window bytes, at two frames a pass
  (``launches``), as before its split.  The counters ``window.tiles``
  and ``window.tiles_wide`` (and their ``_u16`` twins) tally each
  launch's tiles, through a fake library, on the 4K flagship's and its
  2x2 supersampled twin's plans.
* The device weight table ``wtab`` (``sampling.weight_table``, one row per
  ``fy * 32 + fx``) equals ``float32(w1[fy, ty] * w1[fx, tx])`` of the
  float64 taps, bit for bit, for every interpolation: the value K3 formed
  per pixel from the float64 table before it read the float32 one, and
  the value the plain version reads (``remap_window_plain`` equals
  ``remap_plain``: tests/test_torch_window.py).
"""

import functools

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu_torch.ops import sources, window
from transform360_tpu_torch.sampling import INTER_TAB_SIZE, _TAPS, _tap_weights
from transform360_tpu_torch.utils.profiling import COUNTERS

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
FLAGSHIP = "cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:" \
           "input_stereo_format=mono"
SUPERSAMPLED = FLAGSHIP + ":width_scale_factor=2:height_scale_factor=2"
SM_SMEM = 228 * 1024  # an H100 SM's shared memory; each resident CTA reserves 1 KB of it


def check_launch_ranges(wp, sample_bytes=1):
    """The plan's launch ranges: class 0's small windows (``WIDE_FRAMES``
    frames a pass) where it has such a range, its others (2), the larger
    class (1), in that order, each contiguous and in raster order, the
    global-path tiles leading the first; a range's window is the largest
    of its staged tiles'."""
    staged = wp.meta[:, 5] > 0
    nbytes = wp.meta[:, 4].astype(np.int64) * wp.meta[:, 5] * sample_bytes
    raster = wp.meta[:, 0].astype(np.int64) * wp.out_w + wp.meta[:, 1]
    kinds = []
    for first, count, win, fp in wp.groups:
        sel = np.arange(first, first + count)
        glob = sel[~staged[sel]]
        assert (glob == sel[:glob.size]).all() and (first == 0 or glob.size == 0)
        st = sel[glob.size:]
        assert (np.diff(raster[st]) > 0).all() and (np.diff(raster[glob]) > 0).all()
        assert win == nbytes[st].max(initial=0)
        kind = {window.WIDE_FRAMES: 0, 2: 1, 1: 2}[fp]
        if kind == 0:
            assert (wp.tile_class[st] == 0).all() and (nbytes[st] <= window.SMALL_BYTES).all()
        elif kind == 1:  # class 0's others, or all of it where it has no wide range
            assert (wp.tile_class[st] == 0).all()
            assert 0 not in kinds or (nbytes[st] > window.SMALL_BYTES).all()
        else:
            assert (wp.tile_class[st] >= 1).all()
        kinds.append(kind)
    assert kinds == sorted(set(kinds))


@functools.lru_cache(maxsize=None)
def _plan(opts, pix_fmt="yuv420p"):
    return P.open_filter(opts, 3840, 2160, pix_fmt=pix_fmt, device="cpu").plan


@pytest.mark.parametrize("opts", [FLAGSHIP, SUPERSAMPLED], ids=["flagship", "ss2x2"])
def test_small_windows_take_their_own_launch_range(opts):
    # the 2x2 plan's small windows are 98.3% of class 0's tiles and take a
    # launch of their own; the flagship's (86.7% luma, 87.5% chroma) do not,
    # unless the share asked for is lower
    plan = _plan(opts)
    force = (window.SMALL_BYTES, window.WIDE_FRAMES, 0.0)
    for pp in (plan.luma, plan.chroma):
        wp = pp.window_plan()
        check_launch_ranges(wp)
        forced = window.build_window_plan(pp.spec, pp.fill, 1, force)
        check_launch_ranges(forced)
        assert [g[3] for g in forced.groups] == [window.WIDE_FRAMES, 2, 1]
        want = [window.WIDE_FRAMES, 2, 1] if opts == SUPERSAMPLED else [2, 1]
        assert [g[3] for g in wp.groups] == want
        nbytes = wp.meta[:, 4] * wp.meta[:, 5]
        small = float(((wp.tile_class == 0) & (nbytes <= window.SMALL_BYTES)).sum()
                      / (wp.tile_class == 0).sum())
        assert (small >= window.SMALL_SHARE) == (opts == SUPERSAMPLED)
        # class 0's launches keep four CTAs on an SM (the registers allow
        # four at uint8 T = 4)
        for _, _, win, fp in forced.groups[:2]:
            assert 4 * (window.smem_bytes(win, fp) + 1024) <= SM_SMEM
    assert window.smem_bytes(window.SMALL_BYTES, window.WIDE_FRAMES) == 49920


@pytest.mark.parametrize("B", [1, 2, 7, 8, 15, 16, 17, 128, 256])
def test_short_batches_launch_class_0_as_one(B):
    # on batches of CTA_FRAMES_MIN frames or fewer, class 0's two ranges
    # go out as the one launch they were before the split: the same tiles,
    # the largest window, two frames a pass; on longer ones each its own,
    # its CTAs walking at least CTA_FRAMES_MIN frames
    for pp in (_plan(SUPERSAMPLED).luma, _plan(SUPERSAMPLED).chroma):
        wp = pp.window_plan()
        staged = wp.meta[:, 5] > 0
        class0 = np.flatnonzero((wp.tile_class == 0) | ~staged)
        nbytes = wp.meta[:, 4] * wp.meta[:, 5]
        got = window.launches(wp.groups, B)
        if B <= window.CTA_FRAMES_MIN:
            want = (0, class0.size, int(nbytes[class0].max()), 2, B)
            assert got[0] == want and len(got) == 2
        else:
            assert [g[:4] for g in got] == list(wp.groups)
            assert all(g[4] >= window.CTA_FRAMES_MIN for g in got)
        assert got[-1][:4] == wp.groups[-1]  # the larger class, one frame a pass
        assert sorted(class0.tolist()) == list(range(class0.size))


class _FakeLibrary:
    """K3's C entry as the wrapper calls it: records each launch's call."""

    def __init__(self):
        self.calls = []

    def t360_window(self, call, stream, node):
        c = call._obj
        self.calls.append((c.first, c.tiles, c.win_bytes, c.pass_frames, c.frames))
        return 0


@pytest.mark.parametrize("opts, pix_fmt", [(FLAGSHIP, "yuv420p"), (SUPERSAMPLED, "yuv420p"),
                                           (FLAGSHIP, "yuv420p10le")],
                         ids=["flagship", "ss2x2", "flagship-10bit"])
def test_window_counters_tally_each_launch_tiles(opts, pix_fmt):
    # a 128-frame call (luma, then U and V as two sources of 128) and a
    # one-frame call: window.launches, window.tiles and window.tiles_wide
    # (the tiles of launches of more than two frames a pass), _u16 for
    # the uint16 instantiations
    plan = _plan(opts, pix_fmt)
    u16 = "" if plan.luma.dtype == torch.uint8 else "_u16"
    names = [n + u16 for n in ("window.launches", "window.tiles", "window.tiles_wide")]
    shares = []
    for B in (128, 1):
        for pp in (plan.luma, plan.chroma):
            wp = pp.window_plan()
            wt = window.WindowTables.from_plan(wp, "cpu")
            n = wt.meta.shape[0]
            # the small windows' tiles and the global-path tiles leading
            # them, where they are SMALL_SHARE of class 0 or more
            nbytes = wp.meta[:, 4] * wp.meta[:, 5] * wp.sample_bytes
            small = int(((wp.tile_class == 0) & (nbytes <= window.SMALL_BYTES)).sum())
            if small < window.SMALL_SHARE * (wp.tile_class == 0).sum():
                small = 0
            else:
                small += int((wp.meta[:, 5] == 0).sum())
            lib = _FakeLibrary()
            src = (sources.Source(0x10000, B, pp.in_h * pp.in_w, True),) * (
                2 if pp is plan.chroma else 1)  # U and V as two sources
            before = [COUNTERS[k] for k in names]
            window._launch_plan(lib, wt, src, torch.empty(0, dtype=wt.dtype), 0, pp.maxval)
            launched, tiles, wide = (COUNTERS[k] - b for k, b in zip(names, before))
            assert launched == len(lib.calls) == (3 if small and B > 16 else 2)
            assert tiles == n == sum(c[1] for c in lib.calls)
            assert wide == sum(c[1] for c in lib.calls if c[3] > 2) == (small if B > 1 else 0)
            shares.append(wide / tiles)
    if pix_fmt == "yuv420p":  # the batch cells' shares at 128 frames, luma and chroma
        want = (0.0, 0.0) if opts == FLAGSHIP else (0.9831, 0.9831)
        assert shares == pytest.approx([*want, 0.0, 0.0], abs=1e-4)


@pytest.mark.parametrize("interp", list(Interpolation))
def test_weight_table_is_the_float64_products_rounded(interp):
    cfg = TransformConfig(interpolation_alg=interp, **MONO)
    pp = P.build_plan(cfg, 256, 128, 96, 64, "gray").luma
    wp = window.build_window_plan(pp.spec, pp.fill)
    T = _TAPS[interp]
    w1 = np.stack(_tap_weights(interp, np.arange(INTER_TAB_SIZE) / INTER_TAB_SIZE, np),
                  axis=1).astype(np.float64)
    assert w1.shape == (INTER_TAB_SIZE, T)
    want = np.empty((INTER_TAB_SIZE**2, T * T), np.float32)
    for fy in range(INTER_TAB_SIZE):
        for fx in range(INTER_TAB_SIZE):
            for ty in range(T):
                for tx in range(T):
                    want[fy * INTER_TAB_SIZE + fx, ty * T + tx] = np.float32(
                        w1[fy, ty] * w1[fx, tx])
    assert wp.wtab.dtype == np.float32 and wp.wtab.shape == want.shape
    assert np.array_equal(wp.wtab.view(np.uint32), want.view(np.uint32))
    wt = window.WindowTables.from_plan(wp, "cpu")
    assert torch.equal(wt.wtab.view(torch.int32), torch.from_numpy(want).view(torch.int32))
