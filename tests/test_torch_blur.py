"""The prefilter: the port's plain version against the JAX package.

* ``blur_plain`` + round against ``apply_blur`` + ``_round_u8`` run op by
  op (eager XLA-CPU) on the same JAX plan: exact.
* ``blur_plain`` against the Pallas kernel ``blur_lane`` in interpret
  mode: at most 1 LSB on under 0.5% of pixels (the bound of
  tests/test_blur_lane.py: that kernel sums vertical-first with a
  bf16x3-split x matmul).
* The tile plan the CUDA kernel K1 reads, walked in torch the way the
  kernel walks it (per tile, the x pass of every staged row with the
  tile's taps, halo rows included, then the y pass at the kernel's
  radius and the round): exact against ``blur_plain``.  No tile crosses
  a band, a segment or an eye, and the tiles cover every output pixel
  exactly once.  (The kernel itself runs only on a GPU:
  tests/test_torch_cuda.py and chip_smoke.py.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu.filtering import apply_blur
from transform360_tpu.ops.blur_lane import blur_lane, build_blur_lane
from transform360_tpu.pipeline import _round_u8
from transform360_tpu_torch.filtering import blur_plain
from transform360_tpu_torch.ops.blur import (
    SMEM_MAX,
    STRIP_MAX,
    TW,
    WARPS,
    BlurTables,
    blur_px,
    tile_pitch,
)
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.sampling import round_u8

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
CASES = {
    "mono": (TransformConfig(**MONO), 256, 80, 96, 64),
    "tb-odd": (TransformConfig(input_stereo_format=StereoFormat.TB,
                               output_stereo_format=StereoFormat.TB), 256, 161, 96, 128),
    "lr-odd": (TransformConfig(input_stereo_format=StereoFormat.LR,
                               output_stereo_format=StereoFormat.LR), 513, 80, 192, 64),
    "adaptive-32x15": (TransformConfig(num_vertical_segments=32,
                                       num_horizontal_segments=15, **MONO), 512, 128, 96, 64),
    "per-column-taps": (TransformConfig(num_horizontal_segments=3,
                                        fixed_cube_offcenter_z=0.5, **MONO), 256, 80, 96, 64),
    # y radius 5: beyond the ring kernels, so K1 runs its direct kernel
    "wide-y-taps": (TransformConfig(min_kernel_half_height=5, **MONO), 256, 80, 96, 64),
}


def _blur_plan(name):
    cfg, iw, ih, ow, oh = CASES[name]
    jp = J.build_plan(cfg, iw, ih, ow, oh, "gray")
    return jp.luma.blur, plan_from_jax(jp).luma.blur, ih, iw


@pytest.mark.parametrize("name", sorted(CASES))
def test_blur_plain_exact_vs_apply_blur(name, rng):
    jb, tb, h, w = _blur_plan(name)
    x = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    want = np.asarray(_round_u8(apply_blur(jb, jnp.asarray(x).astype(jnp.float32))))
    got = round_u8(blur_plain(tb, torch.from_numpy(x).float())).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{(got != want).sum()} pixels differ"
    # the CPU path of the wrapper is exactly the plain version
    t = BlurTables.from_plan(tb, h, w, "cpu")
    assert np.array_equal(blur_px(t, torch.from_numpy(x)).numpy(), got)


LANE_CASES = {
    "mono": (TransformConfig(interpolation_alg=Interpolation.CUBIC, **MONO), 256, 80, 96, 64),
    "tb": (TransformConfig(input_stereo_format=StereoFormat.TB,
                           output_stereo_format=StereoFormat.TB), 256, 160, 96, 128),
    "lr": (TransformConfig(input_stereo_format=StereoFormat.LR,
                           output_stereo_format=StereoFormat.LR), 512, 80, 192, 64),
}


@pytest.mark.parametrize("name", sorted(LANE_CASES))
def test_blur_plain_vs_blur_lane_interpret(name, rng):
    cfg, iw, ih, ow, oh = LANE_CASES[name]
    jp = J.build_plan(cfg, iw, ih, ow, oh, "gray")
    bl = build_blur_lane(jp.luma.blur, ih, iw)
    assert bl is not None
    bl = dataclasses.replace(bl, precision="high")  # the shipping default
    x = rng.integers(0, 256, (ih, iw, 128), dtype=np.uint8)
    want = np.asarray(blur_lane(bl, jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))
    got = round_u8(blur_plain(plan_from_jax(jp).luma.blur, xt.float())).numpy()
    diff = np.abs(got.transpose(1, 2, 0).astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.005


def _walk_tables(bt: BlurTables, x: torch.Tensor) -> torch.Tensor:
    """K1's tile walk in torch, reading only the tables, in the kernel's
    order: per tile, the x pass of its source rows r0 - ry ..
    r0 + nrows + ry (clamped) with the tile's own taps, then the y pass
    (at the ring kernel's padded radius, or the tile's own for the
    direct kernel) and the round.  Zero tiles write 0; a pixel no tile
    writes keeps the sentinel 77."""
    B, H, W = x.shape
    xf = x.float()
    out = torch.full((B, H, W), 77, dtype=torch.uint8)
    LX, LY = bt.kx.shape[1], bt.ky.shape[1]
    for r0, c0, nr, nc, s, _ in bt.tiles.tolist():
        if s < 0:
            out[:, r0 : r0 + nr, c0 : c0 + nc] = 0
            continue
        rx = int(bt.rx[s])
        ry = bt.ring_ry if bt.ring_ry >= 0 else int(bt.ry[s])
        k = bt.kx[s, (LX - 1) // 2 - rx :]
        q = bt.ky[s, (LY - 1) // 2 - ry :]
        rows = xf[:, torch.arange(r0 - ry, r0 + nr + ry).clamp(0, H - 1)]
        cols = torch.arange(c0, c0 + nc)
        h = None
        for u in range(2 * rx + 1):
            term = k[u] * rows[:, :, (cols + u - rx).clamp(0, W - 1)]
            h = term if h is None else h + term
        acc = None
        for t in range(2 * ry + 1):
            term = q[t] * h[:, t : t + nr]
            acc = term if acc is None else acc + term
        out[:, r0 : r0 + nr, c0 : c0 + nc] = round_u8(acc)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tables_reproduce_blur_plain(name, rng):
    _, tb, h, w = _blur_plan(name)
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    x = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    want = round_u8(blur_plain(tb, x.float()))
    assert torch.equal(_walk_tables(bt, x), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_stay_inside_bands_and_cover_once(name):
    _, tb, h, w = _blur_plan(name)
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    tiles = bt.tiles.numpy().astype(np.int64)
    nseg = max(b.kx.shape[0] for b in tb.bands)
    # the band and the (eye, segment) of every output pixel, from the plan
    band = np.full(h, -1)
    for off in (0, tb.eye_h) if tb.stereo == StereoFormat.TB else (0,):
        for i, b in enumerate(tb.bands):
            band[off + b.top : off + b.top + b.height] = i
    c = np.arange(w)
    if tb.stereo == StereoFormat.LR:
        eye, ec, covered = c // tb.eye_w, c % tb.eye_w, c < 2 * tb.eye_w
    else:
        eye, ec, covered = 0 * c, c, c < tb.eye_w
    seg = np.where(covered, np.minimum(ec // tb.tile_w, nseg - 1), -1)
    hits = np.zeros((h, w), int)
    for r0, c0, nr, nc, s, pitch in tiles:
        assert 0 < nr and 0 < nc <= TW
        rs, cs = slice(r0, r0 + nr), slice(c0, c0 + nc)
        hits[rs, cs] += 1
        if s < 0:  # the leftover row or column of odd stereo dims, and only it
            assert ((band[rs, None] < 0) | (seg[None, cs] < 0)).all()
            continue
        # one band, one eye, one segment: one set of taps
        assert (band[rs] == s // nseg).all()
        assert (seg[cs] == s % nseg).all() and len(set(eye[cs])) == 1
        assert nr <= WARPS * STRIP_MAX and pitch == tile_pitch(nc, int(bt.rx[s]))
        if bt.ring_ry >= 0:  # two staged buffers fit the CTA's shared memory
            assert (nr + 2 * bt.ring_ry) * pitch <= bt.buf_bytes
    assert (hits == 1).all()
    assert 2 * bt.buf_bytes <= SMEM_MAX and bt.buf_bytes % 16 == 0
    # the zeroed pixels of blur_plain are exactly the zero tiles'
    zero = np.zeros((h, w), bool)
    for r0, c0, nr, nc, s, _ in tiles[tiles[:, 4] < 0]:
        zero[r0 : r0 + nr, c0 : c0 + nc] = True
    assert (zero == ((band[:, None] < 0) | (seg[None, :] < 0))).all()
