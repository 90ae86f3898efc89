"""The prefilter: the port's plain version against the JAX package.

* ``blur_plain`` + round against ``apply_blur`` + ``_round_u8`` run op by
  op (eager XLA-CPU) on the same JAX plan: exact.
* ``blur_plain`` against the Pallas kernel ``blur_lane`` in interpret
  mode: at most 1 LSB on under 0.5% of pixels (the bound of
  tests/test_blur_lane.py: that kernel sums vertical-first with a
  bf16x3-split x matmul).
* The flattened tables the CUDA kernel K1 reads, walked in torch the way
  the kernel walks them: exact against ``blur_plain``.  (The kernel
  itself runs only on a GPU: tests/test_torch_cuda.py and chip_smoke.py.)
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
from transform360_tpu_torch.ops.blur import BlurTables, blur_u8
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
    assert np.array_equal(blur_u8(t, torch.from_numpy(x)).numpy(), got)


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
    """K1's two passes in torch, reading only the tables, in the kernel's
    order: horizontal into the float32 scratch, then vertical + round."""
    B, H, W = x.shape
    xf = x.float()
    RX, RY = (bt.kx.shape[2] - 1) // 2, (bt.ky.shape[2] - 1) // 2
    seg = bt.col_seg.long().clamp(min=0)
    c = torch.arange(W)
    h = torch.empty(B, bt.S, W)
    for s in range(bt.S):
        g, src = int(bt.s_band[s]), int(bt.s_src[s])
        rx = int(bt.rx[g])
        acc = None
        for u in range(2 * rx + 1):
            term = bt.kx[g, seg, RX - rx + u][None] * xf[:, src, (c + u - rx).clamp(0, W - 1)]
            acc = term if acc is None else acc + term
        h[:, s] = acc
    out = torch.zeros(B, H, W, dtype=torch.uint8)
    for r in range(H):
        g = int(bt.row_band[r])
        if g < 0:
            continue
        ry, s0 = int(bt.ry[g]), int(bt.row_s0[r])
        acc = None
        for t in range(2 * ry + 1):
            term = bt.ky[g, seg, RY - ry + t][None] * h[:, s0 + t]
            acc = term if acc is None else acc + term
        row = round_u8(acc)
        row[:, bt.col_seg < 0] = 0
        out[:, r] = row
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tables_reproduce_blur_plain(name, rng):
    _, tb, h, w = _blur_plan(name)
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    x = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    want = round_u8(blur_plain(tb, x.float()))
    assert torch.equal(_walk_tables(bt, x), want)
