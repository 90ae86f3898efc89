"""The remap: the port's plain version against the JAX package.

* ``remap_plain`` + round against ``remap_const`` + round run op by op
  (eager XLA-CPU) on the same JAX plan: exact, for every interpolator on
  a wrapping (cubemap) and a transparent (barrel) layout.
* ``remap_plain`` against the Pallas lane kernel ``remap_lane`` in
  interpret mode (with the BORDER_TRANSPARENT fix-up the pipeline applies):
  at most 1 LSB on under 0.5% of pixels (the bound of
  tests/test_remap_lane.py: the lane kernel contracts y taps first).
* ``remap_plain`` against the pack-K (B3, ``build_lane_pack``) and
  merged-window (B4, ``build_lane_merged``) lane kernels at K = 2, the
  JAX pipeline's batch 8-64 route, in interpret mode at batch 8 and 20:
  the same bound, and the CPU path of ``remap_window_px`` (K3's plain
  version, which serves every batch size in the port) equals
  ``remap_plain`` there.  So these hold K3's function against B3 and B4.
The CUDA kernel K3 itself runs only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.ops.remap_lane import (
    build_lane_merged,
    build_lane_pack,
    build_lane_remap,
    remap_lane,
    remap_lane_hwb_pack,
)
from transform360_tpu.pipeline import _round_u8
from transform360_tpu.sampling import fixup_values, partial_fixup, remap_const
from transform360_tpu_torch.ops.window import WindowTables, build_window_plan, remap_window_px
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.sampling import DeviceSpec, remap_plain, round_u8

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
OUT_W = {Layout.CUBEMAP_32: 96, Layout.BARREL: 160}


def _case(interp, layout, plane=0):
    cfg = TransformConfig(output_layout=layout, interpolation_alg=interp, **MONO)
    jp = J.build_plan(cfg, 256, 128, OUT_W[layout], 64)
    jpp = jp.luma if plane == 0 else jp.chroma
    tpp = plan_from_jax(jp).luma if plane == 0 else plan_from_jax(jp).chroma
    wt = WindowTables.from_plan(build_window_plan(tpp.spec, tpp.fill), "cpu")
    return jpp, DeviceSpec.from_spec(tpp.spec, tpp.fill, "cpu"), wt


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("layout", [Layout.CUBEMAP_32, Layout.BARREL])
@pytest.mark.parametrize("interp", list(Interpolation))
def test_remap_plain_exact_vs_remap_const(interp, layout, plane, rng):
    jpp, ds, wt = _case(interp, layout, plane)
    B = 3
    x = rng.integers(0, 256, (B, jpp.in_h, jpp.in_w), dtype=np.uint8)
    want = np.asarray(_round_u8(
        remap_const(jpp.spec, jnp.asarray(x).reshape(B, -1), float(jpp.fill))
    )).reshape(B, jpp.out_h, jpp.out_w)
    got = round_u8(remap_plain(ds, torch.from_numpy(x))).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{(got != want).sum()} pixels differ"
    # K3's wrapper on a CPU tensor (its plain version) gives the same bytes
    assert np.array_equal(remap_window_px(wt, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize(
    "interp, layout",
    [(Interpolation.CUBIC, Layout.CUBEMAP_32), (Interpolation.LINEAR, Layout.BARREL),
     (Interpolation.LANCZOS4, Layout.CUBEMAP_32)],
)
def test_remap_plain_vs_remap_lane_interpret(interp, layout, rng):
    jpp, ds, _ = _case(interp, layout)
    lp = build_lane_remap(jpp.spec, jpp.fill)
    assert lp is not None
    x = rng.integers(0, 256, (3, jpp.in_h, jpp.in_w), dtype=np.uint8)
    want = np.array(remap_lane(lp, jnp.asarray(x), interpret=True))
    fix = partial_fixup(jpp.spec, float(jpp.fill))
    if fix is not None:  # the pipeline's BORDER_TRANSPARENT patch (pipeline.py:217-223)
        vals = np.asarray(_round_u8(fixup_values(fix, jnp.asarray(x).reshape(3, -1))))
        want = want.reshape(3, -1)
        want[:, fix[0]] = vals
        want = want.reshape(3, jpp.out_h, jpp.out_w)
    got = round_u8(remap_plain(ds, torch.from_numpy(x))).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.005


def _assert_within_a_tie(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


@pytest.mark.parametrize(
    "kernel, interp, layout",
    [("B3-pack", Interpolation.CUBIC, Layout.CUBEMAP_32),
     ("B4-merged", Interpolation.CUBIC, Layout.CUBEMAP_32),
     ("B4-merged", Interpolation.LINEAR, Layout.BARREL)],
)
def test_remap_plain_vs_lane_pack_and_merged_interpret(kernel, interp, layout):
    """Set up as tests/test_remap_lane.py's pack cases and the pipeline's
    pack route (pipeline.py:179-204): frames zero-padded to a 64-lane
    group and duplicated into both groups, [H, W, 128] in."""
    jpp, ds, wt = _case(interp, layout)
    lp = build_lane_remap(jpp.spec, jpp.fill)
    build = build_lane_pack if kernel == "B3-pack" else build_lane_merged
    pk = build(lp, 2)
    assert pk is not None and pk.packs
    G = 64
    # one compile serves both batches: the padded lane layout has one shape
    run = jax.jit(lambda ct: remap_lane_hwb_pack(pk, ct, interpret=True))
    fix = partial_fixup(jpp.spec, float(jpp.fill))
    rng = np.random.default_rng(11)
    for B in (8, 20):
        x = rng.integers(0, 256, (B, jpp.in_h, jpp.in_w), dtype=np.uint8)
        c = np.concatenate([x, np.zeros((G - B,) + x.shape[1:], np.uint8)])
        ct = jnp.transpose(jnp.asarray(np.concatenate([c, c])), (1, 2, 0))
        want = np.array(run(ct))[:B]
        if fix is not None:  # the pipeline's BORDER_TRANSPARENT patch
            vals = np.asarray(_round_u8(fixup_values(fix, jnp.asarray(x).reshape(B, -1))))
            want = want.reshape(B, -1)
            want[:, fix[0]] = vals
            want = want.reshape(B, jpp.out_h, jpp.out_w)
        got = round_u8(remap_plain(ds, torch.from_numpy(x))).numpy()
        assert np.array_equal(remap_window_px(wt, torch.from_numpy(x)).numpy(), got)
        assert got.shape == want.shape
        _assert_within_a_tie(got, want)
