"""The remap: the port's plain version against the JAX package.

* ``remap_plain`` + round against ``remap_const`` + round run op by op
  (eager XLA-CPU) on the same JAX plan: exact, for every interpolator on
  a wrapping (cubemap) and a transparent (barrel) layout.
* ``remap_plain`` against the Pallas lane kernel ``remap_lane`` in
  interpret mode (with the BORDER_TRANSPARENT fix-up the pipeline applies):
  at most 1 LSB on under 0.5% of pixels (the bound of
  tests/test_remap_lane.py: the lane kernel contracts y taps first).
The CUDA kernel K2 itself runs only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.ops.remap_lane import build_lane_remap, remap_lane
from transform360_tpu.pipeline import _round_u8
from transform360_tpu.sampling import fixup_values, partial_fixup, remap_const
from transform360_tpu_torch.ops.remap import remap_u8
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.sampling import DeviceSpec, remap_plain, round_u8

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
OUT_W = {Layout.CUBEMAP_32: 96, Layout.BARREL: 160}


def _case(interp, layout, plane=0):
    cfg = TransformConfig(output_layout=layout, interpolation_alg=interp, **MONO)
    jp = J.build_plan(cfg, 256, 128, OUT_W[layout], 64)
    jpp = jp.luma if plane == 0 else jp.chroma
    tpp = plan_from_jax(jp).luma if plane == 0 else plan_from_jax(jp).chroma
    return jpp, DeviceSpec.from_spec(tpp.spec, tpp.fill, "cpu")


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("layout", [Layout.CUBEMAP_32, Layout.BARREL])
@pytest.mark.parametrize("interp", list(Interpolation))
def test_remap_plain_exact_vs_remap_const(interp, layout, plane, rng):
    jpp, ds = _case(interp, layout, plane)
    B = 3
    x = rng.integers(0, 256, (B, jpp.in_h, jpp.in_w), dtype=np.uint8)
    want = np.asarray(_round_u8(
        remap_const(jpp.spec, jnp.asarray(x).reshape(B, -1), float(jpp.fill))
    )).reshape(B, jpp.out_h, jpp.out_w)
    got = round_u8(remap_plain(ds, torch.from_numpy(x))).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), f"{(got != want).sum()} pixels differ"
    # the CPU path of the wrapper is exactly the plain version
    assert np.array_equal(remap_u8(ds, torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize(
    "interp, layout",
    [(Interpolation.CUBIC, Layout.CUBEMAP_32), (Interpolation.LINEAR, Layout.BARREL),
     (Interpolation.LANCZOS4, Layout.CUBEMAP_32)],
)
def test_remap_plain_vs_remap_lane_interpret(interp, layout, rng):
    jpp, ds = _case(interp, layout)
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
