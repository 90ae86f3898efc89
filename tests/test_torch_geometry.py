"""The port's float32 torch warp maps against the JAX package's XLA maps.

Both compute the reference's transformPos in float32, but atan2/asin/tan
and the FMA contraction of XLA-CPU differ from torch in the last ulp.
Bounds: at most 1e-3 input pixels on all but 0.5% of pixels, and 0.05 px
anywhere.  (Measured: at most 2.3e-4 px at 256x128; at the gate size
1920x960 -> 480x320, 0.18% of pixels exceed 1e-3 px, up to 0.013 px, all
next to the poles, where atan2's arguments are tiny and one ulp moves the
angle a lot; at the flagship 3840x2160 -> 1536x1024, at most 9.8e-4 px.)
A map coordinate near a 1/32 step can then quantize to the neighbouring
step in make_sample_spec; those flips are counted and bounded (measured:
under 1% of pixels on every case here)."""

import numpy as np
import pytest

from transform360_tpu import geometry as jg
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.sampling import make_sample_spec as j_spec
from transform360_tpu_torch import geometry as tg
from transform360_tpu_torch.plan import config_from_jax
from transform360_tpu_torch.sampling import make_sample_spec as t_spec

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
MAP_BOUND_PX = 1e-3  # for all but MAP_OUTLIER_FRAC of the pixels
MAP_OUTLIER_FRAC = 0.005
MAP_MAX_PX = 0.05
FLIP_BOUND = 0.01

CASES = {
    **{f"mono-{lay.name}": TransformConfig(output_layout=lay, **MONO) for lay in Layout},
    "tb": TransformConfig(
        input_stereo_format=StereoFormat.TB, output_stereo_format=StereoFormat.TB
    ),
    "tb-vflip": TransformConfig(
        input_stereo_format=StereoFormat.TB, output_stereo_format=StereoFormat.TB, vflip=1
    ),
    "lr-offcenter23": TransformConfig(
        input_stereo_format=StereoFormat.LR,
        output_stereo_format=StereoFormat.LR,
        output_layout=Layout.CUBEMAP_23_OFFCENTER,
    ),
    "lr-barrel": TransformConfig(
        input_stereo_format=StereoFormat.LR,
        output_stereo_format=StereoFormat.LR,
        output_layout=Layout.BARREL,
    ),
    "yaw-pitch-roll": TransformConfig(fixed_yaw=30, fixed_pitch=-20, fixed_roll=10, **MONO),
    "offcenter": TransformConfig(
        fixed_cube_offcenter_x=0.1, fixed_cube_offcenter_z=-0.3, **MONO
    ),
    "offcenter-horizontal": TransformConfig(
        fixed_cube_offcenter_z=-0.3, is_horizontal_offset=1, **MONO
    ),
    "cubemap-in": TransformConfig(
        input_layout=Layout.CUBEMAP_32, output_layout=Layout.EQUIRECT, **MONO
    ),
}


def _check_map(got, want) -> float:
    d = np.abs(got - want).max(axis=-1)
    assert d.max() <= MAP_MAX_PX, f"max map difference {d.max()} px"
    assert (d > MAP_BOUND_PX).mean() <= MAP_OUTLIER_FRAC, (d > MAP_BOUND_PX).mean()
    return float(d.max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_warp_map_and_quantization_agree(name):
    cfg = CASES[name]
    in_w, in_h, out_w, out_h = 256, 128, 96, 64
    want = np.asarray(jg.build_warp_map(cfg, in_w, in_h, out_w, out_h))
    got = tg.build_warp_map(config_from_jax(cfg), in_w, in_h, out_w, out_h).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = _check_map(got, want)

    wrap = cfg.output_layout not in (Layout.BARREL, Layout.BARREL_SPLIT)
    a = j_spec(want, in_w, in_h, Interpolation.CUBIC, wrap)
    b = t_spec(got, in_w, in_h, Interpolation.CUBIC, wrap)
    flips = (
        (a.base_x != b.base_x) | (a.base_y != b.base_y)
        | (a.frac_x != b.frac_x) | (a.frac_y != b.frac_y)
    )
    if a.valid is not None:
        flips |= a.valid != b.valid
    print(f"{name}: max map diff {err:.3g} px, 1/32 flips {int(flips.sum())} "
          f"of {flips.size} ({flips.mean():.4%})")
    assert flips.mean() <= FLIP_BOUND


def test_flagship_gate_size_flip_count():
    """The fidelity-gate size of the flagship (fidelity.py:69-70)."""
    cfg = TransformConfig(**MONO)
    for (iw, ih, ow, oh) in ((1920, 960, 480, 320), (960, 480, 240, 160)):
        want = np.asarray(jg.build_warp_map(cfg, iw, ih, ow, oh))
        got = tg.build_warp_map(config_from_jax(cfg), iw, ih, ow, oh).numpy()
        _check_map(got, want)
        a = j_spec(want, iw, ih, Interpolation.CUBIC, True)
        b = t_spec(got, iw, ih, Interpolation.CUBIC, True)
        flips = (a.frac_x != b.frac_x) | (a.frac_y != b.frac_y)
        flips |= (a.base_x != b.base_x) | (a.base_y != b.base_y)
        assert flips.mean() <= FLIP_BOUND, flips.mean()
