"""Supersampling with INTER_AREA in the port, against the JAX package.

* ``area_matrix`` is a numpy copy: exactly equal to the JAX package's for
  downscales (box integrals) and upscales (OpenCV's linear branch).
* ``AreaTables`` keeps each matrix row's nonzero band and gives the
  matrix back exactly; ``area_resize`` (banded float32 sums, rows then
  columns, ascending input index) against the JAX package's two dense
  einsums ``apply_area_resize``: exact at factors 2 and 4 (every product
  and sum is exact there), within 1e-5 relative otherwise.
* Whole supersampled plans on the JAX plan (``plan_from_jax``), the
  remap at the scaled size, round, area, round: 2x2 and 1.5x2.0 (the
  case of tests/test_latency_shard.py), 8-bit and 10-bit, against
  ``transform360_tpu.pipeline.transform_batch``: at most 1 LSB on at
  most 0.2% of each plane (the FMA ties of ROADMAP C).
* The port's own plan prefilters for the scaled size, as the JAX
  package's does: the blur plans and area matrices are exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Layout, StereoFormat, TransformConfig
from transform360_tpu.pipeline import transform_batch as jax_transform_batch
from transform360_tpu.sampling import apply_area_resize, area_matrix as jax_area_matrix
import transform360_tpu_torch as P
from transform360_tpu_torch.plan import config_from_jax, plan_from_jax
from transform360_tpu_torch.sampling import (
    AreaAxis, AreaTables, DeviceArea, area_matrix, area_resize,
)

from test_torch_deep import deep_planes

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)


@pytest.mark.parametrize("n_in, n_out", [
    (3072, 1536), (2048, 1024), (96, 48), (72, 48), (48, 32), (10, 7), (7, 10), (48, 96),
    (5, 5), (1, 3), (3, 1),
])
def test_area_matrix_exact(n_in, n_out):
    got, want = area_matrix(n_in, n_out), jax_area_matrix(n_in, n_out)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    band = AreaAxis.from_matrix(got)
    assert np.array_equal(band.matrix(), got)
    assert band.weights.shape[1] <= 1 + -(-n_in // n_out)  # a band, not a dense row
    assert (band.indices() < n_in).all() and (band.indices() >= 0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("scaled, out, exact", [
    ((384, 256), (192, 128), True),  # 2 x 2
    ((384, 512), (96, 128), True),  # 4 x 4
    ((72, 64), (48, 32), False),  # 1.5 x 2
    ((200, 90), (70, 40), False),
    ((48, 32), (96, 48), False),  # upscale: OpenCV's linear branch
])
def test_area_resize_vs_apply_area_resize(scaled, out, exact, dtype):
    (sw, sh), (ow, oh) = scaled, out
    rng = np.random.default_rng(sw + oh)
    hi = 256 if dtype == np.uint8 else 65536
    x = rng.integers(0, hi, (3, sh, sw)).astype(dtype)
    at = AreaTables.build(sw, sh, ow, oh)
    got = area_resize(DeviceArea.from_tables(at, "cpu"), torch.from_numpy(x)).numpy()
    want = np.asarray(apply_area_resize(jnp.asarray(x.astype(np.float32)),
                                        jnp.asarray(jax_area_matrix(sh, oh)),
                                        jnp.asarray(jax_area_matrix(sw, ow))))
    assert got.shape == want.shape == (3, oh, ow) and got.dtype == np.float32
    if exact:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * hi)


def _port_vs_jax(cfg, iw, ih, ow, oh, pix_fmt):
    jp = J.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    tp = plan_from_jax(jp)
    assert tp.luma.area is not None
    assert (tp.luma.scaled_w, tp.luma.scaled_h) == (jp.luma.scaled_w, jp.luma.scaled_h)
    assert np.array_equal(tp.luma.area.row.matrix(), jp.luma.area_row)
    assert np.array_equal(tp.luma.area.col.matrix(), jp.luma.area_col)
    if pix_fmt == "yuv420p":
        planes = [(p >> 2).astype(np.uint8) for p in deep_planes(iw, ih, "yuv420p10le")]
    else:
        planes = deep_planes(iw, ih, pix_fmt)
    got = P.transform_batch(tp, *[torch.from_numpy(p) for p in planes])
    want = jax_transform_batch(jp, *planes)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
        d = np.abs(g.numpy().astype(int) - w.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.002, (d.max(), (d > 0).mean())
    return tp


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
@pytest.mark.parametrize("factors, sizes", [
    ((2.0, 2.0), (512, 256, 192, 128)),
    ((1.5, 2.0), (128, 64, 48, 32)),
])
def test_supersampled_plans_match_jax(factors, sizes, pix_fmt):
    cfg = TransformConfig(width_scale_factor=factors[0], height_scale_factor=factors[1], **MONO)
    tp = _port_vs_jax(cfg, *sizes, pix_fmt)
    iw, ih, ow, oh = sizes
    assert (tp.luma.scaled_w, tp.luma.scaled_h) == (int(factors[0] * ow + 0.5),
                                                    int(factors[1] * oh + 0.5))


def test_supersampled_barrel_matches_jax():
    cfg = TransformConfig(output_layout=Layout.BARREL, width_scale_factor=2.0,
                          height_scale_factor=2.0, enable_low_pass_filter=0, **MONO)
    _port_vs_jax(cfg, 256, 128, 160, 64, "yuv420p")


@pytest.mark.parametrize("factors", [(2.0, 2.0), (1.5, 2.0), (1.0, 1.0)])
def test_own_plan_prefilters_for_the_scaled_size(factors):
    cfg = TransformConfig(width_scale_factor=factors[0], height_scale_factor=factors[1], **MONO)
    jp = J.build_plan(cfg, 512, 256, 96, 64)
    tp = P.build_plan(config_from_jax(cfg), 512, 256, 96, 64)
    for a, b in ((tp.luma, jp.luma), (tp.chroma, jp.chroma)):
        assert (a.scaled_w, a.scaled_h, a.out_w, a.out_h) == (b.scaled_w, b.scaled_h,
                                                              b.out_w, b.out_h)
        assert a.spec.base_y.shape == (b.scaled_h, b.scaled_w)
        assert len(a.blur.bands) == len(b.blur.bands)
        for x, y in zip(a.blur.bands, b.blur.bands):
            assert (x.top, x.height) == (y.top, y.height)
            assert np.array_equal(x.kx, y.kx) and np.array_equal(x.ky, y.ky)
        if b.area_row is None:
            assert a.area is None
        else:
            assert np.array_equal(a.area.row.matrix(), b.area_row)
            assert np.array_equal(a.area.col.matrix(), b.area_col)
        assert a.key == b.key


def test_supersampled_engine_on_the_cpu():
    opts = ("cube_edge_length=32:interpolation_alg=cubic:input_stereo_format=mono:"
            "width_scale_factor=2:height_scale_factor=2")
    eng = P.open_filter(opts, 256, 128, device="cpu")
    assert eng.output_dims() == (96, 64)
    assert (eng.plan.luma.scaled_w, eng.plan.luma.scaled_h) == (192, 128)
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (2, 128, 256), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (2, 64, 128), dtype=np.uint8) for _ in range(2))
    oy, ou, ov = eng.transform(y, u, v)
    assert tuple(oy.shape) == (2, 64, 96) and tuple(ou.shape) == (2, 32, 48)
    one = eng.transform(y[0], u[0], v[0])
    for a, b in zip(one, (oy, ou, ov)):
        assert torch.equal(a, b[0])
