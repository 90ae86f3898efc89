"""Plan-side arrays of the port against the JAX package's: exact.

make_sample_spec and build_blur_plan are numpy in both packages, so on
the same inputs they must agree bit for bit; plan_from_jax carries a
JAX plan across unchanged; the remap weight table holds exactly the
weights tap_arrays computes per pixel."""

import threading

import numpy as np
import pytest

import transform360_tpu as J
from transform360_tpu import geometry as jg
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.filtering import build_blur_plan as j_blur_plan
from transform360_tpu.sampling import make_sample_spec as j_spec, tap_arrays
import transform360_tpu_torch as P
from transform360_tpu_torch import plan as tplan
from transform360_tpu_torch.filtering import build_blur_plan as t_blur_plan
from transform360_tpu_torch.sampling import (
    frac_index, make_sample_spec as t_spec, weight_table,
)

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
SPEC_FIELDS = ("base_y", "base_x", "frac_y", "frac_x", "valid")
BAND_FIELDS = ("kx", "ky", "kx_col", "ky_col")


def _same_spec(a, b):
    for f in SPEC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.in_w, a.in_h, int(a.interp), a.wrap) == (b.in_w, b.in_h, int(b.interp), b.wrap)


def _same_blur(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert (a.eye_w, a.eye_h, a.n_tiles, a.tile_w, int(a.stereo)) == (
        b.eye_w, b.eye_h, b.n_tiles, b.tile_w, int(b.stereo))
    assert len(a.bands) == len(b.bands)
    for x, y in zip(a.bands, b.bands):
        assert (x.top, x.height) == (y.top, y.height)
        for f in BAND_FIELDS:
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.parametrize("interp", list(Interpolation))
@pytest.mark.parametrize("layout", [Layout.CUBEMAP_32, Layout.BARREL])
def test_sample_spec_exact_on_the_same_map(interp, layout):
    cfg = TransformConfig(output_layout=layout, interpolation_alg=interp, **MONO)
    warp = np.asarray(jg.build_warp_map(cfg, 256, 128, 160, 64))
    wrap = layout == Layout.CUBEMAP_32
    _same_spec(t_spec(warp, 256, 128, interp, wrap), j_spec(warp, 256, 128, interp, wrap))


BLUR_CASES = {
    "mono": (TransformConfig(**MONO), 256, 80, 96, 64),
    "vseg7": (TransformConfig(num_vertical_segments=7, **MONO), 256, 80, 96, 64),
    "tb-odd": (TransformConfig(input_stereo_format=StereoFormat.TB,
                               output_stereo_format=StereoFormat.TB), 256, 161, 96, 128),
    "lr-odd": (TransformConfig(input_stereo_format=StereoFormat.LR,
                               output_stereo_format=StereoFormat.LR), 513, 80, 192, 64),
    "adaptive-32x15": (TransformConfig(num_vertical_segments=32,
                                       num_horizontal_segments=15, **MONO), 960, 480, 240, 160),
    "offcenter-adjust": (TransformConfig(num_horizontal_segments=3, fixed_cube_offcenter_z=0.5,
                                         **MONO), 256, 80, 96, 64),
    "no-adjust": (TransformConfig(adjust_kernel=0, num_horizontal_segments=4, **MONO),
                  256, 80, 96, 64),
}


@pytest.mark.parametrize("name", sorted(BLUR_CASES))
def test_blur_plan_exact(name):
    cfg, iw, ih, ow, oh = BLUR_CASES[name]
    _same_blur(t_blur_plan(tplan.config_from_jax(cfg), iw, ih, ow, oh),
               j_blur_plan(cfg, iw, ih, ow, oh))


def test_plan_from_jax_round_trip():
    cfg = TransformConfig(interpolation_alg=Interpolation.LANCZOS4,
                          output_layout=Layout.BARREL, **MONO)
    jp = J.build_plan(cfg, 256, 128, 160, 64)
    tp = tplan.plan_from_jax(jp)
    assert (tp.in_w, tp.in_h, tp.out_w, tp.out_h, tp.pix_fmt, tp.n_planes) == (
        jp.in_w, jp.in_h, jp.out_w, jp.out_h, jp.pix_fmt, jp.n_planes)
    assert tp.cfg.cache_key() == jp.cfg.cache_key()
    for a, b in ((tp.luma, jp.luma), (tp.chroma, jp.chroma)):
        _same_spec(a.spec, b.spec)
        _same_blur(a.blur, b.blur)
        assert (a.key, a.fill, a.in_w, a.in_h, a.out_w, a.out_h) == (
            b.key, b.fill, b.in_w, b.in_h, b.out_w, b.out_h)
    assert (tp.luma.fill, tp.chroma.fill) == (0, 128)


def test_own_plan_matches_jax_plan_except_quantization_flips():
    cfg = TransformConfig(**MONO)
    jp = J.build_plan(cfg, 512, 256, 192, 128)
    tp = P.build_plan(tplan.config_from_jax(cfg), 512, 256, 192, 128)
    for a, b in ((tp.luma, jp.luma), (tp.chroma, jp.chroma)):
        _same_blur(a.blur, b.blur)
        assert a.key == b.key and a.fill == b.fill
        same = (a.spec.base_x == b.spec.base_x) & (a.spec.frac_x == b.spec.frac_x)
        same &= (a.spec.base_y == b.spec.base_y) & (a.spec.frac_y == b.spec.frac_y)
        assert same.mean() >= 0.99


@pytest.mark.parametrize("interp", list(Interpolation))
def test_weight_table_is_tap_arrays_weights(interp):
    cfg = TransformConfig(output_layout=Layout.BARREL, interpolation_alg=interp, **MONO)
    spec = J.build_plan(cfg, 256, 128, 160, 64).luma.spec
    _, weights, _, _ = tap_arrays(spec)
    T = {0: 1, 1: 2, 2: 4, 4: 8}[int(interp)]
    tab = weight_table(interp)
    assert tab.shape == (1024, T * T) and tab.dtype == np.float32
    row = frac_index(spec.frac_y).astype(int) * 32 + frac_index(spec.frac_x).astype(int)
    assert np.array_equal(frac_index(spec.frac_x) / np.float32(32), spec.frac_x)
    if weights is None:  # nearest: no weights at all
        assert np.all(tab == 1.0)
        return
    # tap_arrays zeroes outside taps (and moves them to the fill term);
    # compare where it kept them
    for t, w in enumerate(weights):
        kept = w != 0
        assert np.array_equal(tab[row.reshape(-1), t][kept], w[kept])


def test_build_plan_cache_is_shared_across_threads():
    tplan.clear_plan_cache()
    cfg = P.TransformConfig(**{k: P.StereoFormat(int(v)) for k, v in MONO.items()})
    got, errs = [], []

    def work():
        try:
            got.append(P.build_plan(cfg, 256, 128, 96, 64))
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and not errs
    assert len(got) == 8 and all(p is got[0] for p in got)


def test_device_tables_cached_per_device():
    cfg = P.TransformConfig(**{k: P.StereoFormat(int(v)) for k, v in MONO.items()})
    pp = P.build_plan(cfg, 256, 128, 96, 64).luma
    a, b = pp.tables("cpu"), pp.tables("cpu")
    assert a is b and a.blur.kx.device.type == "cpu" and a.area is None
    assert pp.window_tables("cpu").wtab.shape == (1024, 16) and a.blur.tiles.device.type == "cpu"
    # the prefilter's tiles cover the plane
    assert int((a.blur.tiles[:, 2] * a.blur.tiles[:, 3]).sum()) == pp.in_h * pp.in_w


def test_a_cpu_engine_builds_no_device_spec(monkeypatch):
    # DeviceSpec is the reference remap's input only: neither the plan's
    # device tables nor K3's plain version build one
    from transform360_tpu_torch import pipeline, sampling

    def refuse(*a, **k):
        raise AssertionError("a DeviceSpec was built")

    monkeypatch.setattr(sampling.DeviceSpec, "from_spec", refuse)
    tplan.clear_plan_cache()
    pipeline.clear_executor_cache()
    eng = P.open_filter("cube_edge_length=32:interpolation_alg=cubic:enable_low_pass_filter=1:"
                        "input_stereo_format=mono", 256, 144, device="cpu")
    rng = np.random.default_rng(3)
    y, u, v = (rng.integers(0, 256, (1, h, w), dtype=np.uint8)
               for h, w in ((144, 256), (72, 128), (72, 128)))
    out = eng.transform(y, u, v)
    assert [tuple(o.shape) for o in out] == [(1, 64, 96), (1, 32, 48), (1, 32, 48)]
    assert eng.plan.luma.tables("cpu").blur is not None
