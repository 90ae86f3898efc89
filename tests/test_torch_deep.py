"""Deep pixel formats (10, 12 and 16 bits in uint16 planes) in the port,
against the JAX package's XLA path for them.

* The port's CPU path (K1's and K3's plain versions at uint16, rounded
  and saturated at the depth's maximum) on the JAX package's own plan
  (``plan_from_jax``) against ``transform360_tpu.pipeline.transform_batch``
  on the formats of tests/test_deep_formats.py at 512x256 -> 192x128,
  cubic with the adaptive prefilter: uint16 out, no sample above the
  maximum, and equal byte for byte to the JAX path run op by op
  (``jax.disable_jit``).  Against the jitted JAX path, whose XLA-CPU
  build contracts multiply-adds into FMAs (ROADMAP C), at most 1 LSB on
  at most 0.2% of each plane up to 12 bits; at 16 bits a float32 sum
  near 65535 has an ulp of 1/256, so FMA ties flip more often: at most
  1 LSB on at most 0.5% (measured 0.24-0.36% on these planes; 10 and
  12 bits: at most 0.024%).
* NEAREST and LANCZOS4 at 10 bits; the barrel's chroma fill is the
  10-bit neutral 512.
* The uint16 window plan: every tap row's 32-bit words (2 samples each)
  stay inside its window, chunks are 8 samples, classes follow the byte
  budgets; K3's CPU path equals ``remap_plain`` on uint16 planes,
  saturated samples (65535) included.  K1's uint16 tables: tiles cover
  the plane, two staged buffers fit the budget.
K1 and K3 themselves run only on a GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.pipeline import transform_batch as jax_transform_batch
import transform360_tpu_torch as P
from transform360_tpu_torch.config import chroma_dims, get_pixel_format
from transform360_tpu_torch.filtering import blur_plain
from transform360_tpu_torch.ops import blur, window
from transform360_tpu_torch.plan import config_from_jax, plan_from_jax
from transform360_tpu_torch.sampling import DeviceSpec, remap_plain, round_px
from tests.test_torch_window_plan import check_launch_ranges

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)


def deep_planes(w, h, pix_fmt, frames=2, seed=42):
    """Smooth noisy planes at the format's depth, a few frames (numpy)."""
    pf = get_pixel_format(pix_fmt)
    rng = np.random.default_rng(seed)
    mx = pf.maxval
    yy, xx = np.mgrid[0:h, 0:w]
    ys, us, vs = [], [], []
    for k in range(frames):
        ys.append(np.clip(mx / 2 + (mx / 3) * np.sin((xx + 5 * k) / 15.0) * np.cos(yy / 9.0)
                          + rng.normal(0, mx / 40, (h, w)), 0, mx))
        if pf.n_planes > 1:
            cw, ch = chroma_dims(w, h, pf)
            cy, cx = np.mgrid[0:ch, 0:cw]
            us.append(np.clip(pf.neutral + (mx / 4) * np.sin(cx / 7.0)
                              + rng.normal(0, mx / 60, (ch, cw)), 0, mx))
            vs.append(np.clip(pf.neutral + (mx / 4) * np.cos(cy / 5.0)
                              + rng.normal(0, mx / 60, (ch, cw)), 0, mx))
    return [np.stack(p).astype(np.uint16) for p in (ys, us, vs) if p]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def run_both(cfg, iw, ih, ow, oh, pix_fmt, planes):
    """(port, jitted JAX, op-by-op JAX) outputs as numpy, on one plan."""
    jp = J.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    got = as_tuple(P.transform_batch(plan_from_jax(jp), *[torch.from_numpy(p) for p in planes]))
    jit = as_tuple(jax_transform_batch(jp, *planes))
    with jax.disable_jit():
        eager = as_tuple(jax_transform_batch(jp, *planes))
    return ([g.numpy() for g in got], [np.asarray(a) for a in jit],
            [np.asarray(a) for a in eager])


def assert_parity(got, jit, eager, maxval, tie_frac):
    for k, (g, a, e) in enumerate(zip(got, jit, eager)):
        assert g.dtype == np.uint16 and g.shape == a.shape, (k, g.dtype, g.shape, a.shape)
        assert int(g.max()) <= maxval
        assert np.array_equal(g, e), (k, int(np.abs(g.astype(int) - e).max()))
        d = np.abs(g.astype(int) - a.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= tie_frac, (k, d.max(), (d > 0).mean())


@pytest.mark.parametrize(
    "pix_fmt", ["yuv420p10le", "yuv444p12le", "yuv420p16le", "gbrp10le", "gray16le"]
)
def test_deep_formats_match_jax(pix_fmt):
    pf = get_pixel_format(pix_fmt)
    cfg = TransformConfig(**MONO)  # cubic + the adaptive prefilter
    planes = deep_planes(512, 256, pix_fmt)
    got, jit, eager = run_both(cfg, 512, 256, 192, 128, pix_fmt, planes)
    assert len(got) == pf.n_planes
    assert_parity(got, jit, eager, pf.maxval, 0.005 if pf.depth == 16 else 0.002)


@pytest.mark.parametrize("interp", [Interpolation.NEAREST, Interpolation.LANCZOS4])
def test_deep_interpolators_match_jax(interp):
    cfg = TransformConfig(interpolation_alg=interp, enable_low_pass_filter=0, **MONO)
    planes = deep_planes(512, 256, "yuv420p10le", seed=int(interp))
    got, jit, eager = run_both(cfg, 512, 256, 192, 128, "yuv420p10le", planes)
    assert_parity(got, jit, eager, 1023, 0.002)


def test_deep_barrel_fill_is_scaled_neutral():
    cfg = TransformConfig(output_layout=Layout.BARREL, enable_low_pass_filter=0, **MONO)
    planes = deep_planes(512, 256, "yuv420p10le")
    tp = P.build_plan(config_from_jax(cfg), 512, 256, 320, 128, "yuv420p10le")
    assert (tp.luma.fill, tp.chroma.fill) == (0, 512)
    assert (tp.luma.depth, tp.chroma.depth, tp.chroma.dtype) == (10, 10, torch.uint16)
    assert tp.luma.key.endswith(":d10")
    _, u, v = P.transform_batch(tp, *[torch.from_numpy(p) for p in planes])
    # the barrel's unmapped corners around the polar circles
    assert (u[..., 0, -1] == 512).all() and (v[..., 0, -1] == 512).all()
    got, jit, eager = run_both(cfg, 512, 256, 320, 128, "yuv420p10le", planes)
    assert_parity(got, jit, eager, 1023, 0.002)


def test_deep_engine_on_the_cpu():
    opts = "cube_edge_length=32:interpolation_alg=cubic:input_stereo_format=mono"
    eng = P.open_filter(opts, 256, 128, pix_fmt="yuv420p12le", device="cpu")
    y, u, v = deep_planes(256, 128, "yuv420p12le", frames=3)
    out = eng.transform(y, u, v)
    want = P.transform_batch(eng.plan, *[torch.from_numpy(p) for p in (y, u, v)])
    for a, b in zip(out, want):
        assert a.dtype == torch.uint16 and torch.equal(a, b)
    one = eng.transform(y[1], u[1], v[1])  # an [H, W] frame equals it in the batch
    for a, b in zip(one, out):
        assert torch.equal(a, b[1])
    with pytest.raises(TypeError, match="uint16"):
        eng.transform(y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8))


def _check_u16_window_plan(wp):
    T = wp.taps
    n = wp.meta.shape[0]
    oy0, ox0, y0, x0, wh, pitch = wp.meta.T.astype(np.int64)
    cs = window.VEC // 2  # 8 samples per 16-byte chunk
    ly = (wp.pos & 0xFFFF).reshape(n, -1).astype(np.int64)
    lx = (wp.pos >> 16).reshape(n, -1).astype(np.int64)
    staged = pitch > 0
    assert wp.sample_bytes == 2
    assert (x0 % cs == 0).all() and (pitch % cs == 0).all()
    assert (ly.max(axis=1) + T <= wh)[staged].all()
    assert (lx.max(axis=1) + T <= pitch)[staged].all()
    # every 32-bit word (2 samples) a tap row loads lies inside the window
    for ty in (0, T - 1):
        row = (ly + ty) * pitch[:, None]
        last = row + 2 * ((lx + T - 1) // 2) + 2
        assert (row + 2 * (lx // 2) >= 0)[staged].all()
        assert (last <= (wh * pitch)[:, None])[staged].all()
    # classes follow the byte budgets: two bytes a sample
    nbytes = wh * pitch * 2
    for c, budget in enumerate(window.CLASS_BYTES):
        sel = wp.tile_class == c
        assert (nbytes[sel] <= budget).all()
        if c:
            assert (nbytes[sel] > window.CLASS_BYTES[c - 1]).all()
    for first, count, win, fp in wp.groups:
        assert win % window.VEC == 0 and window.smem_bytes(win, fp) <= window.SMEM_MAX
        assert (nbytes[first:first + count] <= win).all()
    check_launch_ranges(wp, 2)
    need = (ly.max(axis=1) + T) * (-(-(lx.max(axis=1) + T) // cs) * cs) * 2
    assert (need[~staged] > window.CLASS_BYTES[-1]).all()
    return staged


U16_CASES = {
    "cubemap-cubic": (TransformConfig(enable_low_pass_filter=0, **MONO), 1024, 512, 384, 256),
    "decimated": (TransformConfig(enable_low_pass_filter=0, **MONO), 2048, 1024, 192, 128),
    "barrel-linear": (TransformConfig(output_layout=Layout.BARREL,
                                      interpolation_alg=Interpolation.LINEAR,
                                      enable_low_pass_filter=0, **MONO), 512, 256, 320, 128),
    "barrel-lanczos4": (TransformConfig(output_layout=Layout.BARREL_SPLIT,
                                        interpolation_alg=Interpolation.LANCZOS4,
                                        enable_low_pass_filter=0, **MONO), 512, 256, 384, 128),
    "cubemap-nearest-ragged": (TransformConfig(interpolation_alg=Interpolation.NEAREST,
                                               enable_low_pass_filter=0, **MONO),
                               1000, 500, 150, 100),
}


@pytest.mark.parametrize("name", sorted(U16_CASES))
def test_uint16_window_plan_and_plain_path(name):
    cfg, iw, ih, ow, oh = U16_CASES[name]
    jp = J.build_plan(cfg, iw, ih, ow, oh, "yuv420p16le")
    pp = plan_from_jax(jp).luma
    wp8 = window.build_window_plan(pp.spec, pp.fill)
    wp = window.build_window_plan(pp.spec, pp.fill, 2)
    staged = _check_u16_window_plan(wp)
    assert wp.meta.shape == wp8.meta.shape  # the same tiles; windows of twice the bytes
    if name == "decimated":
        assert (~staged).any()
    # the wrapper's CPU path at uint16: remap_plain, rounded and saturated
    rng = np.random.default_rng(7)
    x = rng.integers(0, 65536, (3, ih, iw), dtype=np.uint16)
    x[1] = 65535  # a saturated frame
    x = torch.from_numpy(x)
    wt = window.WindowTables.from_plan(wp, "cpu")
    want = remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, "cpu"), x)
    assert torch.equal(window.remap_window_plain(wt, x), want)
    got = window.remap_window_px(wt, x, 65535)
    assert got.dtype == torch.uint16 and torch.equal(got, round_px(want, 65535, torch.uint16))
    with pytest.raises(TypeError):
        window.remap_window_px(wt, x.to(torch.int32).to(torch.uint8))


@pytest.mark.parametrize("name", ["mono", "tb-odd", "wide-y"])
def test_uint16_blur_tables(name):
    cfg, iw, ih = {
        "mono": (TransformConfig(**MONO), 512, 256),
        "tb-odd": (TransformConfig(input_stereo_format=StereoFormat.TB,
                                   output_stereo_format=StereoFormat.TB), 256, 161),
        "wide-y": (TransformConfig(min_kernel_half_height=5, **MONO), 256, 80),
    }[name]
    pp = plan_from_jax(J.build_plan(cfg, iw, ih, 96, 64, "gray10le")).luma
    b8 = blur.BlurTables.from_plan(pp.blur, ih, iw, "cpu")
    b16 = blur.BlurTables.from_plan(pp.blur, ih, iw, "cpu", 2)
    t = b16.tiles.numpy().astype(np.int64)
    assert int((t[:, 2] * t[:, 3]).sum()) == ih * iw  # tiles cover the plane once
    assert b16.ring_ry == b8.ring_ry and b16.sample_bytes == 2
    if b16.ring_ry >= 0:
        staged = t[:, 4] >= 0
        assert (t[staged, 5] % 8 == 0).all()  # staged rows start 16-byte aligned (TMA)
        assert (t[:, 3] <= blur.tile_width(2)).all() and blur.tile_width(2) < blur.tile_width(1)
        # a staged row of 768 samples and its halo is one TMA box
        assert (b16.row_bytes, b16.pitch) == blur.staged_row(int(b16.rx.max()), 2)
        assert b16.row_bytes <= blur.ROW_MAX
        assert blur.STAGES * b16.slab * b16.pitch <= blur.SMEM_CTA
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1024, (2, ih, iw), dtype=np.uint16))
    got = blur.blur_px(b16, x, 1023)
    assert got.dtype == torch.uint16
    assert torch.equal(got, round_px(blur_plain(pp.blur, x.float()), 1023, torch.uint16))
    with pytest.raises(TypeError):
        blur.blur_px(b8, x, 1023)
    with pytest.raises(ValueError):
        blur.blur_px(b8, x.to(torch.int32).to(torch.uint8), 1023)  # uint8 saturates at 255
