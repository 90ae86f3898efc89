"""The remap (K3's tile plan and plain version) against the port's plain
remap and the JAX package's window-gather kernel B5.

* The tile plan's invariants: tiles partition the output; every tap of a
  windowed tile lies in its window, and so does every 32-bit word the
  kernel loads for a tap row; each class fits its budget and each launch
  its shared memory; tiles whose window exceeds the largest class are
  flagged for the global path; the launch ranges (class 0's small
  windows, its others, the larger class: tests/test_torch_window_plan.py).
  How a launch splits the batch among CTAs and the frames a pass of each
  launch's shared memory.
* ``remap_window_plain`` walks that plan and equals ``remap_plain`` byte
  for byte (the unrounded floats too): every interpolator on a wrapping
  cubemap, and the barrel's clamp-with-fill (linear) and REFLECT_101
  (lanczos4) rules, at batch 1, 2, 4 and 7, and on ragged tiles.
* The port against ``remap_pallas(interpret=True)`` with the pipeline's
  BORDER_TRANSPARENT fix-up: at most 1 LSB on under 0.5% of pixels (B5
  forms its y weights in float32 in-kernel and sums y first).  Each
  interpret run compiles for about 10-20 s, so the cases are a subset of
  tests/test_remap_pallas.py's configurations: window classes and pole
  tiles, the transparent border, the residual XLA fallback and a short
  input, at batch 1 and 4.
* The route: every plane batch, 1 to 256, takes K3's wrapper and no
  other remap; a frame alone equals the same frame inside a batch of 8
  and of 33 byte for byte, and a single [H, W] frame matches the JAX
  engine at the fidelity gate's size.
K3 itself runs only on a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu.fidelity import _video_like_planes
from transform360_tpu.ops.remap_pallas import build_pallas_remap, remap_pallas
from transform360_tpu.pipeline import _round_u8
from transform360_tpu.sampling import fixup_values, partial_fixup
import transform360_tpu_torch as P
from transform360_tpu_torch import pipeline
from transform360_tpu_torch.ops import sources, window
from transform360_tpu_torch.ops.window import (
    CLASS_BYTES,
    SMEM_MAX,
    TH,
    TW,
    WindowTables,
    build_window_plan,
    remap_window_plain,
    remap_window_px,
    smem_bytes,
)
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.sampling import DeviceSpec, remap_plain, round_u8
from tests.test_torch_window_plan import check_launch_ranges

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
FMA_TIE_FRAC = 0.002  # the bound of tests/test_torch_pipeline.py


def _cfg(layout=Layout.CUBEMAP_32, interp=Interpolation.CUBIC, **kw):
    kw = {**MONO, **kw}
    return TransformConfig(output_layout=layout, interpolation_alg=interp,
                           enable_low_pass_filter=0, **kw)


def _port_plane(cfg, iw, ih, ow, oh, plane=0):
    """The port's plane plan on the JAX plan (so both packages share it)."""
    jp = J.build_plan(cfg, iw, ih, ow, oh)
    tp = plan_from_jax(jp)
    return (jp.luma, tp.luma) if plane == 0 else (jp.chroma, tp.chroma)


PLAN_CASES = {
    # cubemap with a second class (pole tiles) and odd chroma sizes
    "cubemap": (_cfg(), 1024, 512, 384, 256),
    # odd output size: ragged last tile row and column
    "cubemap-odd": (_cfg(interp=Interpolation.LANCZOS4), 1000, 500, 190, 130),
    # heavy decimation: pole windows exceed every class -> global path
    "decimated": (_cfg(), 2048, 1024, 192, 128),
    # short input: a window taller than the plane wraps onto itself
    "short": (_cfg(), 512, 96, 192, 128),
    "barrel-linear": (_cfg(Layout.BARREL, Interpolation.LINEAR), 1024, 512, 640, 256),
    "barrel-lanczos4": (_cfg(Layout.BARREL_SPLIT, Interpolation.LANCZOS4), 512, 256, 384, 128),
    # one tap (a window of the bases alone) and two taps, ragged tiles
    "cubemap-nearest": (_cfg(interp=Interpolation.NEAREST), 1024, 512, 150, 100),
    "eac-linear": (_cfg(Layout.EAC_32, Interpolation.LINEAR), 1024, 512, 390, 260),
    # a flat view: windows of a small part of the plane, no seam
    "flat-cubic": (_cfg(Layout.FLAT_FIXED), 1024, 512, 200, 120),
}


def _check_plan(wp):
    T = wp.taps
    n = wp.meta.shape[0]
    oy0, ox0, y0, x0, wh, pitch = wp.meta.T.astype(np.int64)
    # tiles partition the output: every pixel exactly once
    assert n == -(-wp.out_h // TH) * -(-wp.out_w // TW)
    assert wp.pos.size == n * TH * TW
    p = np.arange(TH * TW)
    oy = (oy0[:, None] + p // TW).reshape(-1)
    ox = (ox0[:, None] + p % TW).reshape(-1)
    inside = (oy < wp.out_h) & (ox < wp.out_w)
    hits = np.bincount(oy[inside] * wp.out_w + ox[inside], minlength=wp.out_h * wp.out_w)
    assert (hits == 1).all()
    # launch groups cover the tiles in order
    assert sum(g[1] for g in wp.groups) == n
    assert [g[0] for g in wp.groups] == list(np.cumsum([0] + [g[1] for g in wp.groups])[:-1])
    check_launch_ranges(wp)
    ly = (wp.pos & 0xFFFF).reshape(n, -1).astype(np.int64)
    lx = (wp.pos >> 16).reshape(n, -1).astype(np.int64)
    assert (x0 % window.VEC == 0).all() and (lx >= 0).all()
    staged = pitch > 0
    assert ((wp.tile_class >= 0) == staged).all()
    # every tap of a windowed tile lies in its window
    assert (ly.max(axis=1) + T <= wh)[staged].all()
    assert (lx.max(axis=1) + T <= pitch)[staged].all()
    assert (pitch % window.VEC == 0).all()
    # every word a tap row loads (first tap's word to last tap's word,
    # window-relative bytes [4 * (o // 4), 4 * ((o + T - 1) // 4) + 4) of
    # row ly + ty) lies inside the CTA's window buffer
    for ty in (0, T - 1):
        row = (ly + ty) * pitch[:, None]
        first = row + 4 * (lx // 4)
        last = row + 4 * ((lx + T - 1) // 4) + 4
        assert (first >= 0)[staged].all()
        assert (last <= (wh * pitch)[:, None])[staged].all()
    # each class fits its budget, and each launch's shared memory fits the SM
    nbytes = wh * pitch
    for c, budget in enumerate(CLASS_BYTES):
        sel = wp.tile_class == c
        assert (nbytes[sel] <= budget).all()
        if c:
            assert (nbytes[sel] > CLASS_BYTES[c - 1]).all()
    for first, count, win, fp in wp.groups:
        assert win % window.VEC == 0 and smem_bytes(win, fp) <= SMEM_MAX
        assert smem_bytes(win, fp) == 2 * fp * win + win // 4
        assert (nbytes[first:first + count] <= win).all()
    # oversized tiles are flagged: the window they would need exceeds the
    # largest class
    need = (ly.max(axis=1) + T) * (-(-(lx.max(axis=1) + T) // window.VEC) * window.VEC)
    assert (need[~staged] > CLASS_BYTES[-1]).all()
    return staged


@pytest.mark.parametrize("plane", [0, 1])
@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_tile_plan_invariants(name, plane):
    _, pp = _port_plane(*PLAN_CASES[name], plane=plane)
    staged = _check_plan(build_window_plan(pp.spec, pp.fill))
    if name == "decimated" and plane == 0:
        assert (~staged).sum() > 0


def test_frames_per_cta_and_pairs():
    # a CTA loops over the whole batch once the launch has enough tiles,
    # splits it below CTAS_TARGET CTAs, and never below CTA_FRAMES_MIN
    assert window.frames_per_cta(128, 6064) == 128
    assert window.frames_per_cta(1, 80) == 1
    assert window.frames_per_cta(256, 1512) == 128  # two groups
    assert window.frames_per_cta(256, 384) == 43  # six groups
    # a launch's shared memory: two passes of its frames' windows and the
    # chunk table; class 0's small windows take WIDE_FRAMES frames a pass
    # on batches of more than CTA_FRAMES_MIN frames, its others two, the
    # larger class one
    assert smem_bytes(12 * 1024, 2) == 4 * 12 * 1024 + 3 * 1024
    assert smem_bytes(64 * 1024, 1) == 2 * 64 * 1024 + 16 * 1024
    assert smem_bytes(3 * 1024, 8) == 16 * 3 * 1024 + 768
    groups = ((0, 100, 2048, 8), (100, 20, 9216, 2), (120, 4, 40960, 1))
    assert window.launches(groups, 17) == [(0, 100, 2048, 8, 17), (100, 20, 9216, 2, 17),
                                           (120, 4, 40960, 1, 17)]
    assert window.launches(groups, 16) == [(0, 120, 9216, 2, 16), (120, 4, 40960, 1, 16)]
    # a CTA walks one source's frames: U and V of 16 frames each, not 32;
    # a launch of few tiles splits a long batch into CTAs of 16 frames
    assert window.launches(groups, 32, 16) == [(0, 120, 9216, 2, 16), (120, 4, 40960, 1, 16)]
    assert window.launches(groups, 34, 17) == [
        (0, 100, 2048, 8, 17), (100, 20, 9216, 2, 17), (120, 4, 40960, 1, 17)]
    assert window.launches(groups, 128)[0] == (0, 100, 2048, 8, 16)
    assert window.launches(groups[:1] + groups[2:], 1) == [(0, 100, 2048, 2, 1),
                                                           (120, 4, 40960, 1, 1)]


@pytest.mark.parametrize("B, n_tiles", [
    (1, 6144), (2, 1512), (7, 3), (16, 80), (128, 6064), (128, 80), (256, 1512),
    (256, 24), (1024, 1), (200000, 1),
])
def test_frames_per_cta_splits_the_batch(B, n_tiles):
    # the groups cover the batch; there are no more of them than reach
    # CTAS_TARGET CTAs or than the grid's y axis holds, and each takes at
    # least CTA_FRAMES_MIN frames unless the y axis forces smaller ones
    f = window.frames_per_cta(B, n_tiles)
    groups = -(-B // f)
    assert 1 <= f <= B and groups <= 65535
    if groups > 1:
        assert (groups - 1) * n_tiles < window.CTAS_TARGET or f * 65535 >= B
        assert f >= window.CTA_FRAMES_MIN or -(-B // 65535) == f


WINDOW_CASES = [
    (layout, interp)
    for layout in (Layout.CUBEMAP_32,)
    for interp in Interpolation
] + [
    (Layout.BARREL, Interpolation.LINEAR),  # BORDER_FILL
    (Layout.BARREL, Interpolation.NEAREST),
    (Layout.BARREL_SPLIT, Interpolation.LANCZOS4),  # BORDER_REFLECT_101
]


@pytest.mark.parametrize("batch", [1, 2, 4, 7])
@pytest.mark.parametrize("layout, interp", WINDOW_CASES)
def test_remap_window_plain_equals_remap_plain(layout, interp, batch):
    ow = 96 if layout == Layout.CUBEMAP_32 else 160 if layout == Layout.BARREL else 192
    cfg = P.TransformConfig(output_layout=P.Layout(int(layout)),
                            interpolation_alg=P.Interpolation(int(interp)),
                            input_stereo_format=P.StereoFormat.MONO,
                            output_stereo_format=P.StereoFormat.MONO)
    plan = P.build_plan(cfg, 256, 128, ow, 64, "yuv420p")
    rng = np.random.default_rng(batch)
    for pp in (plan.luma, plan.chroma):
        x = torch.from_numpy(rng.integers(0, 256, (batch, pp.in_h, pp.in_w), dtype=np.uint8))
        wt = WindowTables.from_plan(build_window_plan(pp.spec, pp.fill), "cpu")
        got = remap_window_plain(wt, x)
        want = remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, "cpu"), x)
        assert torch.equal(got, want)
        # the CPU path of the wrapper is the plain version, rounded
        assert torch.equal(remap_window_px(wt, x), round_u8(want))


RAGGED = {Layout.CUBEMAP_32: ((150, 100), (90, 60)), Layout.BARREL: ((170, 68), (100, 40)),
          Layout.BARREL_SPLIT: ((210, 70), (102, 34))}


@pytest.mark.parametrize("size", [0, 1])
@pytest.mark.parametrize("layout, interp", WINDOW_CASES)
def test_remap_window_plain_on_ragged_tiles(layout, interp, size):
    # output sizes that are multiples of neither tile side: the last tile
    # row and column are ragged
    ow, oh = RAGGED[layout][size]
    assert ow % TW and oh % TH
    cfg = P.TransformConfig(output_layout=P.Layout(int(layout)),
                            interpolation_alg=P.Interpolation(int(interp)),
                            input_stereo_format=P.StereoFormat.MONO,
                            output_stereo_format=P.StereoFormat.MONO)
    plan = P.build_plan(cfg, 256, 128, ow, oh, "yuv420p")
    rng = np.random.default_rng(ow)
    for pp in (plan.luma, plan.chroma):
        x = torch.from_numpy(rng.integers(0, 256, (3, pp.in_h, pp.in_w), dtype=np.uint8))
        wt = WindowTables.from_plan(build_window_plan(pp.spec, pp.fill), "cpu")
        want = remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, "cpu"), x)
        assert torch.equal(remap_window_plain(wt, x), want)


B5_CASES = {
    "cubemap-classes-b1": (_cfg(), 1024, 512, 384, 256, 1),
    "barrel-fixup-b4": (_cfg(Layout.BARREL, Interpolation.LINEAR), 1024, 512, 640, 256, 4),
    "fallback-b4": (_cfg(), 2048, 1024, 192, 128, 4),
    "short-input-b1": (_cfg(), 512, 96, 192, 128, 1),
}


@pytest.mark.parametrize("name", sorted(B5_CASES))
def test_port_vs_remap_pallas_interpret(name):
    cfg, iw, ih, ow, oh, batch = B5_CASES[name]
    jpp, tpp = _port_plane(cfg, iw, ih, ow, oh)
    pplan = build_pallas_remap(jpp.spec, jpp.fill)
    assert pplan is not None
    x = np.random.default_rng(5).integers(0, 256, (batch, jpp.in_h, jpp.in_w), dtype=np.uint8)
    want = np.array(remap_pallas(pplan, jnp.asarray(x), interpret=True))
    fix = partial_fixup(jpp.spec, float(jpp.fill))
    if fix is not None:  # the pipeline's BORDER_TRANSPARENT patch (pipeline.py:276-284)
        vals = np.asarray(_round_u8(fixup_values(fix, jnp.asarray(x).reshape(batch, -1))))
        want = want.reshape(batch, -1)
        want[:, fix[0]] = vals
        want = want.reshape(batch, jpp.out_h, jpp.out_w)
    wt = WindowTables.from_plan(build_window_plan(tpp.spec, tpp.fill), "cpu")
    got = remap_window_px(wt, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.005, (diff > 0).mean()


def _count_routes(monkeypatch):
    """Plane batches that reach K3's wrapper; the pipeline has no other remap."""
    assert not hasattr(pipeline, "remap_u8") and not hasattr(pipeline, "WINDOW_MAX_BATCH")
    calls = []
    real = pipeline.remap_window_px

    def spy(wt, x, *rest):  # x: a plane batch, or its sources
        calls.append(sources.frames(sources.as_sources(x)))
        return real(wt, x, *rest)

    monkeypatch.setattr(pipeline, "remap_window_px", spy)
    return calls


def test_frame_alone_equals_frame_in_batch_of_8(monkeypatch):
    opts = "cube_edge_length=64:interpolation_alg=cubic:enable_low_pass_filter=1:input_stereo_format=mono"
    y, u, v = _video_like_planes(512, 256)
    n = 33  # an odd batch; its chroma is a plane batch of 66
    frames = [np.stack([np.roll(p, 9 * k, axis=1) for k in range(n)]) for p in (y, u, v)]
    eng = P.open_filter(opts, 512, 256, device="cpu")
    calls = _count_routes(monkeypatch)
    alone = eng.transform(*(f[5] for f in frames))
    batch8 = eng.transform(*(f[:8] for f in frames))
    big = eng.transform(*frames)
    # luma and the stacked chroma (2 planes per frame) each take K3
    assert calls == [1, 2, 8, 16, n, 2 * n]
    for a, b8, bn in zip(alone, batch8, big):
        assert torch.equal(b8[5], a) and torch.equal(bn[5], a)


def test_route_threshold(monkeypatch):
    # no threshold any more: every plane batch takes K3
    eng = P.open_filter("cube_edge_length=32:input_stereo_format=mono", 256, 128,
                        pix_fmt="gray", device="cpu")
    calls = _count_routes(monkeypatch)
    x = np.random.default_rng(0).integers(0, 256, (256, 128, 256), dtype=np.uint8)
    for b in (1, 64, 65, 128, 256):
        eng.transform(x[:b])
    assert calls == [1, 64, 65, 128, 256]


def test_single_frame_engine_vs_jax_at_gate_size():
    opts = "cube_edge_length=160:interpolation_alg=cubic:enable_low_pass_filter=1:input_stereo_format=mono"
    y, u, v = _video_like_planes(1920, 960)
    jf = J.open_filter(opts, 1920, 960)
    want = jf.transform(y, u, v)
    eng = P.Transform360(P.parse_options(opts).config, device="cpu")
    eng.use_plan(plan_from_jax(jf.plan))
    got = eng.transform(y, u, v)  # [H, W] planes: one frame, K3's route
    for a, b, name in zip(got, want, "YUV"):
        assert tuple(a.shape) == b.shape == ((320, 480) if name == "Y" else (160, 240))
        d = np.abs(a.numpy().astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= FMA_TIE_FRAC, (name, d.max(), (d > 0).mean())
