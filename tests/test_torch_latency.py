"""Single-frame latency bands in the port (``transform360_tpu_torch.parallel.latency``)
against its own unbanded path and against the JAX package.

* Banded == unbanded, byte for byte, on the port's plain path (``devices=
  ["cpu"]``): n = 1, 3 and 8; supersampled 1.5x2.0 at n = 5; barrel fill
  at n = 4; TB stereo; gray; a 10-bit plane at n = 3 (the cases of
  tests/test_latency_shard.py), with uniform and cost-model edges, over
  several devices in turn and over band groups.
* The band plans equal the JAX package's band plans of the same plan
  (``plan_from_jax``) array by array: first taps, fractions, masks and
  the INTER_AREA rows after the port's re-clamp into the band.  One
  banded JAX frame against the port's on the same plan: at most 1 LSB on
  at most 0.2% of a plane (the FMA ties of jitted XLA, ROADMAP C).
* ``local_band_range``, ``_cost_edges`` and ``broadcast_ms`` (with
  explicit rates) equal the JAX functions on the same arguments; the
  port's broadcast model has no device-to-device default.
"""

import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.config import Interpolation as JInterp
from transform360_tpu.config import Layout as JLayout
from transform360_tpu.config import StereoFormat as JStereo
from transform360_tpu.parallel import latency as JL
import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu_torch.parallel import latency as L
from transform360_tpu_torch.plan import _plane_from, plan_from_jax

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
JMONO = dict(input_stereo_format=JStereo.MONO, output_stereo_format=JStereo.MONO)


def make_frame(rng, h, w, pf="yuv420p"):
    pf = P.config.get_pixel_format(pf)
    dt = np.uint8 if pf.depth == 8 else np.uint16
    cw, ch = P.chroma_dims(w, h, pf)
    planes = [rng.integers(0, pf.maxval + 1, (h, w)).astype(dt)]
    return planes + [rng.integers(0, pf.maxval + 1, (ch, cw)).astype(dt)
                     for _ in range(pf.n_planes - 1)]


def unbanded(plan, planes):
    out = P.transform_batch(plan, *planes, device="cpu")
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def check(plan, planes, n, devices=("cpu",), **kw):
    got = L.transform_frame_banded(plan, planes, devices=list(devices), n=n, **kw)
    want = unbanded(plan, planes)
    assert len(got) == plan.n_planes
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# (name, config, in_wh, out_wh, pix_fmt, n): the cases of tests/test_latency_shard.py
CASES = [
    ("n1", TransformConfig(**MONO), (128, 64), (48, 32), "yuv420p", 1),
    ("n3", TransformConfig(**MONO), (128, 64), (48, 32), "yuv420p", 3),
    ("n8", TransformConfig(**MONO), (128, 64), (48, 32), "yuv420p", 8),
    ("supersampled", TransformConfig(width_scale_factor=1.5, height_scale_factor=2.0, **MONO),
     (128, 64), (48, 32), "yuv420p", 5),
    ("barrel", TransformConfig(output_layout=Layout.BARREL, **MONO), (128, 64), (64, 36),
     "yuv420p", 4),
    ("stereo_tb", TransformConfig(input_stereo_format=StereoFormat.TB,
                                  output_stereo_format=StereoFormat.TB),
     (128, 128), (48, 64), "yuv420p", 8),
    ("gray", TransformConfig(interpolation_alg=Interpolation.LINEAR, **MONO), (128, 64),
     (48, 32), "gray", 8),
    ("10bit", TransformConfig(**MONO), (128, 64), (48, 32), "yuv420p10le", 3),
]


@pytest.mark.parametrize("name, cfg, in_wh, out_wh, pf, n", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("row_costs", [None, "auto"])
def test_banded_matches_unbanded(rng, name, cfg, in_wh, out_wh, pf, n, row_costs):
    plan = P.build_plan(cfg, *in_wh, *out_wh, pf)
    if name == "supersampled":
        assert plan.luma.area is not None and plan.luma.scaled_h == 64
    check(plan, make_frame(rng, in_wh[1], in_wh[0], pf), n, row_costs=row_costs)


def test_bands_over_devices_in_turn_and_band_groups(rng):
    """Bands dealt round-robin over more or fewer devices than bands, the
    async grid (several frames in flight before any gather) and band
    groups stitched in order: all give the unbanded bytes."""
    plan = P.build_plan(TransformConfig(**MONO), 128, 64, 48, 32)
    frames = [make_frame(rng, 64, 128) for _ in range(3)]
    check(plan, frames[0], 7, devices=["cpu"] * 3)
    check(plan, frames[0], 2, devices=["cpu"] * 5)
    inflight = [L.transform_frame_banded_async(plan, f, devices=["cpu"] * 2, n=2)
                for f in frames]
    for f, bf in zip(frames, inflight):
        for g, w in zip(bf.gather(), unbanded(plan, f)):
            np.testing.assert_array_equal(g, w)
    ranges = [L.local_band_range(5, p, 2) for p in range(2)]
    assert ranges == [(0, 3), (3, 5)]
    parts = [L.transform_frame_banded(plan, frames[0], devices=["cpu"], n=5, bands_slice=r)
             for r in ranges]
    for j, w in enumerate(unbanded(plan, frames[0])):
        np.testing.assert_array_equal(np.concatenate([p[j] for p in parts]), w)
    # tensors in, on their own device
    tens = [torch.from_numpy(p) for p in frames[1]]
    for g, w in zip(L.transform_frame_banded(plan, tens, devices=["cpu"], n=3),
                    unbanded(plan, frames[1])):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="bands_slice"):
        L.transform_frame_banded(plan, frames[0], devices=["cpu"], n=5, bands_slice=(3, 9))
    with pytest.raises(ValueError, match="row_costs"):
        L.transform_frame_banded(plan, frames[0], devices=["cpu"], row_costs="bogus")
    with pytest.raises(ValueError, match="plane"):
        L.transform_frame_banded(plan, frames[0][:2], devices=["cpu"])
    with pytest.raises(ValueError, match="outside"):
        L.local_band_range(4, 2, 2)


def test_band_plans_structure_and_memo():
    plan = P.build_plan(TransformConfig(**MONO), 128, 64, 48, 32)
    bands = L.band_plans(plan, 5)
    assert sum(b.luma.out_h for b in bands) == plan.luma.out_h
    for b in bands:
        assert b.luma.out_h == 2 * b.chroma.out_h  # aligned to the chroma ratio
        assert b.luma.key.startswith(plan.luma.key + "|band")
        assert b.luma._cache is not plan.luma._cache and b.luma.blur is plan.luma.blur
    assert len(L.band_plans(plan, 64)) == plan.chroma.out_h  # clamped, no empty band
    # memoized: the same band plans (and so their device tables) every frame
    assert L.band_plans(plan, 5) is bands
    assert L.band_plans(plan, 5)[0].luma.tables("cpu") is bands[0].luma.tables("cpu")
    assert L.band_plans(plan, 5, "auto") is L.band_plans(plan, 5, "auto")
    costs = np.concatenate([np.full(16, 10.0), np.full(16, 1.0)])
    heights = [b.luma.out_h for b in L.band_plans(plan, 4, costs)]
    assert sum(heights) == 32 and heights[0] < heights[-1]  # the costly top is short
    degen = np.zeros(32)
    degen[0] = 1.0
    assert min(b.luma.out_h for b in L.band_plans(plan, 8, degen)) >= 2  # one unit each
    with pytest.raises(ValueError, match="row_costs"):
        L.band_plans(plan, 2, "bogus")


def test_plan_row_costs_model():
    """K3's tiles per output row, weighted by their class's window bytes,
    chroma counted twice; a supersampled plan folds its scaled rows."""
    from transform360_tpu_torch.ops.window import CLASS_BYTES, TH, row_costs

    plan = P.build_plan(TransformConfig(**MONO), 512, 256, 384, 256)
    costs = L.plan_row_costs(plan)
    assert costs.shape == (256,) and (costs > 0).all()
    wp = plan.luma.window_plan()
    luma = row_costs(wp)
    assert np.array_equal(L._plane_row_costs(plan.luma), luma)  # no fold at scale 1
    assert plan.luma.window_plan() is wp  # built once, shared with window_tables
    win = {}  # a class's largest launch window: class 0 has two launches
    for f, c, w, _ in wp.groups:
        win[int(wp.tile_class[f + c - 1])] = max(w, win.get(int(wp.tile_class[f + c - 1]), 0))
    weight = np.array([win[c] if c >= 0 else CLASS_BYTES[-1] for c in wp.tile_class.tolist()])
    rows = np.minimum(TH, wp.out_h - wp.meta[:, 0]) / TH  # a ragged last tile row
    assert luma.sum() == pytest.approx(float((weight * rows).sum()))
    chroma = L._plane_row_costs(plan.chroma)
    assert costs.sum() == pytest.approx(luma.sum() + 2 * chroma.sum())
    ss = P.build_plan(TransformConfig(width_scale_factor=2.0, height_scale_factor=2.0, **MONO),
                      256, 128, 96, 64)
    folded = L._plane_row_costs(ss.luma)
    assert folded.shape == (64,)
    assert folded.sum() == pytest.approx(L._plane_row_costs(
        P.build_plan(TransformConfig(**MONO), 256, 128, 192, 128).luma).sum())


# ------------------------------------------------------------ the JAX package

JAX_CASES = {
    "cubemap": (dict(**JMONO), (128, 64), (48, 32), "yuv420p"),
    "supersampled": (dict(width_scale_factor=1.5, height_scale_factor=2.0, **JMONO),
                     (128, 64), (48, 32), "yuv420p"),
    "barrel": (dict(output_layout=JLayout.BARREL, interpolation_alg=JInterp.LINEAR, **JMONO),
               (128, 64), (64, 36), "yuv420p"),
    "10bit_tb": (dict(input_stereo_format=JStereo.TB, output_stereo_format=JStereo.TB),
                 (128, 128), (48, 64), "yuv420p10le"),
}


def _jax_plan(name):
    kw, (iw, ih), (ow, oh), pf = JAX_CASES[name]
    return J.build_plan(J.TransformConfig(**kw), iw, ih, ow, oh, pf)


@pytest.mark.parametrize("name", list(JAX_CASES))
@pytest.mark.parametrize("n, costs", [(3, None), (5, None), (4, "ramp")])
def test_band_plans_equal_the_jax_packages(name, n, costs):
    jp = _jax_plan(name)
    if costs == "ramp":
        costs = np.linspace(4.0, 1.0, jp.luma.out_h)
    mine = L.band_plans(plan_from_jax(jp), n, costs)
    theirs = JL.band_plans(jp, n, costs)
    assert len(mine) == len(theirs)
    for b, jb in zip(mine, theirs):
        for pp, jpp in ((b.luma, jb.luma), (b.chroma, jb.chroma)):
            want = _plane_from(jpp)
            assert (pp.out_h, pp.scaled_h, pp.out_w) == (jpp.out_h, jpp.scaled_h, jpp.out_w)
            for k in ("base_y", "base_x", "frac_y", "frac_x"):
                np.testing.assert_array_equal(getattr(pp.spec, k), getattr(want.spec, k))
            assert (pp.spec.valid is None) == (jpp.spec.valid is None)
            if pp.spec.valid is not None:
                np.testing.assert_array_equal(pp.spec.valid, want.spec.valid)
            assert (pp.area is None) == (jpp.area_row is None)
            if pp.area is not None:
                # the band's rows over its own scaled rows, re-clamped: every
                # index inside the band, the nonzero weights the JAX rows'
                idx = pp.area.row.indices()
                assert idx.min() >= 0 and idx.max() < pp.scaled_h
                m = pp.area.row.matrix()
                assert m.shape == np.asarray(jpp.area_row).shape
                nz = m != 0
                np.testing.assert_array_equal(nz, np.asarray(jpp.area_row) != 0)
                np.testing.assert_array_equal(m[nz], np.asarray(jpp.area_row)[nz])


def test_banded_frame_equals_the_jax_packages(rng):
    """One banded JAX frame (n = 3; it compiles per band) against the
    port's on the same plan."""
    jp = _jax_plan("cubemap")
    planes = make_frame(rng, 64, 128)
    theirs = JL.transform_frame_banded(jp, planes, n=3)
    mine = L.transform_frame_banded(plan_from_jax(jp), planes, devices=["cpu"], n=3)
    for g, w in zip(mine, theirs):
        d = np.abs(g.astype(int) - np.asarray(w).astype(int))
        assert g.shape == w.shape and d.max() <= 1 and (d > 0).mean() <= 0.002


@pytest.mark.parametrize("n_bands, nproc", [(5, 2), (8, 3), (2, 2), (7, 1), (16, 4)])
def test_local_band_range_equals_the_jax_function(n_bands, nproc):
    for p in range(nproc):
        assert L.local_band_range(n_bands, p, nproc) == JL.local_band_range(n_bands, p, nproc)
    assert L.local_band_range(n_bands) == (0, n_bands)  # one process outside a group


@pytest.mark.parametrize("units, r, n", [(16, 2, 4), (16, 2, 8), (512, 2, 3), (100, 1, 7)])
def test_cost_edges_equal_the_jax_function(units, r, n):
    for costs in (np.linspace(5.0, 1.0, units * r),
                  np.abs(np.sin(np.arange(units * r) / 9.0)) + 0.1,
                  np.r_[1.0, np.zeros(units * r - 1)]):
        assert L._cost_edges(units, r, n, costs) == JL._cost_edges(units, r, n, costs)


def test_broadcast_ms_equals_the_jax_function():
    jp = _jax_plan("cubemap")
    plan = plan_from_jax(jp)
    for n, host, peer in ((1, 8.0, 40.0), (8, 25.0, 300.0), (2, 12.44, 50.0)):
        assert L.broadcast_ms(plan, 3840, 2160, n, host, peer) == pytest.approx(
            JL.broadcast_ms(jp, 3840, 2160, n, host, peer), rel=1e-12)
    with pytest.raises(ValueError, match="peer_gbps"):
        L.broadcast_ms(plan, 3840, 2160, 2, 25.0)
    deep = P.build_plan(TransformConfig(**MONO), 128, 64, 48, 32, "yuv420p10le")
    assert L.broadcast_ms(deep, 3840, 2160, 1, 25.0) == pytest.approx(
        2 * L.broadcast_ms(plan, 3840, 2160, 1, 25.0))  # two bytes per sample
