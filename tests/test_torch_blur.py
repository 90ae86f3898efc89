"""The prefilter: the port's plain version against the JAX package.

* ``blur_plain`` + round against ``apply_blur`` + ``_round_u8`` run op by
  op (eager XLA-CPU) on the same JAX plan: exact.
* ``blur_plain`` against the Pallas kernel ``blur_lane`` in interpret
  mode: at most 1 LSB on under 0.5% of pixels (the bound of
  tests/test_blur_lane.py: that kernel sums vertical-first with a
  bf16x3-split x matmul).
* The tile plan and work list the CUDA kernel K1 reads, walked in numpy
  the way the kernel walks them (each CTA's (tile, frame, part) items;
  each part's rows staged as TMA or the producer warp stages them, edges
  clamped; each thread's window at its offset; the x pass with mirrored
  taps; the y pass through the rotating partial sums; the round): exact
  against ``blur_plain`` on every raster, at uint8 and uint16, for
  several walks, and the items cover every pixel and frame once.  No
  tile crosses a band, a segment or an eye; the ring kernel takes
  Gaussian taps only.  (The kernel itself runs only on a GPU:
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
from transform360_tpu_torch.ops import _build, blur
from transform360_tpu_torch.ops.blur import BlurTables, blur_px, part_rows, work_list
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.sampling import round_px, round_u8

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
    # the flagship in small: rx 6 at the poles, ry 1; one column of tiles
    # spans the width, so tiles touch all four plane edges
    "edges-rx6": (TransformConfig(**MONO), 320, 180, 126, 84),
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


def _emulate(bt: BlurTables, x: torch.Tensor, parts: int, ctas: int,
             copy: int = blur.COPY_TMA, maxval: int = 255, cols: int = 0) -> torch.Tensor:
    """K1 in numpy, as the kernel walks it, reading only the tables: each
    CTA's items (work_list), each part's source rows staged from x0 as
    the producer stages them (rows clamped; by TMA, columns outside the
    plane zero, then the edge samples copied over the columns the tile
    reads; by the producer's loads, every column clamped), each thread's
    window of 8 + 2 rx samples at its offset, the x pass with the
    mirrored taps, the y pass through the rotating partial sums (slot:
    the source row mod 2 RY, as the slabs start at multiples of it), the
    round and the store of the tile's columns; ``cols`` columns per thread
    (0: 8).  The direct kernel: every pixel's taps in
    the plane, in order.  Zero tiles write 0; a pixel
    written twice fails; one never written keeps the sentinel 77."""
    xs = x.numpy()
    B, H, W = xs.shape
    sb = bt.sample_bytes
    tiles = bt.tiles.numpy().astype(np.int64)
    kx, ky = bt.kx.numpy(), bt.ky.numpy()
    LX, LY = kx.shape[1], ky.shape[1]
    out = np.full(xs.shape, 77, xs.dtype)
    hits = np.zeros(xs.shape, np.int64)
    half, f32 = np.float32(0.5), np.float32
    V = cols or 8
    G = blur.tile_width(sb) // V  # thread groups of a tile
    if bt.ring_ry > 0:
        assert bt.slab % (2 * bt.ring_ry) == 0
    for items in work_list(tiles.shape[0], B, parts, ctas):
        for t, f, part in items:
            r0, c0, nr, nc, s, x0 = tiles[t]
            p0, p1 = part_rows(r0, nr, part, parts)
            if p1 == p0:
                continue
            hits[f, p0:p1, c0 : c0 + nc] += 1
            if s < 0:
                out[f, p0:p1, c0 : c0 + nc] = 0
                continue
            rx = int(bt.rx[s])
            plane = xs[f].astype(np.float32)
            if bt.ring_ry < 0:  # the direct kernel
                ry = int(bt.ry[s])
                k, q = kx[s, (LX - 1) // 2 - rx :], ky[s, (LY - 1) // 2 - ry :]
                rows = plane[np.clip(np.arange(p0 - ry, p1 + ry), 0, H - 1)]
                cols = np.arange(c0, c0 + nc)
                h = None
                for u in range(2 * rx + 1):
                    term = k[u] * rows[:, np.clip(cols + u - rx, 0, W - 1)]
                    h = term if h is None else h + term
                acc = None
                for j in range(2 * ry + 1):
                    term = q[j] * h[j : j + p1 - p0]
                    acc = term if acc is None else acc + term
                out[f, p0:p1, c0 : c0 + nc] = np.minimum(np.floor(acc + half), maxval)
                continue
            RY = bt.ring_ry
            k = kx[s, (LX - 1) // 2 - rx :][: rx + 1]
            q = ky[s, : RY + 1]
            n = p1 - p0 + 2 * RY
            row_n = bt.row_bytes // sb
            cols = x0 + np.arange(row_n)
            staged = plane[np.clip(np.arange(p0 - RY, p1 + RY), 0, H - 1)][
                :, np.clip(cols, 0, W - 1)]
            if copy == blur.COPY_TMA:
                staged[:, cols >= max(W, c0 + nc + rx)] = 0
            g0 = c0 // V * V
            b = g0 - rx - x0 + V * np.arange(G)
            per = 4 // sb  # samples per word: every thread's last word is staged
            nq = (V + 2 * rx + per - 1) // per + 1
            assert b.min() >= 0 and (b // per + nq).max() * per <= row_n
            e = 16 // sb  # samples in 16 bytes
            if V % e == 0:  # the kernel's aligned loads: a window's offset in its chunk
                off = (e - rx % e) % e  # is a constant of rx, and its chunks are staged
                assert (b % e == off).all()
                assert ((b - off) // e + (off + V + 2 * rx + e - 1) // e).max() * e <= row_n
            g = np.flatnonzero(g0 + V * np.arange(G) < c0 + nc)  # groups in the tile
            win = staged[:, b[g, None] + np.arange(V + 2 * rx)]  # [n, groups, V + 2 rx]
            h = k[0] * win[..., :V]
            for u in range(1, 2 * rx + 1):
                h = h + k[min(u, 2 * rx - u)] * win[..., u : u + V]
            acc = np.zeros((2 * RY, g.size, V), np.float32)
            col = (g0 + V * g)[:, None] + np.arange(V)
            inside = (col >= c0) & (col < c0 + nc)
            for i in range(n):
                j = i % (2 * RY)
                done = acc[j] + q[0] * h[i]
                for tt in range(1, 2 * RY):
                    acc[(j - tt) % (2 * RY)] += q[min(tt, 2 * RY - tt)] * h[i]
                acc[j] = q[0] * h[i]
                o = p0 + i - 2 * RY
                if o >= p0:
                    v = np.minimum(np.floor(done + half), f32(maxval))
                    out[f, o, col[inside]] = v[inside]
    assert (hits == 1).all(), "items do not cover every pixel and frame once"
    return torch.from_numpy(out)


# walks of the work list: (parts, ctas), or None for a launch's own choice
# on an H100's 132 SMs of 4 CTAs at the test's batch
WALKS = {"one-cta": (1, 1), "parts-3-ctas-7": (3, 7), "launch": None}


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_work_list_walk_matches_blur_plain(name, walk, rng):
    _, tb, h, w = _blur_plan(name)
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    x = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    B = x.shape[0]
    if WALKS[walk] is None:
        parts = blur.launch_parts(bt, B, 4 * 132)
        ctas = blur.grid_ctas(bt.tiles.shape[0] * B * parts, 4 * 132)
    else:
        parts, ctas = WALKS[walk]
    want = round_u8(blur_plain(tb, x.float()))
    copies = (blur.COPY_TMA, blur.COPY_WARP) if walk == "one-cta" else (blur.COPY_TMA,)
    for copy in copies:
        assert torch.equal(_emulate(bt, x, parts, ctas, copy), want), copy
    if walk == "one-cta" and bt.ring_ry == 1:  # 16 columns per thread on the same tables
        assert torch.equal(_emulate(bt, x, parts, ctas, cols=16), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_tables_reproduce_blur_plain(name, rng):
    _, tb, h, w = _blur_plan(name)
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    x = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    want = round_u8(blur_plain(tb, x.float()))
    assert torch.equal(_emulate(bt, x, 2, 5), want)


@pytest.mark.parametrize("name", ["edges-rx6", "mono", "tb-odd"])
def test_uint16_walk_matches_blur_plain(name, rng):
    # the uint16 tables (768-column tiles, 4-sample TMA elements, 2-sample
    # words) at 16 bits, samples at 65535 included
    cfg, iw, ih, ow, oh = CASES[name]
    pp = plan_from_jax(J.build_plan(cfg, iw, ih, ow, oh, "gray16le")).luma
    bt = BlurTables.from_plan(pp.blur, ih, iw, "cpu", 2)
    x = rng.integers(0, 65536, (2, ih, iw), dtype=np.uint16)
    x[1, : ih // 3] = 65535
    x = torch.from_numpy(x)
    want = round_px(blur_plain(pp.blur, x.float()), 65535, torch.uint16)
    assert torch.equal(_emulate(bt, x, 3, 4, maxval=65535), want)


def test_edge_case_tiles_touch_every_plane_edge_with_rx6():
    _, tb, h, w = _blur_plan("edges-rx6")
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    t = bt.tiles.numpy()
    rx = bt.rx.numpy()[t[:, 4]]
    assert bt.ring_ry == 1  # the ring kernel
    top, bottom = t[:, 0] == 0, t[:, 0] + t[:, 2] == h
    left, right = t[:, 1] == 0, t[:, 1] + t[:, 3] == w
    assert (rx[top] == 6).all() and (rx[bottom] == 6).all()
    assert (left & top).any() and (right & bottom).any() and (t[:, 5] < 0).any()


@pytest.mark.parametrize("n_tiles, B, parts, ctas", [
    (60, 128, 2, 528), (20, 256, 2, 528), (60, 1, 9, 528), (7, 3, 5, 4), (5, 1, 1, 5)])
def test_work_list_covers_items_once(n_tiles, B, parts, ctas):
    items = work_list(n_tiles, B, parts, ctas)
    assert len(items) == ctas
    flat = [it for cta in items for it in cta]
    assert sorted(flat) == [(t, f, p) for t in range(n_tiles) for f in range(B)
                            for p in range(parts)]
    sizes = [len(c) for c in items]
    assert max(sizes) - min(sizes) <= 1  # every CTA's share within one item
    for cta in items:  # each tile's frames in order, and its parts
        assert cta == sorted(cta)


def test_ring_kernel_takes_gaussian_taps_only():
    _, tb, h, w = _blur_plan("mono")
    assert BlurTables.from_plan(tb, h, w, "cpu").ring_ry == 1
    b = tb.bands[0]
    kx = b.kx.copy()
    kx[:, 0] = np.nextafter(kx[:, 0], np.float32(1))  # one tap off by an ulp
    odd = dataclasses.replace(tb, bands=(dataclasses.replace(b, kx=kx),) + tuple(tb.bands[1:]))
    bt = BlurTables.from_plan(odd, h, w, "cpu")
    assert bt.ring_ry == -1 and bt.row_bytes == 0  # the direct kernel
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, h, w), dtype=np.uint8))
    assert torch.equal(_emulate(bt, x, 1, 3), round_u8(blur_plain(odd, x.float())))
    neg = dataclasses.replace(b, ky=-b.ky)
    assert not blur.gaussian_taps(np.zeros((1, 3), np.float32), -np.ones((1, 3), np.float32))
    assert BlurTables.from_plan(dataclasses.replace(tb, bands=(neg,) + tuple(tb.bands[1:])),
                                h, w, "cpu").ring_ry == -1


@pytest.mark.parametrize("rows, n_tiles, B, ctas, want", [
    (144, 60, 1, 528, 8),  # one luma frame: 480 parts, one per CTA (not 9: 540)
    (144, 60, 16, 528, 5),  # ITEMS_PER_CTA: 4800 parts, 9 or 10 a CTA
    (144, 60, 128, 528, 1),  # whole tiles: 14 or 15 a CTA
    (108, 20, 2, 528, 6),  # a chroma pair: parts of 18 rows, 240 on 528 CTAs
    (16, 600, 1, 528, 1),  # more tile-frames than CTAs, parts no shorter than 16 rows
])
def test_launch_parts(rows, n_tiles, B, ctas, want):
    bt = BlurTables.from_plan(_blur_plan("mono")[1], 80, 256, "cpu")
    bt = dataclasses.replace(bt, tiles=bt.tiles[:1].repeat(n_tiles, 1), min_rows=rows)
    assert blur.launch_parts(bt, B, ctas) == want


def test_thread_cols_by_batch():
    # uint8 at y radius 1: 16 columns per thread once the batch gives every
    # resident CTA WIDE_TILES_PER_CTA tile-frames, else 8; uint16 always 8
    _, tb, h, w = _blur_plan("edges-rx6")
    b8 = BlurTables.from_plan(tb, h, w, "cpu")
    b16 = BlurTables.from_plan(tb, h, w, "cpu", 2)
    n = b8.tiles.shape[0]
    need = -(-blur.WIDE_TILES_PER_CTA * 528 // n)
    assert blur.thread_cols(b8, need, 528) == 16 and blur.thread_cols(b8, need - 1, 528) == 8
    assert blur.thread_cols(b16, 10 * need, 528) == 8


def test_launch_memoizes_its_choices(monkeypatch):
    # a launch picks its copy, columns, parts and grid once per batch size
    # and base alignment of its tables, as a launch with a choice given
    # (which memoizes nothing) picks the others; later calls of that batch
    # only launch
    _, tb, h, w = _blur_plan("edges-rx6")
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    lookups, calls = [], []
    monkeypatch.setattr(blur, "resident_ctas",
                        lambda lib, bt, stages=blur.STAGES, cols=8: lookups.append(cols) or 528)
    monkeypatch.setattr(blur.KERNEL, "launch", lambda lib, c, src, out, stream: calls.append(
        (c.copy, c.stages, c.cols, c.parts, c.ctas)))
    buf = torch.zeros(16 * h * w + 16, dtype=torch.uint8)
    aligned = buf[: 16 * h * w].view(16, h, w)
    unaligned = buf[1 : 16 * h * w + 1].view(16, h, w)
    for B in (1, 16):
        blur.launch(None, bt, aligned[:B], aligned[:B], 0, copy=blur.copy_mode(bt, aligned))
        assert (None, (B,), (True,)) not in bt.memo
        want, calls[:] = calls[:], []
        assert want[0][:2] == (blur.copy_mode(bt, aligned), blur.STAGES)
        assert want[0][2:] == blur.geometry(None, bt, B)
        blur.launch(None, bt, aligned[:B], aligned[:B], 0)
        n = len(lookups)
        for _ in range(3):
            blur.launch(None, bt, aligned[:B], aligned[:B], 0)
        assert len(lookups) == n and calls == 4 * want
        calls[:] = []
    blur.launch(None, bt, unaligned, unaligned, 0)  # a new key: the producer's loads
    assert calls[-1][0] == blur.COPY_WARP and calls[-1][2:] == blur.geometry(None, bt, 16)
    # two sources: the key holds each one's frames and alignment, and an
    # unaligned one takes the producer's loads for the whole launch
    blur.launch(None, bt, (aligned[:3], unaligned[:5]), aligned[:8], 0)
    assert calls[-1][0] == blur.COPY_WARP and calls[-1][2:] == blur.geometry(None, bt, 8)
    assert sorted(bt.memo) == [(None, (1,), (True,)), (None, (3, 5), (True, False)),
                               (None, (16,), (False,)), (None, (16,), (True,))]


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_source_fixes_one_x_radius():
    # a probe build's source: K1 with its x-radius switch fixed and the
    # scalar stores of partial groups out of the row loop; a source with
    # neither hook is refused
    cs = _chip_smoke()
    src = (_build.CSRC / "blur.cu").read_text()
    probe = cs.k1_probe_source(src, 6)
    assert probe.count("switch (6) {") == 1 and "switch (rx) {" not in probe
    assert probe.count("if (true) {") == 1 and "if (cl.whole) {" not in probe
    old = "switch (t.rx) {\n if (vec_store) {\n"  # an earlier K1's hooks
    assert cs.k1_probe_source(old, 2) == "switch (2) {\n if (true) {\n"
    with pytest.raises(SystemExit):
        cs.k1_probe_source(src.replace("switch (rx) {", "switch (r) {"), 1)


def test_blur_work_counts_one_product_per_distinct_tap():
    # Gaussian taps: rx+1 x products and ry+1 y products per output pixel
    # beside 2 rx and 2 ry sums; other taps 2 rx+1 and 2 ry+1
    cs = _chip_smoke()
    _, tb, h, w = _blur_plan("edges-rx6")
    bt = BlurTables.from_plan(tb, h, w, "cpu")
    t = bt.tiles.numpy().astype(np.int64)
    t = t[t[:, 4] >= 0]
    rx, ry = bt.rx.numpy()[t[:, 4]], bt.ry.numpy()[t[:, 4]]
    px = t[:, 2] * t[:, 3]
    nbytes, ops = cs.blur_work(bt, 3)
    assert nbytes >= 2 * 3 * h * w
    assert ops == 3 * float(np.sum((3 * rx + 1 + 3 * ry + 1) * px))
    b = tb.bands[0]
    kx = b.kx.copy()
    kx[:, 0] = np.nextafter(kx[:, 0], np.float32(1))  # one tap off by an ulp
    odd = dataclasses.replace(tb, bands=(dataclasses.replace(b, kx=kx),) + tuple(tb.bands[1:]))
    bo = BlurTables.from_plan(odd, h, w, "cpu")
    assert bo.tiles.shape == bt.tiles.shape
    assert cs.blur_work(bo, 3)[1] == 3 * float(np.sum((4 * rx + 1 + 4 * ry + 1) * px))


@pytest.mark.parametrize("sample_bytes", [1, 2])
def test_staged_rows_fit_one_tma_box_and_the_ring_fits_its_budget(sample_bytes):
    for rx in range(9):
        row, pitch = blur.staged_row(rx, sample_bytes)
        assert row % 16 == 0 and pitch % blur.PITCH_ALIGN == 0 and row <= pitch
        assert row <= blur.ROW_MAX
        for ry in blur.RING_RY:
            slab = blur.slab_rows(pitch, ry)
            assert slab >= 2 * ry and slab % (2 * ry) == 0
            assert blur.STAGES * slab * pitch <= blur.SMEM_CTA


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
    tw = blur.tile_width(1)
    for r0, c0, nr, nc, s, x0 in tiles:
        assert 0 < nr <= blur.TH and 0 < nc
        # the threads of a tile cover it from its first column aligned down
        assert c0 % blur.GROUP + nc <= tw
        rs, cs = slice(r0, r0 + nr), slice(c0, c0 + nc)
        hits[rs, cs] += 1
        if s < 0:  # the leftover row or column of odd stereo dims, and only it
            assert ((band[rs, None] < 0) | (seg[None, cs] < 0)).all()
            continue
        # one band, one eye, one segment: one set of taps
        assert (band[rs] == s // nseg).all()
        assert (seg[cs] == s % nseg).all() and len(set(eye[cs])) == 1
        if bt.ring_ry > 0:  # the staged rows start 16-byte aligned before the first tap
            assert x0 % 16 == 0 and 0 <= c0 // blur.GROUP * blur.GROUP - int(bt.rx[s]) - x0 < 16
    assert (hits == 1).all()
    if bt.ring_ry > 0:
        assert (bt.row_bytes, bt.pitch) == blur.staged_row(int(bt.rx.max()), 1)
        assert bt.slab == blur.slab_rows(bt.pitch, bt.ring_ry)
        assert bt.min_rows == tiles[tiles[:, 4] >= 0, 2].min()
    # the zeroed pixels of blur_plain are exactly the zero tiles'
    zero = np.zeros((h, w), bool)
    for r0, c0, nr, nc, s, _ in tiles[tiles[:, 4] < 0]:
        zero[r0 : r0 + nr, c0 : c0 + nc] = True
    assert (zero == ((band[:, None] < 0) | (seg[None, :] < 0))).all()
