"""K4, the INTER_AREA + round kernel (``csrc/area.cu``), on the CPU.

The kernel itself runs only on a GPU (``tests/test_torch_cuda.py``).
Here:

* its host tile plan (``ops.area.build_area_tiles``) at 2x2, 4x4,
  1.5x2, 2x4, 200x90 -> 70x40, OpenCV's upscale branch 48x32 -> 96x48,
  an 8x resize whose tiles read device memory directly, a ragged 2x2
  whose output width is no multiple of 4, the flagship's 2x2 shapes, and
  row bands cut by ``parallel.latency._slice_area_rows``: every output
  pixel lies in exactly one tile, every span lies inside the input and
  in the stage's boxes and holds every tap of its tile, and a launch's
  ring stays within the plan's budget at uint8 and uint16; the packed
  mark holds exactly where every column's taps are K consecutive samples
  with one weight;
* the persistent work list (``ops.area.work_list``) covers each (tile,
  frame) item exactly once, each tile's frames in order, at batch 1, 7,
  16 and 128, in both walks; the walk and the copy follow the plane's
  row alignment;
* a numpy walk of that plan as the kernel walks it (each item's span
  staged in the box layout with every sample no tap may read poisoned,
  offsets relative to the span, 2 or 4 register taps per axis padded
  with zero weights, on packed tiles 4 adjacent outputs per thread from
  one aligned vector of 4K samples per tap row, taps and sums in the
  kernel's order, each float32 product and sum rounded on its own)
  equals the plain version ``area_plain`` byte for byte;
* ``area_px`` on CPU tensors is ``round_px(area_resize(...))`` at uint8
  and uint16, and against the JAX package's ``apply_area_resize`` and its
  round on the cases of tests/test_torch_area.py: exact at integer
  factors, at most 1 LSB on at most 0.2% otherwise (XLA's einsum sums in
  its own order);
* a supersampled ``transform_batch`` on the CPU launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transform360_tpu.sampling import apply_area_resize, area_matrix as jax_area_matrix
import transform360_tpu_torch as P
from transform360_tpu_torch.ops import area, blur, window
from transform360_tpu_torch.parallel.latency import _slice_area_rows
from transform360_tpu_torch.sampling import AreaTables, DeviceArea, area_resize, round_px
from transform360_tpu_torch.utils.profiling import COUNTERS

CASES = {  # (scaled w, h), (out w, h)
    "2x2": ((384, 256), (192, 128)),
    "4x4": ((384, 512), (96, 128)),
    "1.5x2": ((72, 64), (48, 32)),
    "200x90": ((200, 90), (70, 40)),
    "upscale": ((48, 32), (96, 48)),
    "8x direct": ((1024, 64), (128, 8)),
    "2x4": ((384, 512), (192, 128)),  # 4 row taps, 2 column taps: not packed
    "ragged 2x2": ((780, 520), (390, 260)),  # output width no multiple of 4: not packed
}
PACKED_CASES = {"2x2", "4x4", "flagship 2x2", "band 2x2"}  # every tile packed


def _band(name="200x90", y0=13, y1=29):
    """Output rows y0 to y1 of a case (not on a tile edge) as ``latency``
    slices them, and the scaled rows [s0, s1) they read."""
    at = _tables(name)
    row, s0, s1 = _slice_area_rows(at.row, y0, y1)
    return AreaTables(row=row, col=at.col), s0, s1


def _tables(name):
    (sw, sh), (ow, oh) = CASES[name]
    return AreaTables.build(sw, sh, ow, oh)


def _plans():
    return [(n, _tables(n)) for n in CASES] + [
        ("flagship 2x2", AreaTables.build(3072, 2048, 1536, 1024)),
        ("band", _band()[0]),
        ("band 2x2", _band("2x2", 13, 29)[0]),
    ]


def _taps(first, w, n_in, n):
    """Tap indices and weights of each output, padded to ``n`` taps with
    zero weights on the last real tap, as the kernel's registers hold
    them."""
    k = np.minimum(np.arange(n), w.shape[1] - 1)
    idx = np.minimum(first[:, None] + k, n_in - 1)
    return idx, np.where(np.arange(n) < w.shape[1], w[:, k], np.float32(0))


def _offset(box, row, col):
    """A sample's offset in a stage (as ``stage_offset`` in the kernel):
    ``count`` boxes of ``rows`` x ``width`` samples, box-major."""
    w, h, _ = box
    return (col // w * h + row) * w + col % w


def _stage(xf, box, y0, x0, span, W):
    """Each frame's stage for a tile: its span's rows and the columns
    inside the plane at their offsets; every other sample, which no tap
    may read, is NaN."""
    w, h, n = box
    st = np.full((xf.shape[0], n * h * w), np.nan, np.float32)
    rows, cols = np.arange(span), np.arange(min(n * w, W - x0))
    st[:, _offset(box, rows[:, None], cols[None, :])] = xf[:, y0:y0 + span, x0 + cols]
    return st


def _walk(da: DeviceArea, x: np.ndarray, maxval: int) -> np.ndarray:
    """The kernel's arithmetic over its tile plan, in numpy float32."""
    B, H, W = x.shape
    kr, kc = da.row_w.shape[1], da.col_w.shape[1]
    K = area.taps(kr, kc)
    rf, cf = da.row_first.numpy().astype(np.int64), da.col_first.numpy().astype(np.int64)
    rwt, cwt = da.row_w.numpy(), da.col_w.numpy()
    xf = x.astype(np.float32)
    out = np.full((B,) + da.out_shape, -1, np.int64)
    sb = x.dtype.itemsize
    for r0, c0, nr, nc, y0, x0, span, mode in da.tiles.numpy().astype(np.int64):
        rows, cols = slice(r0, r0 + nr), slice(c0, c0 + nc)
        if mode == area.DIRECT:  # device memory, the plan's own taps
            ri, rw = _taps(rf[rows], rwt[rows], H, kr)
            ci, cw = _taps(cf[cols], cwt[cols], W, kc)
            src, roff, coff = xf.reshape(B, -1), ri * W, ci
        else:  # the staged span, register taps, offsets in the stage
            ri, rw = _taps(rf[rows], rwt[rows], H, K)
            ci, cw = _taps(cf[cols], cwt[cols], W, K)
            src = _stage(xf, da.box, y0, x0, span, W)
            roff, coff = _offset(da.box, ri - y0, 0), _offset(da.box, 0, ci - x0)
        if mode == area.PACKED:  # lane l: outputs 4 l ... 4 l + 3, samples 4 K l ...
            assert kc == K and nc % 4 == 0 and (cw == cw[0, 0]).all()
            col = cf[c0] - x0 + 4 * K * np.arange(nc // 4)
            base = _offset(da.box, 0, col)
            assert (col % da.box[0] + 4 * K <= da.box[0]).all()  # in one box row
            assert ((roff[:, :, None] + base[None, None, :]) * sb % min(16, 4 * K * sb)
                    == 0).all()  # the vector load's alignment
            h = None
            for p in range(K):
                g = src[:, roff[:, p][:, None, None] + base[None, :, None] + np.arange(4 * K)]
                term = g * rw[:, p][:, None, None]  # [B, nr, lanes, 4 K]
                h = term if h is None else h + term
            h = h.reshape(B, nr, nc // 4, 4, K)
            s = h[..., 0] * cw[0, 0]
            for q in range(1, K):
                s = s + h[..., q] * cw[0, 0]
            s = s.reshape(B, nr, nc)
        else:
            s = None
            for q in range(coff.shape[1]):
                h = None
                for p in range(roff.shape[1]):
                    g = src[:, roff[:, p][:, None] + coff[:, q][None, :]]  # [B, nr, nc]
                    term = g * rw[:, p][:, None]
                    h = term if h is None else h + term
                term = h * cw[:, q][None, :]
                s = term if s is None else s + term
        assert out[:, r0:r0 + nr, c0:c0 + nc].min() == -1  # no pixel written twice
        out[:, r0:r0 + nr, c0:c0 + nc] = np.clip(np.floor(s + np.float32(0.5)), 0, maxval)
    return out


@pytest.mark.parametrize("name, at", _plans(), ids=[n for n, _ in _plans()])
def test_tile_plan_covers_each_output_once_inside_the_input(name, at):
    da = DeviceArea.from_tables(at, "cpu")
    tl = da.tiles.numpy().astype(np.int64)
    oh, ow = da.out_shape
    H, W = da.in_h, da.in_w
    assert (H, W) == (at.row.n_in, at.col.n_in)
    hits = np.zeros((oh, ow), np.int64)
    ri, ci = at.row.indices(), at.col.indices()
    bw, bh, nbox = da.box
    for r0, c0, nr, nc, y0, x0, span, mode in tl:
        assert 0 < nr <= area.TR and 0 < nc <= area.TC
        hits[r0:r0 + nr, c0:c0 + nc] += 1
        assert 0 <= y0 and y0 + span <= H and 0 <= x0 < W and x0 % area.ALIGN == 0
        rows, cols = ri[r0:r0 + nr], ci[c0:c0 + nc]
        assert rows.min() >= y0 and rows.max() < y0 + span
        assert cols.min() >= x0 and cols.max() < W
        assert mode in (area.DIRECT, area.STAGED, area.PACKED)
        if mode != area.DIRECT:  # the span fits the stage's boxes
            assert cols.max() < x0 + bw * nbox and span <= bh
    assert (hits == 1).all()
    staged = tl[:, 7] != area.DIRECT
    assert (np.diff(staged.astype(int)) >= 0).all()  # direct tiles first
    if staged.any():  # TMA boxes: at most 256 per dimension, rows of whole 16 bytes
        assert 0 < bw <= area.BOX_MAX and bw % area.ALIGN == 0 and 0 < bh <= area.BOX_MAX
        assert nbox == 1 or bw % 128 == 0  # each box 128-byte aligned in its stage
    for sb in (1, 2):
        smem = area.smem_bytes(da, sb)
        st = area.stage_bytes(da.box, sb)
        assert st % 128 == 0 and st >= bw * bh * nbox * sb
        assert 2 * area.stage_bytes(da.box, 2) <= area.SMEM_BUDGET
        assert 2 <= area.ring_stages(da, sb) <= area.RING
        assert area.ring_stages(da, sb) * st <= max(area.SMEM_BUDGET, 2 * st)
        assert smem % 16 == 0 and (smem == 0) == (not staged.any())
    assert staged.all() == (name != "8x direct")
    assert (tl[:, 7] == area.PACKED).all() == (name in PACKED_CASES)
    assert (tl[:, 7] == area.PACKED).any() == (name in PACKED_CASES)


@pytest.mark.parametrize("name, at", _plans(), ids=[n for n, _ in _plans()])
def test_packed_mark_only_where_column_taps_are_consecutive_and_equal(name, at):
    # each column of a packed tile: K = taps(kr, kc) consecutive samples
    # (no clamped padding), K after its left neighbour's, one weight
    da = DeviceArea.from_tables(at, "cpu")
    kr, kc = da.row_w.shape[1], da.col_w.shape[1]
    K = area.taps(kr, kc)
    idx, w = at.col.indices(), at.col.weights
    for r0, c0, nr, nc, y0, x0, span, mode in da.tiles.numpy().astype(np.int64):
        c = np.arange(c0, c0 + nc)
        want = (mode != area.DIRECT and kc == K and da.out_shape[1] % 4 == 0
                and idx[c0, 0] == x0
                and np.array_equal(idx[c], idx[c0, 0] + K * (c - c0)[:, None] + np.arange(K))
                and np.array_equal(idx[c], at.col.first[c, None] + np.arange(K))
                and (w[c] == w[c0, 0]).all())
        assert (mode == area.PACKED) == want, (name, c0)


@pytest.mark.parametrize("B", [1, 7, 16, 128])
@pytest.mark.parametrize("n_tiles, resident", [(1536, 132 * 4), (384, 132 * 4), (6, 528),
                                               (96, 132 * 3)])
def test_work_list_covers_each_item_once(n_tiles, resident, B):
    ctas = area.grid_ctas(n_tiles * B, resident)
    assert ctas == min(n_tiles * B, resident)
    for order in (0, 1):
        seen = np.zeros((n_tiles, B), np.int64)
        sizes = []
        for i, runs in enumerate(area.work_list(n_tiles, B, ctas, order)):
            items = [(tile, f) for tile, f0, n in runs for f in range(f0, f0 + n)]
            assert len({tile for tile, _, _ in runs}) == len(runs)  # one run per tile
            for tile, f in items:
                seen[tile, f] += 1
            sizes.append(len(items))
            if order == 0:
                assert runs and items == sorted(items)  # tile-major, frames in order
            else:  # every ctas-th tile from the CTA's own, all its frames
                assert [r[0] for r in runs] == list(range(i, n_tiles, ctas))
        assert (seen == 1).all()
        if order == 0:
            assert max(sizes) - min(sizes) <= 1  # balanced to one item


@pytest.mark.parametrize("sizes, dtype, order", [
    ((3072, 2048, 1536, 1024), torch.uint8, 0),  # the flagship's luma: whole 128-byte rows
    ((1536, 1024, 768, 512), torch.uint16, 0),  # its 10-bit chroma
    ((3000, 2000, 1500, 1000), torch.uint16, 1),  # 6000-byte rows
    ((3000, 2000, 1500, 1000), torch.uint8, 1),  # rows not even 16-byte aligned
])
def test_walk_order_follows_the_row_alignment(sizes, dtype, order):
    da = DeviceArea.from_tables(AreaTables.build(*sizes), "cpu")
    x = torch.zeros((1, sizes[1], sizes[0]), dtype=dtype)
    assert area.walk_order(da, x) == order
    assert area.copy_mode(da, x) == (area.COPY_TMA if sizes[0] * x.element_size() % 16 == 0
                                     else area.COPY_SCALAR)


@pytest.mark.parametrize("dtype, maxval", [(np.uint8, 255), (np.uint16, 1023), (np.uint16, 65535)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_walk_equals_area_plain(name, dtype, maxval):
    at = _tables(name)
    (sw, sh), _ = CASES[name]
    rng = np.random.default_rng(sw * sh)
    # 65535 at 10 bits: sums past the depth's maximum saturate
    hi = 256 if dtype == np.uint8 else 65536
    x = rng.integers(0, hi, (2, sh, sw)).astype(dtype)
    da = DeviceArea.from_tables(at, "cpu")
    want = area.area_plain(da, torch.from_numpy(x), maxval).numpy()
    assert want.dtype == dtype
    assert np.array_equal(_walk(da, x, maxval), want.astype(np.int64))


def test_band_tiles_are_built_from_the_sliced_axis():
    band, s0, s1 = _band()
    full = DeviceArea.from_tables(_tables("200x90"), "cpu")
    da = DeviceArea.from_tables(band, "cpu")
    assert (da.in_h, da.out_shape) == (s1 - s0, (16, 70))
    x = np.random.default_rng(3).integers(0, 256, (2, 90, 200)).astype(np.uint8)
    want = area.area_plain(full, torch.from_numpy(x)).numpy()[:, 13:29]
    got = area.area_px(da, torch.from_numpy(np.ascontiguousarray(x[:, s0:s1])))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_walk(da, x[:, s0:s1], 255), want.astype(np.int64))


@pytest.mark.parametrize("dtype, maxval", [(np.uint8, 255), (np.uint16, 1023)])
@pytest.mark.parametrize("y0, y1", [(0, 40), (13, 29), (100, 128)])
def test_packed_band_tiles_are_built_from_the_sliced_axis(y0, y1, dtype, maxval):
    # a latency band of the 2x2 case keeps every tile packed, and its walk
    # equals the whole plane's rows
    band, s0, s1 = _band("2x2", y0, y1)
    da = DeviceArea.from_tables(band, "cpu")
    assert (da.in_h, da.out_shape) == (s1 - s0, (y1 - y0, 192))
    assert (da.tiles[:, 7] == area.PACKED).all()
    x = np.random.default_rng(y0).integers(0, maxval + 1, (2, 256, 384)).astype(dtype)
    full = DeviceArea.from_tables(_tables("2x2"), "cpu")
    want = area.area_plain(full, torch.from_numpy(x), maxval).numpy()[:, y0:y1]
    assert np.array_equal(_walk(da, x[:, s0:s1], maxval), want.astype(np.int64))


@pytest.mark.parametrize("dtype, maxval", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_area_px_on_the_cpu_is_the_plain_version(dtype, maxval):
    at = _tables("1.5x2")
    da = DeviceArea.from_tables(at, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 1024 if maxval > 255 else 256,
                                                           (3, 64, 72)).astype(np.int32)).to(dtype)
    n = (COUNTERS["area.launches"], COUNTERS["area.launches_u16"])
    got = area.area_px(da, x, maxval)
    assert got.dtype == dtype and tuple(got.shape) == (3, 32, 48)
    assert torch.equal(got, round_px(area_resize(da, x), maxval, dtype))
    assert (COUNTERS["area.launches"], COUNTERS["area.launches_u16"]) == n


def _launches():
    """Each kernel's uint8 and uint16 launches so far."""
    return [(COUNTERS[f"{m}.launches"], COUNTERS[f"{m}.launches_u16"])
            for m in ("area", "blur", "window")]


def test_area_px_refuses_what_the_kernel_does_not_take():
    da = DeviceArea.from_tables(_tables("2x2"), "cpu")
    x = torch.zeros((1, 256, 384), dtype=torch.uint8)
    with pytest.raises(TypeError):
        area.area_px(da, x.int())
    with pytest.raises(ValueError):
        area.area_px(da, x[:, :128])
    with pytest.raises(ValueError):
        area.area_px(da, x, 1023)  # uint8 saturates at 255
    with pytest.raises(ValueError):
        area.area_px(da, torch.zeros((1, 384, 256), dtype=torch.uint8).transpose(1, 2))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("name", ["2x2", "4x4", "1.5x2", "200x90", "upscale"])
def test_area_px_vs_jax_apply_area_resize(name, dtype):
    (sw, sh), (ow, oh) = CASES[name]
    rng = np.random.default_rng(sw + oh)
    hi = 256 if dtype == np.uint8 else 65536
    x = rng.integers(0, hi, (3, sh, sw)).astype(dtype)
    da = DeviceArea.from_tables(_tables(name), "cpu")
    got = area.area_px(da, torch.from_numpy(x), hi - 1).numpy().astype(np.int64)
    v = np.asarray(apply_area_resize(jnp.asarray(x.astype(np.float32)),
                                     jnp.asarray(jax_area_matrix(sh, oh)),
                                     jnp.asarray(jax_area_matrix(sw, ow))))
    want = np.clip(np.floor(v + np.float32(0.5)), 0, hi - 1).astype(np.int64)
    d = np.abs(got - want)
    if name in ("2x2", "4x4"):
        assert d.max() == 0
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 0.002, (d.max(), (d > 0).mean())


def test_supersampled_cpu_batch_launches_nothing():
    opts = ("cube_edge_length=32:interpolation_alg=cubic:input_stereo_format=mono:"
            "width_scale_factor=2:height_scale_factor=2")
    eng = P.open_filter(opts, 256, 128, device="cpu")
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.integers(0, 256, (2, 128, 256), dtype=np.uint8))
    u, v = (torch.from_numpy(rng.integers(0, 256, (2, 64, 128), dtype=np.uint8))
            for _ in range(2))
    counts = _launches()
    oy, ou, ov = P.transform_batch(eng.plan, y, u, v)
    assert _launches() == counts
    pp = eng.plan.luma
    t = pp.tables("cpu")
    k3 = window.remap_window_px(pp.window_tables("cpu"), blur.blur_px(t.blur, y))
    assert torch.equal(oy, area.area_plain(t.area, k3))
