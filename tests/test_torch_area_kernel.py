"""K4, the INTER_AREA + round kernel (``csrc/area.cu``), on the CPU.

The kernel itself runs only on a GPU (``tests/test_torch_cuda.py``).
Here:

* its host tile plan (``ops.area.build_area_tiles``) at 2x2, 4x4,
  1.5x2, 200x90 -> 70x40, OpenCV's upscale branch 48x32 -> 96x48, an 8x
  resize whose tiles read device memory directly, the flagship's 2x2
  shapes, and a row band cut by ``parallel.latency._slice_area_rows``:
  every output pixel lies in exactly one tile, every span lies inside the
  input and holds every tap of its tile, and a launch's shared memory
  stays within the plan's budget at uint8 and uint16;
* a numpy walk of that plan as the kernel walks it (staged spans with
  the columns past the plane's width poisoned, offsets relative to the
  span, 2 or 4 register taps per axis padded with zero weights, taps and
  sums in the kernel's order, each float32 product and sum rounded on its
  own) equals the plain version ``area_plain`` byte for byte;
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

CASES = {  # (scaled w, h), (out w, h)
    "2x2": ((384, 256), (192, 128)),
    "4x4": ((384, 512), (96, 128)),
    "1.5x2": ((72, 64), (48, 32)),
    "200x90": ((200, 90), (70, 40)),
    "upscale": ((48, 32), (96, 48)),
    "8x direct": ((1024, 64), (128, 8)),
}


def _tables(name):
    (sw, sh), (ow, oh) = CASES[name]
    return AreaTables.build(sw, sh, ow, oh)


def _band():
    """Output rows 13-28 of 200x90 -> 70x40 (not on a tile edge) as
    ``latency`` slices them, and the scaled rows [s0, s1) they read."""
    at = _tables("200x90")
    row, s0, s1 = _slice_area_rows(at.row, 13, 29)
    return AreaTables(row=row, col=at.col), s0, s1


def _plans():
    return [(n, _tables(n)) for n in CASES] + [
        ("flagship 2x2", AreaTables.build(3072, 2048, 1536, 1024)),
        ("band", _band()[0]),
    ]


def _taps(first, w, n_in, n):
    """Tap indices and weights of each output, padded to ``n`` taps with
    zero weights on the last real tap, as the kernel's registers hold
    them."""
    k = np.minimum(np.arange(n), w.shape[1] - 1)
    idx = np.minimum(first[:, None] + k, n_in - 1)
    return idx, np.where(np.arange(n) < w.shape[1], w[:, k], np.float32(0))


def _walk(da: DeviceArea, x: np.ndarray, maxval: int) -> np.ndarray:
    """The kernel's arithmetic over its tile plan, in numpy float32."""
    B, H, W = x.shape
    kr, kc = da.row_w.shape[1], da.col_w.shape[1]
    rf, cf = da.row_first.numpy().astype(np.int64), da.col_first.numpy().astype(np.int64)
    xf = x.astype(np.float32)
    out = np.full((B,) + da.out_shape, -1, np.int64)
    for r0, c0, nr, nc, y0, x0, span, pitch in da.tiles.numpy().astype(np.int64):
        rows, cols = slice(r0, r0 + nr), slice(c0, c0 + nc)
        if pitch:  # staged: the span (columns past the plane poisoned), register taps
            K = area.taps(kr, kc)
            ri, rw = _taps(rf[rows], da.row_w.numpy()[rows], H, K)
            ci, cw = _taps(cf[cols], da.col_w.numpy()[cols], W, K)
            src = np.full((B, span, pitch), np.nan, np.float32)
            n = min(pitch, W - x0)
            src[:, :, :n] = xf[:, y0:y0 + span, x0:x0 + n]
            ri, ci = ri - y0, ci - x0
        else:
            ri, rw = _taps(rf[rows], da.row_w.numpy()[rows], H, kr)
            ci, cw = _taps(cf[cols], da.col_w.numpy()[cols], W, kc)
            src = xf
        s = None
        for q in range(ci.shape[1]):
            h = None
            for p in range(ri.shape[1]):
                g = src[:, ri[:, p][:, None], ci[:, q][None, :]]  # [B, nr, nc]
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
    for r0, c0, nr, nc, y0, x0, span, pitch in tl:
        assert 0 < nr <= area.TR and 0 < nc <= area.TC
        hits[r0:r0 + nr, c0:c0 + nc] += 1
        assert 0 <= y0 and y0 + span <= H and 0 <= x0 < W and x0 % area.ALIGN == 0
        assert pitch % area.ALIGN == 0
        rows, cols = ri[r0:r0 + nr], ci[c0:c0 + nc]
        assert rows.min() >= y0 and rows.max() < y0 + span
        assert cols.min() >= x0 and cols.max() < W
        if pitch:
            assert cols.max() < x0 + pitch and span * pitch <= da.stage
    assert (hits == 1).all()
    staged = tl[:, 7] > 0
    assert (np.diff(staged.astype(int)) >= 0).all()  # direct tiles first
    for sb in (1, 2):
        smem = area.smem_bytes(da, sb)
        assert smem <= area.SMEM_BUDGET and smem % 16 == 0
        assert (smem == 0) == (not staged.any())
    assert staged.all() == (name != "8x direct")


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


@pytest.mark.parametrize("dtype, maxval", [(torch.uint8, 255), (torch.uint16, 1023)])
def test_area_px_on_the_cpu_is_the_plain_version(dtype, maxval):
    at = _tables("1.5x2")
    da = DeviceArea.from_tables(at, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 1024 if maxval > 255 else 256,
                                                           (3, 64, 72)).astype(np.int32)).to(dtype)
    n = (area.LAUNCHES, area.LAUNCHES_U16)
    got = area.area_px(da, x, maxval)
    assert got.dtype == dtype and tuple(got.shape) == (3, 32, 48)
    assert torch.equal(got, round_px(area_resize(da, x), maxval, dtype))
    assert (area.LAUNCHES, area.LAUNCHES_U16) == n


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
    counts = [(m.LAUNCHES, m.LAUNCHES_U16) for m in (area, blur, window)]
    oy, ou, ov = P.transform_batch(eng.plan, y, u, v)
    assert [(m.LAUNCHES, m.LAUNCHES_U16) for m in (area, blur, window)] == counts
    pp = eng.plan.luma
    t = pp.tables("cpu")
    k3 = window.remap_window_px(pp.window_tables("cpu"), blur.blur_px(t.blur, y))
    assert torch.equal(oy, area.area_plain(t.area, k3))
