"""Plane batches as sources (``transform360_tpu_torch.ops.sources``): K1
and K3 read U and V where they lie, from their own bases, and no plane is
stacked by a copy on the card.

On the CPU only the plain versions run (the wrappers stack the sources
there), so these tests hold the descriptor a launch takes (frame counts,
frame strides, 16-byte alignment, the copy it picks), the frame → source
mapping the kernels use (and K3's frame groups, cut where the second
source starts, emulated as ``csrc/window.cu`` computes them), and the whole
slice against the JAX package's ``transform_frame_planes`` with U and V
as separate tensors and as strided views of one packed yuv420p buffer:
at most 1 LSB on at most 0.2% of a plane (the port's other parity tests'
bound: XLA-CPU's FMA rounding ties, ROADMAP C), and the port's own output
byte-identical to what it gives for the same planes stacked.
"""

import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu import pipeline as jpipeline
from transform360_tpu.fidelity import _video_like_planes
from transform360_tpu_torch import pipeline
from transform360_tpu_torch.ops import blur, sources, window
from transform360_tpu_torch.plan import plan_from_jax
from transform360_tpu_torch.utils.profiling import COUNTERS

W, H, B = 256, 128, 3
CW, CH = W // 2, H // 2
FMA_TIE_FRAC = 0.002
OPTS = {
    "prefilter": "w=96:h=64:interpolation_alg=cubic:enable_low_pass_filter=1:"
                 "input_stereo_format=mono",
    "no prefilter": "w=96:h=64:interpolation_alg=cubic:enable_low_pass_filter=0:"
                    "input_stereo_format=mono",
}


def _frames(b=B):
    y, u, v = _video_like_planes(W, H)
    return tuple(np.stack([np.roll(p, 7 * k, axis=1) for k in range(b)]) for p in (y, u, v))


def _packed_buffer(y, u, v, pad=0):
    """The planes as strided views of one packed yuv420p buffer (each
    frame Y, U, V, then ``pad`` bytes), as a raw reader or a decoder hands
    them over."""
    b = y.shape[0]
    ny, nc = H * W, CH * CW
    buf = torch.zeros((b, ny + 2 * nc + pad), dtype=torch.uint8)
    buf[:, :ny] = torch.from_numpy(y.reshape(b, -1))
    buf[:, ny:ny + nc] = torch.from_numpy(u.reshape(b, -1))
    buf[:, ny + nc:ny + 2 * nc] = torch.from_numpy(v.reshape(b, -1))
    return (buf[:, :ny].unflatten(1, (H, W)), buf[:, ny:ny + nc].unflatten(1, (CH, CW)),
            buf[:, ny + nc:ny + 2 * nc].unflatten(1, (CH, CW)))


def test_descriptor_of_separate_planes_strided_views_and_an_unaligned_source():
    y, u, v = (torch.from_numpy(p) for p in _frames())
    # U and V as separate tensors: each its own base, frames a plane apart
    src = sources.describe((u, v))
    assert [s.frames for s in src] == [B, B]
    assert [s.stride for s in src] == [CH * CW, CH * CW]
    assert [s.ptr for s in src] == [u.data_ptr(), v.data_ptr()]
    assert all(s.aligned for s in src)  # CPU allocations are 64-byte aligned
    # strided views of a packed frame buffer: packed rows, frames 1.5 luma planes apart
    py, pu, pv = _packed_buffer(*(t.numpy() for t in (y, u, v)))
    assert not pu.is_contiguous() and all(sources.rows_packed(p) for p in (py, pu, pv))
    src = sources.describe((pu, pv))
    assert [s.stride for s in src] == [3 * H * W // 2] * 2
    assert [s.ptr - py.data_ptr() for s in src] == [H * W, H * W + CH * CW]
    assert all(s.aligned for s in src)
    # 8 bytes of padding a frame: bases aligned, frame strides not
    _, qu, qv = _packed_buffer(*(t.numpy() for t in (y, u, v)), pad=8)
    assert [s.aligned for s in sources.describe((qu, qv))] == [False, False]
    # one frame has no next frame: its stride is its plane's, 16-byte rounded
    one = sources.describe((qu[:1],))[0]
    assert one.stride == CH * CW and one.aligned
    # a base one sample off
    flat = torch.zeros(B * CH * CW + 1, dtype=torch.uint8)
    off = flat[1:].view(B, CH, CW)
    assert [s.aligned for s in sources.describe((u, off))] == [True, False]
    # rows that are not packed, or frames that overlap, are not sources
    assert not sources.rows_packed(u.transpose(1, 2))
    assert not sources.rows_packed(u[:, :, ::2])
    assert not sources.rows_packed(u[:1].expand(B, CH, CW))
    assert sources.rows_packed(u[:1].expand(1, CH, CW))


def test_descriptions_are_memoized_and_every_check_still_holds():
    x = torch.zeros((B, CH, CW), dtype=torch.uint8)
    (d,) = sources.describe((x,))
    xs, (c,) = sources.check_sources(x, CH, CW, torch.uint8, x.device, "blur")
    assert xs == (x,) and c is d and sources.describe((x,))[0] is d
    # a memoized source is still checked against what each caller expects
    with pytest.raises(ValueError, match="expects"):
        sources.check_sources(x, CH, CW + 1, torch.uint8, x.device, "blur")
    with pytest.raises(TypeError, match="take torch.uint16"):
        sources.check_sources(x, CH, CW, torch.uint16, x.device, "blur")
    with pytest.raises(ValueError, match="but the blur tables on meta"):
        sources.check_sources(x, CH, CW, torch.uint8, torch.device("meta"), "blur")
    # a view at the same pointer whose rows are not packed is its own key,
    # and refused
    odd = x.as_strided((B, CH, CW // 2), (CH * CW, CW, 2))
    assert sources.describe((odd,))[0] == sources.Source(x.data_ptr(), B, CH * CW, True)
    with pytest.raises(ValueError, match="packed rows"):
        sources.check_sources(odd, CH, CW // 2, torch.uint8, x.device, "blur")


def test_copy_mode_takes_tma_only_when_every_source_qualifies():
    eng = J.open_filter(OPTS["prefilter"], W, H)
    tp = plan_from_jax(eng.plan)
    bt = tp.chroma.tables("cpu").blur
    y, u, v = (torch.from_numpy(p) for p in _frames())
    _, pu, pv = _packed_buffer(y.numpy(), u.numpy(), v.numpy())
    _, qu, qv = _packed_buffer(y.numpy(), u.numpy(), v.numpy(), pad=8)
    rows_ok = CW % 16 == 0 and CW >= bt.row_bytes
    tma = blur.COPY_TMA if rows_ok else blur.COPY_WARP
    assert blur.copy_mode(bt, (u, v)) == tma
    assert blur.copy_mode(bt, (pu, pv)) == tma
    assert blur.copy_mode(bt, (u, qv)) == blur.COPY_WARP  # one source off: the whole launch
    assert blur.copy_mode(bt, (qu, qv)) == blur.COPY_WARP


@pytest.mark.parametrize("b0, b1", [(1, 1), (1, 4), (2, 2), (2, 5), (3, 4), (5, 5), (4, 1)])
def test_frame_to_source_mapping(b0, b1):
    counts = (b0, b1)
    want = [(0, f) for f in range(b0)] + [(1, f) for f in range(b1)]
    assert [sources.locate(counts, f) for f in range(b0 + b1)] == want
    assert [sources.locate((b0 + b1,), f) for f in range(b0 + b1)] == [
        (0, f) for f in range(b0 + b1)]
    with pytest.raises(IndexError):
        sources.locate(counts, b0 + b1)


def _k3_groups(B, b0, frames):
    """Each CTA row's frames as csrc/window.cu picks them (the groups cut
    where source 1 starts): (source, first frame in it, frames, first
    output frame)."""
    g0 = -(-b0 // frames)
    rows = []
    for y in range(g0 + -(-(B - b0) // frames)):
        second = y >= g0
        fz = (y - g0 if second else y) * frames
        nf = min(frames, (B - b0 if second else b0) - fz)
        rows.append((int(second), fz, nf, b0 + fz if second else fz))
    return rows


@pytest.mark.parametrize("b0, b1", [(1, 1), (1, 2), (2, 2), (3, 4), (5, 3), (128, 128), (127, 129),
                                    (7, 0)])
def test_k3_frame_groups_read_every_frame_once_from_its_source(b0, b1):
    B = b0 + b1
    for tiles in (1, 7, 1536, 6064):
        frames = window.frames_per_cta(B, tiles)
        seen = []
        for src, first, n, out in _k3_groups(B, b0, frames):
            assert 1 <= n <= frames
            for k in range(n):
                assert sources.locate((b0, b1), out + k) == (src, first + k)
                seen.append(out + k)
        assert seen == list(range(B))


@pytest.mark.parametrize("layout", ["separate", "strided views"])
@pytest.mark.parametrize("opts", sorted(OPTS))
def test_slice_with_u_and_v_where_they_lie_against_jax(opts, layout):
    y, u, v = _frames()
    jf = J.open_filter(OPTS[opts], W, H)
    want = [np.asarray(o) for o in jpipeline.transform_frame_planes(jf.plan, (y, u, v))]
    tp = plan_from_jax(jf.plan)
    if layout == "separate":  # U and V in tensors of their own, not adjacent
        planes = [torch.from_numpy(p.copy()) for p in (y, u, v)]
    else:
        planes = list(_packed_buffer(y, u, v))
    pipeline.clear_executor_cache()
    copies = COUNTERS["pipeline.plane_copies"]
    got = pipeline.transform_frame_planes(tp, planes, device="cpu")
    assert COUNTERS["pipeline.plane_copies"] == copies  # packed rows: nothing copied
    for a, b, name in zip(got, want, "YUV"):
        assert tuple(a.shape) == b.shape and a.dtype == torch.uint8
        d = np.abs(a.numpy().astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= FMA_TIE_FRAC, (name, d.max(), (d > 0).mean())
    # the port's own bytes equal those of the same planes stacked
    stacked = pipeline.transform_frame_planes(
        tp, [torch.from_numpy(np.ascontiguousarray(p)) for p in (y, u, v)], device="cpu")
    for a, b in zip(got, stacked):
        assert torch.equal(a, b)
    # the chroma executor keeps each plane's frames in its key
    ex = pipeline.plane_executor(tp.chroma, "cpu")
    assert [k[-1] for k in ex._by_shape] == [(B, B)]


def test_planes_whose_rows_are_not_packed_are_copied_and_counted():
    y, u, v = _frames()
    tp = plan_from_jax(J.open_filter(OPTS["no prefilter"], W, H).plan)
    want = pipeline.transform_frame_planes(tp, [torch.from_numpy(p) for p in (y, u, v)],
                                           device="cpu")
    ut = torch.from_numpy(np.ascontiguousarray(u.transpose(0, 2, 1))).transpose(1, 2)
    assert not sources.rows_packed(ut) and torch.equal(ut, torch.from_numpy(u))
    copies = COUNTERS["pipeline.plane_copies"]
    got = pipeline.transform_frame_planes(
        tp, [torch.from_numpy(y), ut, torch.from_numpy(v)], device="cpu")
    assert COUNTERS["pipeline.plane_copies"] == copies + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_take_two_sources_and_refuse_bad_ones():
    tp = plan_from_jax(J.open_filter(OPTS["prefilter"], W, H).plan)
    bt, wt = tp.chroma.tables("cpu").blur, tp.chroma.window_tables("cpu")
    _, u, v = (torch.from_numpy(p) for p in _frames())
    for fn, tab in ((blur.blur_px, bt), (window.remap_window_px, wt)):
        assert torch.equal(fn(tab, (u, v[:2])), fn(tab, torch.cat([u, v[:2]])))
        with pytest.raises(ValueError):  # at most two sources
            fn(tab, (u, v, v))
        with pytest.raises(ValueError):  # one source on another device
            fn(tab, (u, torch.zeros((1, CH, CW), dtype=torch.uint8, device="meta")))
        with pytest.raises(ValueError):  # rows not packed: the pipeline copies, never a kernel
            fn(tab, (u, v.transpose(1, 2).contiguous().transpose(1, 2)))
        with pytest.raises(ValueError):
            fn(tab, (u, v[:0]))
