"""The CUDA kernels against their plain PyTorch versions, on a GPU.

K1 (csrc/blur.cu) and K3 (csrc/window.cu) are built to round exactly
where ``blur_plain`` and ``remap_plain`` do, so the bound asserted here
— at most 1 LSB on under 0.5% of pixels — is expected to hold with 0
differences.  The cases cover every border rule and tap count of K3 at
batch 1 to 256 (every instantiation: each tap count under each border
rule, at batch 1 and 3), an output width that is not a
multiple of the tile's, tap rows starting at every byte of a word, an
unaligned plane, K3's global-path tiles, and every stereo raster of K1
at small sizes, its ring kernels (y radius padded to 1 or 3) and its
direct kernel (a wider y radius, or taps that are not Gaussian); K1's
persistent walks (one CTA to one per item, parts, ring depths, both
copies), the flagship's stacked chroma at batch 1, 2, 19 and 512, tiles
at all four plane edges with rx 6 at 8 and 16 bits (samples at 65535),
unaligned rows and bases, and K1 inside a captured CUDA graph.  The uint16 instantiations of both (10- to 16-bit planes, samples
saturated at 65535 included) on the same cases, every K3 instantiation
at uint16, an unaligned uint16 plane, and the deep, supersampled and
plan-file engines against the CPU engine.  K4 (csrc/area.cu) against
``area_plain`` at 0 LSB, at uint8, 10 and 16 bits (samples past the
depth's maximum), batch 1, 7 and 256, at 2x2, 4x4, 1.5x2, 200x90 ->
70x40, the upscale branch, 8x (direct tiles), a ragged width with
unaligned rows, and an unaligned plane; the flagship's 2x2 luma at batch
1 and 129; and every copy, ring depth, path and grid of a launch.  The fidelity gate at its size
against the committed oracle fixture, and the drop-in ffmpeg wrapper on
in-memory pipes, at 8 and 10 bits.  The plane executors: a CUDA graph
replayed on the caller's planes against the eager program at 0 LSB
(batch 1, 2, 8 and ``GRAPH_MAX_BATCH``; uint8, 10-bit and supersampled
2x2, so K4 in the graph; numpy planes; strided views of packed yuv420p
frames, a U base off 16 bytes and a frame stride off 16 bytes, each kind
its own capture; a banded frame read in place), with the caller's planes
never written, outputs that never alias, no copy (a graph of card planes
keeps no buffer of them),
the launch counters at each replay, a node update that the kernel
refuses (it raises), a call inside a caller's own capture, and a capture
that fails.  K1 and K3 on a batch given as two sources
(separate tensors, strided views of one packed buffer, an unaligned
frame stride or base; uint8 and 10-bit; K3's frame groups cut at their
boundary) and the engine on strided U and V
views, with and without a prefilter.
K3 on the 4K flagship's plans and its 2x2 supersampled twin's (3072x2048
windows of a few samples a pixel) at uint8 and 10 bits, batch 1 to 128,
with U and V in place.  K3's small windows at WIDE_FRAMES frames a pass
(batch 1, 7, 9, 17, 128, 129; T = 4 and 8, a transparent border with
global-path tiles, uint8 and 10 bits, TF32 on and off; U and V cut inside
a pass), and a batch-8 replay of the 2x2 supersampled 4K cubemap with
one K3 node per window class, as before class 0 was split.
Marked ``cuda``: they skip without a GPU.  On the GPU host, which has no
jax, run them without the suite's conftest.py (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu_torch import pipeline
from transform360_tpu_torch.filtering import blur_plain
from transform360_tpu_torch.ops import area, blur, window
from transform360_tpu_torch.sampling import (
    BORDER_FILL, BORDER_REFLECT, BORDER_WRAP, AreaTables, DeviceArea, DeviceSpec, remap_plain,
    round_px, round_u8,
)
from transform360_tpu_torch.utils.profiling import COUNTERS

pytestmark = pytest.mark.cuda

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
CASES = {
    "cubic-cubemap": (TransformConfig(**MONO), 512, 256, 192, 128),
    "linear-barrel": (TransformConfig(output_layout=Layout.BARREL,
                                      interpolation_alg=Interpolation.LINEAR, **MONO),
                      256, 128, 160, 64),
    "lanczos4-barrel": (TransformConfig(output_layout=Layout.BARREL_SPLIT,
                                        interpolation_alg=Interpolation.LANCZOS4, **MONO),
                        256, 128, 192, 64),
    "nearest-barrel": (TransformConfig(output_layout=Layout.BARREL,
                                       interpolation_alg=Interpolation.NEAREST, **MONO),
                       256, 128, 160, 64),
    "lanczos4-eac": (TransformConfig(output_layout=Layout.EAC_32,
                                     interpolation_alg=Interpolation.LANCZOS4, **MONO),
                     256, 128, 96, 64),
    "tb-odd": (TransformConfig(input_stereo_format=StereoFormat.TB,
                               output_stereo_format=StereoFormat.TB), 256, 161, 96, 128),
    "lr-odd": (TransformConfig(input_stereo_format=StereoFormat.LR,
                               output_stereo_format=StereoFormat.LR), 513, 80, 192, 64),
    "adaptive-32x15": (TransformConfig(num_vertical_segments=32,
                                       num_horizontal_segments=15, **MONO), 960, 480, 240, 160),
    "offcenter-3seg": (TransformConfig(num_horizontal_segments=3, fixed_cube_offcenter_z=0.5,
                                       **MONO), 256, 80, 96, 64),
    # y radius 5: K1's direct kernel
    "wide-y-taps": (TransformConfig(min_kernel_half_height=5, **MONO), 256, 80, 96, 64),
}


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _assert_close(got, want, what):
    d = (got.int() - want.int()).abs()
    frac = float((d > 0).float().mean())
    assert int(d.max()) <= 1 and frac < 0.005, (what, int(d.max()), frac)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain(name, gpu):
    cfg, iw, ih, ow, oh = CASES[name]
    plan = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p")
    g = torch.Generator(device=gpu).manual_seed(0)
    for pp in (plan.luma, plan.chroma):
        t = pp.tables(gpu)
        x = torch.randint(0, 256, (5, pp.in_h, pp.in_w), dtype=torch.uint8,
                          device=gpu, generator=g)
        if t.blur is not None:
            n = COUNTERS["blur.launches"]
            got = blur.blur_px(t.blur, x)
            torch.cuda.synchronize()
            assert COUNTERS["blur.launches"] == n + 1
            _assert_close(got, round_u8(blur_plain(t.blur.plan, x.float())), f"K1 {name}")
        wt = pp.window_tables(gpu)
        n = COUNTERS["window.launches"]
        got = window.remap_window_px(wt, x)
        torch.cuda.synchronize()
        assert COUNTERS["window.launches"] == n + len(window.launches(wt.groups, 5))
        ds = DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
        _assert_close(got, round_u8(remap_plain(ds, x)), f"K3 {name}")


def test_blur_frame_loops_match_one_frame_at_a_time(gpu, monkeypatch):
    cfg, iw, ih, ow, oh = CASES["cubic-cubemap"]
    t = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma.tables(gpu)
    x = torch.randint(0, 256, (19, ih, iw), dtype=torch.uint8, device=gpu)
    want = torch.cat([blur.blur_px(t.blur, x[i : i + 1].contiguous()) for i in range(19)])
    # one persistent CTA walks every (tile, frame, part) item of the 19
    # frames through the ring, then two CTAs, then one per item
    lib, stream = blur.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    for parts, ctas in ((1, 1), (3, 2), (2, 0), (1, t.blur.tiles.shape[0] * 19)):
        out = torch.zeros_like(x)
        blur.launch(lib, t.blur, x, out, stream, parts=parts, ctas=ctas)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (parts, ctas)
    monkeypatch.setattr(blur, "ITEMS_PER_CTA", 1)  # parts: 1 per tile
    n = COUNTERS["blur.launches"]
    got = blur.blur_px(t.blur, x)
    torch.cuda.synchronize()
    assert COUNTERS["blur.launches"] == n + 1 and torch.equal(got, want)


def _flagship_pp(plane, pix_fmt="yuv420p", scale=1):
    opts = ("cube_edge_length=%d:interpolation_alg=cubic:enable_low_pass_filter=1:"
            "input_stereo_format=mono" % (512 // scale))
    plan = P.open_filter(opts, 3840 // scale, 2160 // scale, pix_fmt=pix_fmt, device="cpu").plan
    return plan.luma if plane == "luma" else plan.chroma


@pytest.mark.parametrize("b", [1, 2, 19, 512])
def test_blur_kernel_batches_of_stacked_chroma(b, gpu):
    # the flagship's stacked chroma (1920x1080: two column tiles, rx 6 at
    # the poles) at the batch sizes whose parts and grids differ
    pp = _flagship_pp("chroma")
    t = pp.tables(gpu)
    g = torch.Generator(device=gpu).manual_seed(b)
    x = torch.randint(0, 256, (b, pp.in_h, pp.in_w), dtype=torch.uint8, device=gpu, generator=g)
    got = blur.blur_px(t.blur, x)
    for f0 in range(0, b, 32):
        want = round_u8(blur_plain(t.blur.plan, x[f0:f0 + 32].float()))
        assert torch.equal(got[f0:f0 + 32], want), (b, f0)


EDGE_CASES = {  # K1's plane-edge tiles: rx 6 tiles at all four edges, and rows
    # that are not 16-byte aligned (the producer's loads) at odd widths
    "edges-rx6": (TransformConfig(**MONO), 320, 180, 126, 84),
    "edges-rx6-odd-width": (TransformConfig(**MONO), 322, 181, 126, 84),
    "lr-odd": CASES["lr-odd"],
}


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_blur_kernel_plane_edges(name, depth, gpu):
    cfg, iw, ih, ow, oh = EDGE_CASES[name]
    pix = "gray" if depth == 8 else "gray16le"
    t = P.build_plan(cfg, iw, ih, ow, oh, pix).luma.tables(gpu)
    mx = (1 << depth) - 1
    g = torch.Generator(device=gpu).manual_seed(depth)
    x = _rand_u16((5, ih, iw), mx, gpu, g) if depth == 16 else torch.randint(
        0, 256, (5, ih, iw), dtype=torch.uint8, device=gpu, generator=g)
    x[1] = mx  # a saturated frame
    x[2, :, :7] = mx  # saturated columns along the left edge, and rows at the top
    x[2, :3] = mx
    want = round_px(blur_plain(t.blur.plan, x.float()), mx, x.dtype)
    assert _same(blur.blur_px(t.blur, x, mx), want)
    buf = torch.zeros(5 * ih * iw + 1, dtype=x.dtype, device=gpu)  # an unaligned base
    xu = buf[1:].view(5, ih, iw)
    xu.copy_(x)
    assert blur.copy_mode(t.blur, xu) == blur.COPY_WARP
    assert _same(blur.blur_px(t.blur, xu, mx), want)


@pytest.mark.parametrize("name", ["edges-rx6", "half-flagship"])
def test_blur_kernel_launch_variants(name, gpu):
    # every copy (TMA where the plane allows it, the producer's loads),
    # ring depth, part count, grid and columns per thread computes the same
    # bytes; the flagship at half size (1920x1080 luma) has TMA-staged edge
    # tiles
    if name == "half-flagship":
        t = _flagship_pp("luma", scale=2).tables(gpu)
        ih, iw = t.blur.H, t.blur.W
    else:
        cfg, iw, ih, ow, oh = EDGE_CASES[name]
        t = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma.tables(gpu)
    x = torch.randint(0, 256, (7, ih, iw), dtype=torch.uint8, device=gpu)
    want = round_u8(blur_plain(t.blur.plan, x.float()))
    lib, stream = blur.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    n_items = t.blur.tiles.shape[0] * 7
    copies = (blur.COPY_WARP,) + ((blur.COPY_TMA,) if blur.copy_mode(t.blur, x) == blur.COPY_TMA
                                  else ())
    assert (name == "half-flagship") == (len(copies) == 2)
    for copy in copies:
        for stages in (2, 3, 8):
            for parts in (1, 2, 5):
                for ctas in (1, 0, n_items * parts):
                    for cols in (8, 16):  # uint8 at y radius 1: both instantiations
                        out = torch.zeros_like(want)
                        blur.launch(lib, t.blur, x, out, stream, copy=copy, stages=stages,
                                    parts=parts, ctas=ctas, cols=cols)
                        torch.cuda.synchronize()
                        assert torch.equal(out, want), (name, copy, stages, parts, ctas, cols)


def test_blur_kernel_in_a_captured_graph(gpu):
    # K1 captured in a CUDA graph (its tensor map and grid fixed at
    # capture) replays on new frames copied into the static input
    pp = _flagship_pp("luma", scale=2)
    t = pp.tables(gpu)
    g = torch.Generator(device=gpu).manual_seed(3)
    static = torch.randint(0, 256, (2, pp.in_h, pp.in_w), dtype=torch.uint8, device=gpu,
                           generator=g)
    blur.blur_px(t.blur, static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = blur.blur_px(t.blur, static)
    for seed in range(3):
        g.manual_seed(100 + seed)
        static.copy_(torch.randint(0, 256, static.shape, dtype=torch.uint8, device=gpu,
                                   generator=g))
        n = COUNTERS["blur.launches"]
        graph.replay()
        torch.cuda.synchronize()
        assert COUNTERS["blur.launches"] == n  # a replay is no call of the wrapper
        assert torch.equal(out, round_u8(blur_plain(t.blur.plan, static.float()))), seed


def test_blur_direct_kernel_takes_taps_that_are_not_gaussian(gpu):
    cfg, iw, ih, ow, oh = CASES["cubic-cubemap"]
    bp = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma.blur
    b = bp.bands[0]
    kx = b.kx.copy()
    kx[:, 0] = np.nextafter(kx[:, 0], np.float32(1))  # asymmetric by an ulp
    odd = dataclasses.replace(bp, bands=(dataclasses.replace(b, kx=kx),) + tuple(bp.bands[1:]))
    bt = blur.BlurTables.from_plan(odd, ih, iw, gpu)
    assert bt.ring_ry == -1
    x = torch.randint(0, 256, (3, ih, iw), dtype=torch.uint8, device=gpu)
    assert torch.equal(blur.blur_px(bt, x), round_u8(blur_plain(odd, x.float())))


def test_kernels_take_a_batch_of_1024(gpu):
    # the stacked chroma of a 512-frame batch: K1's frame groups and K3's
    # frame loop over 1024 planes, against the plain versions
    cfg, iw, ih, ow, oh = CASES["cubic-cubemap"]
    pp = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p").chroma
    t = pp.tables(gpu)
    x = torch.randint(0, 256, (1024, pp.in_h, pp.in_w), dtype=torch.uint8, device=gpu)
    b = blur.blur_px(t.blur, x)
    assert torch.equal(b, round_u8(blur_plain(t.blur.plan, x.float())))
    got = window.remap_window_px(pp.window_tables(gpu), b)
    assert torch.equal(got, round_u8(remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, gpu), b)))


def test_blur_kernel_unaligned_plane(gpu):
    # a plane that does not start on a 16-byte boundary: byte loads and stores
    cfg, iw, ih, ow, oh = CASES["cubic-cubemap"]
    t = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma.tables(gpu)
    buf = torch.randint(0, 256, (2 * ih * iw + 1,), dtype=torch.uint8, device=gpu)
    x = buf[1:].view(2, ih, iw)
    assert torch.equal(blur.blur_px(t.blur, x), round_u8(blur_plain(t.blur.plan, x.float())))


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "gray"])
def test_engine_cuda_matches_engine_cpu(pix_fmt, gpu):
    opts = "cube_edge_length=64:interpolation_alg=cubic:input_stereo_format=mono"
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (9, 256, 512), dtype=np.uint8)]
    if pix_fmt != "gray":
        planes += [rng.integers(0, 256, (9, 128, 256), dtype=np.uint8) for _ in range(2)]
    got = P.open_filter(opts, 512, 256, pix_fmt=pix_fmt, device=gpu).transform(*planes)
    want = P.open_filter(opts, 512, 256, pix_fmt=pix_fmt, device="cpu").transform(*planes)
    if pix_fmt == "gray":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        _assert_close(a.cpu(), b, f"engine {pix_fmt}")


@pytest.mark.parametrize("name", sorted(CASES) + ["decimated-global"])
def test_window_kernel_matches_plain(name, gpu):
    if name == "decimated-global":  # pole windows beyond every class
        cfg, iw, ih, ow, oh = TransformConfig(**MONO), 2048, 1024, 192, 128
    else:
        cfg, iw, ih, ow, oh = CASES[name]
    plan = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p")
    g = torch.Generator(device=gpu).manual_seed(1)
    for pp in (plan.luma, plan.chroma):
        wt, ds = pp.window_tables(gpu), DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
        for B in (1, 3, 8, 128, 256):
            x = torch.randint(0, 256, (B, pp.in_h, pp.in_w), dtype=torch.uint8,
                              device=gpu, generator=g)
            n = COUNTERS["window.launches"]
            got = window.remap_window_px(wt, x)
            torch.cuda.synchronize()
            assert COUNTERS["window.launches"] == n + len(window.launches(wt.groups, B))
            want = round_u8(remap_plain(ds, x))
            assert torch.equal(got, want), f"K3 {name} B={B}"
    if name == "decimated-global":
        wp = window.build_window_plan(plan.luma.spec, plan.luma.fill)
        assert (wp.tile_class < 0).any()


@pytest.mark.parametrize("name", ["cubic-cubemap", "linear-barrel", "lanczos4-barrel"])
def test_window_kernel_unaligned_plane(name, gpu):
    # a plane that does not start on a 16-byte boundary: byte loads only
    cfg, iw, ih, ow, oh = CASES[name]
    pp = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma
    wt = pp.window_tables(gpu)
    buf = torch.randint(0, 256, (2 * ih * iw + 1,), dtype=torch.uint8, device=gpu)
    x = buf[1:].view(2, ih, iw)
    got = window.remap_window_px(wt, x)
    assert torch.equal(got, round_u8(remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, gpu), x)))


INTERPS = {1: Interpolation.NEAREST, 2: Interpolation.LINEAR, 4: Interpolation.CUBIC,
           8: Interpolation.LANCZOS4}
MODES = {"wrap": BORDER_WRAP, "fill": BORDER_FILL, "reflect": BORDER_REFLECT}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("taps", sorted(INTERPS))
def test_window_kernel_every_instantiation(taps, mode, gpu):
    # each tap count under each border rule, at batch 3 (two frames per
    # pass) and 1, on a wrapping cubemap plan and a barrel plan with
    # its valid mask; the rule is set on the tables, so the reference is
    # K3's plain version (equal to remap_plain where the rule is the plan's
    # own: tests/test_torch_window.py)
    g = torch.Generator(device=gpu).manual_seed(taps)
    for layout, iw, ih, ow, oh in ((Layout.CUBEMAP_32, 512, 256, 150, 100),
                                   (Layout.BARREL, 256, 128, 160, 64)):
        cfg = TransformConfig(output_layout=layout, interpolation_alg=INTERPS[taps], **MONO)
        pp = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma
        wp = window.build_window_plan(pp.spec, pp.fill)
        wt = dataclasses.replace(window.WindowTables.from_plan(wp, gpu), mode=MODES[mode])
        x = torch.randint(0, 256, (3, ih, iw), dtype=torch.uint8, device=gpu, generator=g)
        for b in (3, 1):
            got = window.remap_window_px(wt, x[:b])
            want = round_u8(window.remap_window_plain(wt, x[:b]))
            assert torch.equal(got, want), (layout, b)


def test_window_kernel_ragged_width_and_every_word_offset(gpu):
    # 390 output columns: not a multiple of the tile's; the tap rows of the
    # staged pixels start at every byte of a 32-bit word
    cfg = TransformConfig(**MONO)
    pp = P.build_plan(cfg, 1024, 512, 390, 260, "gray").luma
    wp = window.build_window_plan(pp.spec, pp.fill)
    assert wp.out_w % window.TW != 0
    staged = np.repeat(wp.meta[:, 5] > 0, wp.pos.size // wp.meta.shape[0])
    lx = (wp.pos >> 16)[staged]
    assert set(np.unique(lx % 4).tolist()) == {0, 1, 2, 3}
    wt = window.WindowTables.from_plan(wp, gpu)
    x = torch.randint(0, 256, (5, 512, 1024), dtype=torch.uint8, device=gpu)
    got = window.remap_window_px(wt, x)
    assert torch.equal(got, round_u8(remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, gpu), x)))


@pytest.mark.parametrize("frames", [1, 2, 3, 5, 0])
def test_window_kernel_frame_groups_and_passes(frames, gpu):
    # a launch's frames per CTA (0: the whole batch) with one frame a pass
    # and with each plan range's own (up to WIDE_FRAMES), on batches that
    # end mid-pass and mid-group (1, 2, 5, 17 frames), on the wrapping
    # cubemap (windows across the seam), the barrel's clamp-with-fill and
    # REFLECT_101 (lanczos4) and the global path (pole tiles)
    g = torch.Generator(device=gpu).manual_seed(7)
    lib, stream = window.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    cases = [CASES[n] for n in ("cubic-cubemap", "linear-barrel", "lanczos4-barrel")]
    cases.append((TransformConfig(**MONO), 2048, 1024, 192, 128))  # pole tiles: global path
    for cfg, iw, ih, ow, oh in cases:
        pp = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma
        wt = pp.window_tables(gpu)
        x = torch.randint(0, 256, (17, ih, iw), dtype=torch.uint8, device=gpu, generator=g)
        want = round_u8(remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, gpu), x))
        for b in (1, 2, 5, 17):
            for pair in (False, True):
                out = torch.zeros((b, wt.out_h, wt.out_w), dtype=torch.uint8, device=gpu)
                for group in wt.groups:
                    window.launch_class(lib, wt, x[:b], out, group, min(frames or b, b),
                                        group[3] if pair else 1, stream)
                assert torch.equal(out, want[:b]), (frames, iw, b, pair)


@pytest.mark.parametrize("sample_bytes", [1, 2])
def test_window_kernel_seam_rows_and_unaligned_rows(sample_bytes, gpu):
    # a cubemap whose windows cross the seam (chunks past W come from
    # column 0), and planes whose rows are not whole 16-byte chunks (250
    # and 90 samples: every chunk sample by sample)
    g = torch.Generator(device=gpu).manual_seed(8)
    mx = 255 if sample_bytes == 1 else 65535
    for iw, ih in ((512, 256), (250, 125), (90, 45)):
        pp = P.build_plan(TransformConfig(**MONO), iw, ih, 150, 100,
                          "gray" if sample_bytes == 1 else "gray16le").luma
        wp = pp.window_plan()
        staged = wp.meta[:, 5] > 0
        assert (wp.meta[staged, 3] + wp.meta[staged, 5] > iw).any()  # across the seam
        x = _rand_u16((5, ih, iw), mx, gpu, g) if sample_bytes == 2 else \
            torch.randint(0, 256, (5, ih, iw), dtype=torch.uint8, device=gpu, generator=g)
        ds = DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
        for b in (1, 5):
            got = window.remap_window_px(pp.window_tables(gpu), x[:b], mx)
            want = round_px(remap_plain(ds, x[:b]), mx, pp.dtype)
            assert _same(got, want), (iw, b)


def test_window_kernel_latency_band_plans(gpu):
    # the bands of a latency-band plan: each band's classes, few tiles
    from transform360_tpu_torch.parallel import latency

    plan = P.build_plan(TransformConfig(**MONO), 512, 256, 192, 128, "yuv420p")
    g = torch.Generator(device=gpu).manual_seed(9)
    for band in latency.band_plans(plan, 3):
        for pp in (band.luma, band.chroma):
            x = torch.randint(0, 256, (3, pp.in_h, pp.in_w), dtype=torch.uint8, device=gpu,
                              generator=g)
            ds = DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
            for b in (1, 3):
                got = window.remap_window_px(pp.window_tables(gpu), x[:b])
                assert torch.equal(got, round_u8(remap_plain(ds, x[:b])))


def test_engine_routes_by_batch_on_the_card(gpu):
    # every batch size launches K1 once per plane batch and K3 once per
    # window class present, and equals the CPU engine
    opts = ("cube_edge_length=64:interpolation_alg=cubic:enable_low_pass_filter=1:"
            "input_stereo_format=mono")
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (130, 256, 512), dtype=np.uint8)
    uv = [rng.integers(0, 256, (130, 128, 256), dtype=np.uint8) for _ in range(2)]
    eng = P.open_filter(opts, 512, 256, device=gpu)
    cpu = P.open_filter(opts, 512, 256, device="cpu")
    for b in (1, 130):
        planes = (y[0], uv[0][0], uv[1][0]) if b == 1 else (y, *uv)
        n1, n3 = COUNTERS["blur.launches"], COUNTERS["window.launches"]
        got = eng.transform(*planes)
        torch.cuda.synchronize()
        wt = (eng.plan.luma.window_tables(gpu), eng.plan.chroma.window_tables(gpu))
        assert COUNTERS["blur.launches"] - n1 == 2
        assert COUNTERS["window.launches"] - n3 == (len(window.launches(wt[0].groups, b))
                                                    + len(window.launches(wt[1].groups, 2 * b, b)))
        for a, c in zip(got, cpu.transform(*planes)):
            assert torch.equal(a.cpu(), c)


def _rand_u16(shape, maxval, gpu, g):
    """uint16 samples in [0, maxval] on the card (drawn as int32: uint16
    has no random kernel)."""
    x = torch.randint(0, maxval + 1, shape, dtype=torch.int32, device=gpu, generator=g)
    return x.to(torch.uint16)


def _same(a, b):
    return torch.equal(a.int(), b.int())


def _k13_counts():
    """K1's and K3's launches so far: uint8, then uint16."""
    return tuple(COUNTERS[k] for k in ("blur.launches", "window.launches", "blur.launches_u16",
                                       "window.launches_u16"))


def _two_sources(x, b0, layout):
    """``x`` ([B, H, W]) as two sources of b0 and B - b0 frames:
    ``separate`` tensors; ``strided`` views of one packed buffer whose
    frames hold a plane of each (as U and V of yuv420p frames); the same
    with 8 bytes of padding a frame (``unaligned stride``: TMA and K3's
    16-byte copies do not apply); or source 1 one sample off a 16-byte
    base (``unaligned base``)."""
    B, h, w = x.shape
    n, b1 = h * w, B - b0
    if layout == "separate":
        return x[:b0].clone(), x[b0:].clone()
    if layout == "unaligned base":
        flat = torch.zeros(b1 * n + 1, dtype=x.dtype, device=x.device)
        s1 = flat[1:].view(b1, h, w)
        s1.copy_(x[b0:])
        return x[:b0].clone(), s1
    pad = 0 if layout == "strided" else 8 // x.element_size()
    buf = torch.zeros((max(b0, b1), 2 * n + pad), dtype=x.dtype, device=x.device)
    s0, s1 = buf[:b0, :n].unflatten(1, (h, w)), buf[:b1, n:2 * n].unflatten(1, (h, w))
    s0.copy_(x[:b0])
    s1.copy_(x[b0:])
    return s0, s1


SOURCE_LAYOUTS = ("separate", "strided", "unaligned stride", "unaligned base")


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("layout", SOURCE_LAYOUTS)
def test_kernels_read_two_sources(layout, depth, gpu):
    # K1 and K3 on a batch given as two sources (b0 1, 2, odd, even),
    # against the plain versions on the stacked batch: K1's TMA maps (or
    # the producer's loads where a source is unaligned) and direct kernel,
    # K3's frame groups cut at b0 (one frame a pass and each plan range's
    # own, frames per CTA 1, 2, 3 and all)
    g = torch.Generator(device=gpu).manual_seed(21)
    mx = 255 if depth == 8 else 1023
    lib, stream = window.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    for name in ("cubic-cubemap", "lanczos4-barrel", "wide-y-taps"):
        cfg, iw, ih, ow, oh = CASES[name]
        pp = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p" if depth == 8 else "yuv420p10le").chroma
        t, wt = pp.tables(gpu), pp.window_tables(gpu)
        ds = DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
        for b0, b1 in ((1, 1), (1, 4), (3, 4), (2, 2), (5, 3)):
            shape = (b0 + b1, pp.in_h, pp.in_w)
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device=gpu, generator=g) \
                if depth == 8 else _rand_u16(shape, mx, gpu, g)
            xs = _two_sources(x, b0, layout)
            want = round_px(blur_plain(t.blur.plan, x.float()), mx, pp.dtype)
            got = blur.blur_px(t.blur, xs, mx)
            assert _same(got, want), ("K1", name, layout, b0, b1)
            want = round_px(remap_plain(ds, x), mx, pp.dtype)
            assert _same(window.remap_window_px(wt, xs, mx), want), ("K3", name, layout, b0, b1)
            for frames in (1, 2, 3, 0):
                for pair in (False, True):
                    out = torch.zeros((b0 + b1, wt.out_h, wt.out_w), dtype=pp.dtype, device=gpu)
                    for group in wt.groups:
                        window.launch_class(lib, wt, xs, out, group,
                                            min(frames or b0 + b1, b0 + b1),
                                            group[3] if pair else 1, stream, mx)
                    assert _same(out, want), (name, layout, b0, b1, frames, pair)
        if layout in ("unaligned stride", "unaligned base") and t.blur.ring_ry > 0:
            assert blur.copy_mode(t.blur, xs) == blur.COPY_WARP


@pytest.mark.parametrize("prefilter", [1, 0])
def test_engine_takes_u_and_v_where_they_lie(prefilter, gpu):
    # U and V as strided views of packed yuv420p frames on the card (and
    # luma too): the same bytes as the CPU engine, at batch 1 and 2 (a
    # graph replayed on the views where they lie) and 5 (eager), with no
    # plane copied; without a prefilter K3 reads them where they lie
    opts = (f"cube_edge_length=64:interpolation_alg=cubic:enable_low_pass_filter={prefilter}:"
            "input_stereo_format=mono")
    rng = np.random.default_rng(5)
    n, nc = 256 * 512, 128 * 256
    buf = torch.from_numpy(rng.integers(0, 256, (5, n + 2 * nc), dtype=np.uint8)).to(gpu)
    y = buf[:, :n].unflatten(1, (256, 512))
    u, v = (buf[:, n + k * nc:n + (k + 1) * nc].unflatten(1, (128, 256)) for k in (0, 1))
    eng = P.open_filter(opts, 512, 256, device=gpu)
    cpu = P.open_filter(opts, 512, 256, device="cpu")
    from transform360_tpu_torch import pipeline

    for b in (1, 2, 2, 5):
        copies = COUNTERS["pipeline.plane_copies"]
        got = eng.transform(y[:b], u[:b], v[:b])
        torch.cuda.synchronize()
        assert COUNTERS["pipeline.plane_copies"] == copies
        for a, c in zip(got, cpu.transform(*(p[:b].cpu() for p in (y, u, v)))):
            assert torch.equal(a.cpu(), c), b


FLAGSHIP = ("cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:"
            "input_stereo_format=mono")
K3_4K = {"flagship": FLAGSHIP, "ss2x2": FLAGSHIP + ":width_scale_factor=2:height_scale_factor=2"}


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("name", sorted(K3_4K))
def test_window_kernel_at_4k(name, depth, gpu):
    # K3 at 0 LSB on the 4K plans' luma and chroma: the flagship's
    # (1536x1024 and 768x512) and its 2x2 supersampled twin's (3072x2048
    # and 1536x1024: windows of a few samples a pixel), at batch 1, 16 and
    # 128 (small windows WIDE_FRAMES frames a pass from 16 frames on, the
    # others two; batches that end mid-pass), and the chroma
    # as U and V in place: two separate sources and strided views of
    # packed frames
    pix_fmt = "yuv420p" if depth == 8 else "yuv420p10le"
    plan = P.open_filter(K3_4K[name], 3840, 2160, pix_fmt=pix_fmt, device=gpu).plan
    g = torch.Generator(device=gpu).manual_seed(depth)
    for pp in (plan.luma, plan.chroma):
        wt, ds, mx = pp.window_tables(gpu), DeviceSpec.from_spec(pp.spec, pp.fill, gpu), pp.maxval
        shape = (128, pp.in_h, pp.in_w)
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=gpu, generator=g) \
            if depth == 8 else _rand_u16(shape, mx, gpu, g)
        want = torch.cat([round_px(remap_plain(ds, x[k:k + 16]), mx, pp.dtype)
                          for k in range(0, 128, 16)])
        for b in (1, 16, 127, 128):
            assert _same(window.remap_window_px(wt, x[:b], mx), want[:b]), (name, depth, b)
        if pp is plan.chroma:
            for layout in ("separate", "strided"):
                xs = _two_sources(x[:33], 16, layout)
                assert _same(window.remap_window_px(wt, xs, mx), want[:33]), (name, layout)


# plans whose class 0 has small windows (WIDE_FRAMES frames a pass, in a
# range of their own whatever their share: WIDE_PLAN) and others (two),
# and a larger class: a wrapping cubemap at T = 4 and at T = 8, and a
# barrel (transparent border: clamp with fill and a valid mask) whose
# global-path tiles lead the small windows' launch
WIDE_PLAN = (window.SMALL_BYTES, window.WIDE_FRAMES, 0.0)
WIDE_CASES = {
    "cubic-cubemap": (TransformConfig(**MONO), 1024, 512, 384, 256),
    "lanczos4-cubemap": (TransformConfig(interpolation_alg=Interpolation.LANCZOS4, **MONO),
                         1024, 512, 384, 256),
    "cubic-barrel-global": (TransformConfig(output_layout=Layout.BARREL, **MONO),
                            2048, 1024, 640, 256),
}


def _wide_tables(pp, gpu):
    """``pp``'s K3 tables with class 0's small windows in a range of their
    own (``WIDE_PLAN``)."""
    sb = 1 if pp.dtype == torch.uint8 else 2
    return window.WindowTables.from_plan(window.build_window_plan(pp.spec, pp.fill, sb, WIDE_PLAN),
                                         gpu)


def _plain_in_chunks(pp, ds, x, mx):
    """``remap_plain`` on ``ds`` rounded, 16 frames at a time."""
    return torch.cat([round_px(remap_plain(ds, x[k:k + 16]), mx, pp.dtype)
                      for k in range(0, x.shape[0], 16)])


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_window_kernel_wide_passes(name, depth, gpu):
    # small windows staged WIDE_FRAMES frames a pass, the pass's copies
    # dealt over every thread, 0 LSB against remap_plain with TF32 on and
    # off: the package's launches at batch 1, 7, 9, 17, 128 and 129 (one
    # class-0 launch at two frames a pass on CTA_FRAMES_MIN frames or
    # fewer), and each plan range at its own frames a pass on the whole
    # batch and on 3 and 11 frames a CTA (passes cut short, odd counts)
    cfg, iw, ih, ow, oh = WIDE_CASES[name]
    pp = P.build_plan(cfg, iw, ih, ow, oh, "gray" if depth == 8 else "gray10le").luma
    wt, ds, mx = _wide_tables(pp, gpu), DeviceSpec.from_spec(pp.spec, pp.fill, gpu), pp.maxval
    assert [g[3] for g in wt.groups] == [window.WIDE_FRAMES, 2, 1]
    g = torch.Generator(device=gpu).manual_seed(depth + 22)
    shape = (129, ih, iw)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=gpu, generator=g) \
        if depth == 8 else _rand_u16(shape, mx, gpu, g)
    want = _plain_in_chunks(pp, ds, x, mx)
    lib, stream = window.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
            for b in (1, 7, 9, 17, 128, 129):
                got = window.remap_window_px(wt, x[:b], mx)
                assert _same(got, want[:b]), (name, depth, b, on)
                for frames in (b, 3, 11):
                    out = torch.zeros((b, wt.out_h, wt.out_w), dtype=pp.dtype, device=gpu)
                    for group in wt.groups:
                        window.launch_class(lib, wt, x[:b], out, group, min(frames, b), group[3],
                                            stream, mx)
                    assert _same(out, want[:b]), (name, depth, b, frames, on)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("layout", ["separate", "strided"])
def test_window_kernel_wide_passes_two_sources(layout, gpu):
    # U and V as two sources whose cut falls inside a pass of WIDE_FRAMES
    # frames (b0 13, 21: a CTA of source 0 ends mid-pass), at uint8 and
    # 10 bits, through the package's launches and each range on its own
    for pix_fmt, mx in (("yuv420p", 255), ("yuv420p10le", 1023)):
        cfg, iw, ih, ow, oh = WIDE_CASES["cubic-cubemap"]
        pp = P.build_plan(cfg, 2 * iw, 2 * ih, 2 * ow, 2 * oh, pix_fmt).chroma
        wt, ds = _wide_tables(pp, gpu), DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
        assert wt.groups[0][3] == window.WIDE_FRAMES
        g = torch.Generator(device=gpu).manual_seed(mx)
        lib, stream = window.KERNEL.library(), torch.cuda.current_stream().cuda_stream
        for b0, b1 in ((13, 16), (21, 19), (1, 16)):
            shape = (b0 + b1, pp.in_h, pp.in_w)
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device=gpu, generator=g) \
                if mx == 255 else _rand_u16(shape, mx, gpu, g)
            xs = _two_sources(x, b0, layout)
            want = _plain_in_chunks(pp, ds, x, mx)
            assert _same(window.remap_window_px(wt, xs, mx), want), (pix_fmt, b0, b1)
            for frames in (b0 + b1, 5, 16):
                out = torch.zeros((b0 + b1, wt.out_h, wt.out_w), dtype=pp.dtype, device=gpu)
                for group in wt.groups:
                    window.launch_class(lib, wt, xs, out, group, frames, group[3], stream, mx)
                assert _same(out, want), (pix_fmt, b0, b1, frames)


def test_replay_at_batch_8_keeps_one_node_per_window_class(gpu, monkeypatch):
    # the 2x2 supersampled 4K cubemap's class 0 is launched in two ranges
    # (its small windows WIDE_FRAMES frames a pass) on long batches; at
    # GRAPH_MAX_BATCH frames (8; 16 chroma planes, no more than
    # CTA_FRAMES_MIN) they go out as one launch: each plane's graph holds
    # one K3 node per window class present, as before class 0 was split,
    # a replay re-points the nodes that touch the caller's planes (K1's
    # and K4's, 4), and replays equal the eager program at 0 LSB
    assert pipeline.GRAPH_MAX_BATCH == 8
    eng = P.open_filter(K3_4K["ss2x2"], 3840, 2160, device=gpu)
    pipeline.clear_executor_cache()
    g = torch.Generator(device=gpu).manual_seed(8)
    sets = [[torch.randint(0, 256, (8, h, w), dtype=torch.uint8, device=gpu, generator=g)
             for h, w in ((2160, 3840), (1080, 1920), (1080, 1920))] for _ in range(3)]
    outs = [eng.transform(*sets[0])]  # eager, then captured
    want_nodes = 0
    for pp in (eng.plan.luma, eng.plan.chroma):
        wp = pp.window_plan()
        classes = len({int(c) for c in wp.tile_class if c >= 0})
        assert len(wp.groups) == classes + 1  # class 0 in two ranges
        (graph,) = pipeline.plane_executor(pp, gpu)._by_shape.values()
        assert dict(graph.launches)["window.launches"] == classes
        assert "window.tiles_wide" not in dict(graph.launches)
        want_nodes += len(graph.program.nodes)
    assert want_nodes == 4
    for k in (1, 2):
        n = COUNTERS["nodes.updates"]
        outs.append(eng.transform(*sets[k]))
        assert COUNTERS["nodes.updates"] - n == want_nodes
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", 0)  # the eager program
    for k in range(3):
        for a, w in zip(outs[k], eng.transform(*sets[k])):
            assert _same(a, w), k


@pytest.mark.parametrize("depth", [10, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_uint16_kernels_match_plain(name, depth, gpu):
    cfg, iw, ih, ow, oh = CASES[name]
    pix_fmt = f"yuv420p{depth}le"
    plan = P.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    mx = (1 << depth) - 1
    g = torch.Generator(device=gpu).manual_seed(depth)
    for pp in (plan.luma, plan.chroma):
        t = pp.tables(gpu)
        x = _rand_u16((5, pp.in_h, pp.in_w), mx, gpu, g)
        x[2] = mx  # a saturated frame
        n8 = (COUNTERS["blur.launches"], COUNTERS["window.launches"])
        if t.blur is not None:
            n = COUNTERS["blur.launches_u16"]
            got = blur.blur_px(t.blur, x, mx)
            torch.cuda.synchronize()
            assert COUNTERS["blur.launches_u16"] == n + 1 and got.dtype == torch.uint16
            want = round_px(blur_plain(t.blur.plan, x.float()), mx, torch.uint16)
            _assert_close(got, want, f"K1 u16 {name}")
        wt = pp.window_tables(gpu)
        assert wt.sample_bytes == 2
        n = COUNTERS["window.launches_u16"]
        got = window.remap_window_px(wt, x, mx)
        torch.cuda.synchronize()
        assert COUNTERS["window.launches_u16"] == n + len(window.launches(wt.groups, 5))
        assert got.dtype == torch.uint16
        assert (COUNTERS["blur.launches"], COUNTERS["window.launches"]) == n8  # no uint8 launch
        want = round_px(remap_plain(DeviceSpec.from_spec(pp.spec, pp.fill, gpu), x), mx,
                        torch.uint16)
        _assert_close(got, want, f"K3 u16 {name}")
        assert int(got.int().max()) <= mx


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("taps", sorted(INTERPS))
def test_uint16_window_kernel_every_instantiation(taps, mode, gpu):
    # as test_window_kernel_every_instantiation, on uint16 planes
    g = torch.Generator(device=gpu).manual_seed(taps)
    for layout, iw, ih, ow, oh in ((Layout.CUBEMAP_32, 512, 256, 150, 100),
                                   (Layout.BARREL, 256, 128, 160, 64)):
        cfg = TransformConfig(output_layout=layout, interpolation_alg=INTERPS[taps], **MONO)
        pp = P.build_plan(cfg, iw, ih, ow, oh, "gray16le").luma
        wp = window.build_window_plan(pp.spec, pp.fill, 2)
        wt = dataclasses.replace(window.WindowTables.from_plan(wp, gpu), mode=MODES[mode])
        x = _rand_u16((3, ih, iw), 65535, gpu, g)
        for b in (3, 1):
            got = window.remap_window_px(wt, x[:b], 65535)
            want = round_px(window.remap_window_plain(wt, x[:b]), 65535, torch.uint16)
            assert _same(got, want), (layout, b)


@pytest.mark.parametrize("name", ["cubic-cubemap", "linear-barrel", "lanczos4-barrel"])
def test_uint16_kernels_unaligned_plane(name, gpu):
    # a plane one sample past a 16-byte boundary: sample-wise loads, 2-byte stores
    cfg, iw, ih, ow, oh = CASES[name]
    pp = P.build_plan(cfg, iw, ih, ow, oh, "gray12le").luma
    g = torch.Generator(device=gpu).manual_seed(5)
    x = _rand_u16((2 * ih * iw + 1,), 4095, gpu, g)[1:].view(2, ih, iw)
    t = pp.tables(gpu)
    if t.blur is not None:
        want = round_px(blur_plain(t.blur.plan, x.float()), 4095, torch.uint16)
        assert _same(blur.blur_px(t.blur, x, 4095), want)
    got = window.remap_window_px(pp.window_tables(gpu), x, 4095)
    ds = DeviceSpec.from_spec(pp.spec, pp.fill, gpu)
    assert _same(got, round_px(remap_plain(ds, x), 4095, torch.uint16))


AREA_CASES = {  # INTER_AREA (K4): (scaled w, h), (out w, h)
    "2x2": ((384, 256), (192, 128)),
    "4x4": ((384, 512), (96, 128)),
    "1.5x2": ((72, 64), (48, 32)),
    "200x90": ((200, 90), (70, 40)),
    "upscale": ((48, 32), (96, 48)),
    "8x direct": ((1024, 64), (128, 8)),  # tiles read device memory directly
    # width not a multiple of the tile's or of 4, rows not 16-byte aligned
    "ragged 2x2": ((780, 520), (390, 260)),
}


def _area_input(b, sw, sh, depth, gpu, g):
    mx = (1 << depth) - 1
    if depth == 8:
        x = torch.randint(0, 256, (b, sh, sw), dtype=torch.uint8, device=gpu, generator=g)
    else:  # samples past the depth's maximum too: the sums saturate
        x = _rand_u16((b, sh, sw), 65535, gpu, g)
    x[0] = mx
    return x


@pytest.mark.parametrize("depth", [8, 10, 16])
@pytest.mark.parametrize("name", sorted(AREA_CASES))
def test_area_kernel_matches_plain(name, depth, gpu):
    (sw, sh), (ow, oh) = AREA_CASES[name]
    da = DeviceArea.from_tables(AreaTables.build(sw, sh, ow, oh), gpu)
    mx = (1 << depth) - 1
    g = torch.Generator(device=gpu).manual_seed(depth)
    for b in (1, 7, 256):
        x = _area_input(b, sw, sh, depth, gpu, g)
        n = (COUNTERS["area.launches"], COUNTERS["area.launches_u16"])
        got = area.area_px(da, x, mx)
        torch.cuda.synchronize()
        assert (COUNTERS["area.launches"], COUNTERS["area.launches_u16"]) == (
            n[0] + (depth == 8), n[1] + (depth > 8))
        assert got.dtype == x.dtype and tuple(got.shape) == (b, oh, ow)
        assert _same(got, area.area_plain(da, x, mx)), (name, depth, b)


@pytest.mark.parametrize("depth", [8, 12])
def test_area_kernel_unaligned_plane(depth, gpu):
    # a plane one sample past a 16-byte boundary: sample-wise staging
    (sw, sh), (ow, oh) = AREA_CASES["2x2"]
    da = DeviceArea.from_tables(AreaTables.build(sw, sh, ow, oh), gpu)
    g = torch.Generator(device=gpu).manual_seed(3)
    x = _area_input(3 * sh * sw + 1, 1, 1, depth, gpu, g)[1:].view(3, sh, sw)
    mx = (1 << depth) - 1
    assert _same(area.area_px(da, x, mx), area.area_plain(da, x, mx))


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("b", [1, 129])
def test_area_kernel_persistent_batches(b, depth, gpu):
    # the 2x2 flagship's luma: one frame (fewer items than resident CTAs)
    # and 129 frames (CTAs whose runs straddle tiles), every tile packed
    da = DeviceArea.from_tables(AreaTables.build(3072, 2048, 1536, 1024), gpu)
    assert bool((da.tiles[:, 7] == area.PACKED).all())
    mx = (1 << depth) - 1
    g = torch.Generator(device=gpu).manual_seed(b)
    x = _area_input(b, 3072, 2048, depth, gpu, g)
    got = area.area_px(da, x, mx)
    for f0 in range(0, b, 32):
        assert _same(got[f0:f0 + 32], area.area_plain(da, x[f0:f0 + 32], mx)), (b, depth, f0)


@pytest.mark.parametrize("name", ["2x2", "1.5x2", "ragged 2x2"])
def test_area_kernel_launch_variants(name, gpu):
    # every copy (TMA, cp.async, by every thread), ring depth, path, grid
    # -- one CTA walking all items through the ring, the persistent grid,
    # one CTA per item -- and walk of the items computes the same bytes
    (sw, sh), (ow, oh) = AREA_CASES[name]
    da = DeviceArea.from_tables(AreaTables.build(sw, sh, ow, oh), gpu)
    g = torch.Generator(device=gpu).manual_seed(11)
    x = _area_input(9, sw, sh, 8, gpu, g)
    want = area.area_plain(da, x)
    lib = area.KERNEL.library()
    stream = torch.cuda.current_stream().cuda_stream
    n_items = da.tiles.shape[0] * x.shape[0]
    copies = [area.COPY_SCALAR] + ([area.COPY_TMA, area.COPY_ASYNC]
                                   if area.copy_mode(da, x) == area.COPY_TMA else [])
    for copy in copies:
        for stages in (2, 3, 8):
            for packed in (True, False):
                for ctas in (1, 0, n_items):
                    for order in (0, 1):
                        out = torch.zeros_like(want)
                        area.launch(lib, da, x, out, stream, copy=copy, stages=stages,
                                    packed=packed, ctas=ctas, order=order)
                        torch.cuda.synchronize()
                        assert _same(out, want), (name, copy, stages, packed, ctas, order)


@pytest.mark.parametrize("opts, pix_fmt", [
    ("", "yuv420p10le"),
    ("", "gray16le"),
    (":width_scale_factor=2:height_scale_factor=2", "yuv420p"),
    (":width_scale_factor=1.5:height_scale_factor=2", "yuv444p12le"),
])
def test_deep_and_supersampled_engines_match_the_cpu_engine(opts, pix_fmt, gpu, tmp_path):
    base = "cube_edge_length=64:interpolation_alg=cubic:input_stereo_format=mono" + opts
    pf = P.config.get_pixel_format(pix_fmt)
    rng = np.random.default_rng(6)
    dt = np.uint8 if pf.depth == 8 else np.uint16
    cw, ch = P.chroma_dims(512, 256, pf)
    planes = [rng.integers(0, pf.maxval + 1, (9, 256, 512)).astype(dt)]
    planes += [rng.integers(0, pf.maxval + 1, (9, ch, cw)).astype(dt)
               for _ in range(pf.n_planes - 1)]
    eng = P.open_filter(base, 512, 256, pix_fmt=pix_fmt, device=gpu)
    cpu = P.open_filter(base, 512, 256, pix_fmt=pix_fmt, device="cpu")
    eng.save_plan(str(tmp_path / "p.npz"))
    loaded = P.Transform360(eng.config, pix_fmt=pix_fmt, device=gpu)
    loaded.load_plan(str(tmp_path / "p.npz"))
    n8 = (COUNTERS["blur.launches"], COUNTERS["window.launches"])
    n16 = (COUNTERS["blur.launches_u16"], COUNTERS["window.launches_u16"])
    na = (COUNTERS["area.launches"], COUNTERS["area.launches_u16"])
    got = eng.transform(*planes)
    again = loaded.transform(*planes)
    want = cpu.transform(*planes)
    torch.cuda.synchronize()
    if pf.depth > 8:
        assert (COUNTERS["blur.launches"], COUNTERS["window.launches"]) == n8
        assert COUNTERS["blur.launches_u16"] > n16[0] and COUNTERS["window.launches_u16"] > n16[1]
    if "scale" in opts:  # K4 for luma and the stacked chroma, in both engines
        assert (COUNTERS["area.launches"] - na[0], COUNTERS["area.launches_u16"] - na[1]) == (
            (4, 0) if pf.depth == 8 else (0, 4))
    got, again, want = ((o,) if isinstance(o, torch.Tensor) else o for o in (got, again, want))
    for a, b, c in zip(got, again, want):
        assert a.device.type == "cuda" and a.dtype == c.dtype
        assert _same(a, b)
        _assert_close(a.cpu(), c, f"engine {pix_fmt}{opts}")


def test_fidelity_gate_on_the_card(gpu):
    # the gate size against the committed oracle fixture, at batch 12 and
    # batch 1: K1 and K3 (uint8) only, every case at 50 dB and no more
    # than 0.1 dB under the JAX package's PSNR, and the CPU's result
    from transform360_tpu_torch import fidelity

    fx = fidelity.load_fixture()
    cpu = fidelity.bench_fidelity(device="cpu", batch=1)
    for batch in (12, 1):
        n = _k13_counts()
        res = fidelity.bench_fidelity(device=gpu, batch=batch)
        torch.cuda.synchronize()
        assert COUNTERS["blur.launches"] > n[0] and COUNTERS["window.launches"] > n[1]
        assert (COUNTERS["blur.launches_u16"], COUNTERS["window.launches_u16"]) == n[2:]
        assert res == cpu and res["worst_db"] >= 50.0
        dbs = dict(res["configs"], flagship=min(res[p] for p in "YUV"))
        for name, db in dbs.items():
            assert db >= fx.jax_db[name] - 0.1, (name, db, fx.jax_db[name])


class _FakeProc:
    def __init__(self, stdout=None, stdin=None):
        self.stdout, self.stdin = stdout, stdin

    def wait(self):
        return 0


class _Sink(io.BytesIO):
    def close(self):  # keep the payload readable after the wrapper closes
        pass


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv420p10le"])
def test_ffmpeg_wrapper_fake_pipes_on_the_card(pix_fmt, gpu, monkeypatch):
    # the drop-in wrapper with its decode and encode processes on
    # in-memory pipes: the encoded bytes equal the API's on the card
    from transform360_tpu_torch import ffmpeg as wrap
    from transform360_tpu_torch.utils import video

    vf = "cube_edge_length=64:interpolation_alg=cubic:input_stereo_format=mono"
    w, h, n = 512, 256, 5
    pf = P.config.get_pixel_format(pix_fmt)
    dt = np.uint8 if pf.depth == 8 else np.dtype("<u2")
    rng = np.random.default_rng(7)
    planes = [rng.integers(0, pf.maxval + 1, (n, h, w)).astype(dt)]
    planes += [rng.integers(0, pf.maxval + 1, (n, h // 2, w // 2)).astype(dt) for _ in range(2)]
    sink = _Sink()
    raw = b"".join(p[k].tobytes() for k in range(n) for p in planes)
    monkeypatch.setattr(wrap.subprocess, "Popen", lambda cmd, stdout=None, stdin=None: (
        _FakeProc(stdout=io.BytesIO(raw)) if stdout is not None else _FakeProc(stdin=sink)))
    monkeypatch.setattr(video, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(video, "_probe_ffmpeg", lambda path: (w, h, 30.0, pix_fmt))
    n8 = _k13_counts()
    assert wrap.main(["--t360-batch", "2", "-y", "-i", "in.mp4", "-vf", f"transform360={vf}",
                      "out.mp4"]) == 0
    launched = [a > b for a, b in zip(_k13_counts(), n8)]
    assert launched == ([True, True, False, False] if pf.depth == 8 else
                        [False, False, True, True])
    out = P.open_filter(vf, w, h, pix_fmt=pix_fmt, device=gpu).transform(*planes)
    out = [o.cpu().numpy().astype(dt) for o in out]
    assert sink.getvalue() == b"".join(p[k].tobytes() for k in range(n) for p in out)


# -- the plane executors: captured CUDA graphs (pipeline.plane_executor) --

EXEC_OPTS = ("cube_edge_length=64:interpolation_alg=cubic:enable_low_pass_filter=1:"
             "input_stereo_format=mono")


def _counts():
    return tuple(COUNTERS[f"{k}.launches{w}"] for k in ("blur", "window", "area")
                 for w in ("", "_u16"))


def _exec_planes(pf, b, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if pf.depth == 8 else np.uint16
    cw, ch = P.chroma_dims(512, 256, pf)
    return [rng.integers(0, pf.maxval + 1, (b, 256, 512)).astype(dt)] + [
        rng.integers(0, pf.maxval + 1, (b, ch, cw)).astype(dt) for _ in range(2)]


EXEC_PLANS = [
    ("", "yuv420p"),
    ("", "yuv420p10le"),
    (":width_scale_factor=2:height_scale_factor=2", "yuv420p"),  # K4 in the graph
]


@pytest.mark.parametrize("b", sorted({1, 2, 8, pipeline.GRAPH_MAX_BATCH}))
@pytest.mark.parametrize("opts, pix_fmt", EXEC_PLANS)
def test_executor_replay_equals_eager(opts, pix_fmt, b, gpu, monkeypatch):
    # the first call of a kind runs eagerly and captures; replays read the
    # caller's card planes where they lie (no copy: their graph keeps no
    # buffer of them, and the planes are never written), a numpy batch through the buffer its own
    # graph keeps, and each writes a fresh output
    pf = P.config.get_pixel_format(pix_fmt)
    plan = P.open_filter(EXEC_OPTS + opts, 512, 256, pix_fmt=pix_fmt, device=gpu).plan
    pipeline.clear_executor_cache()
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", max(pipeline.GRAPH_MAX_BATCH, b))
    host = [_exec_planes(pf, b, s) for s in (0, 1, 2)]
    dev = [[torch.from_numpy(p).to(gpu) for p in planes] for planes in host]
    kept = [[p.clone() for p in planes] for planes in dev]
    n0 = _counts()
    first = pipeline.transform_batch(plan, *dev[0])  # eager, then captured
    n1 = _counts()
    ex = pipeline.plane_executor(plan.luma, gpu)
    assert [type(g).__name__ for g in ex._by_shape.values()] == ["_Graph"]
    # (planes, index of their content): card planes, numpy planes (their
    # first call captures a graph of their own), numpy again, other card
    # planes on the first graph
    calls = [(dev[0], 0), (host[1], 1), (host[2], 2), (dev[2], 2)]
    replays = [pipeline.transform_batch(plan, *planes) for planes, _ in calls]
    n2 = _counts()
    torch.cuda.synchronize()
    assert [type(g).__name__ for g in ex._by_shape.values()] == ["_Graph"] * 2
    assert all(buf is None for buf in next(iter(ex._by_shape.values())).staged)
    assert all(_same(p, k) for planes, keep in zip(dev, kept) for p, k in zip(planes, keep))
    # the launch counters count each replay's kernels, as if they were launched eagerly
    assert [4 * (a - z) for a, z in zip(n1, n0)] == [c - a for c, a in zip(n2, n1)]
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", 0)  # the eager program
    eager = [pipeline.transform_batch(plan, *planes) for planes in dev]
    torch.cuda.synchronize()
    assert [4 * (c - a) for c, a in zip(_counts(), n2)] == [3 * (c - a) for c, a in zip(n2, n1)]
    for got, i in [(first, 0)] + [(r, i) for r, (_, i) in zip(replays, calls)]:
        for a, w in zip(got, eager[i]):
            assert a.device.type == "cuda" and a.dtype == w.dtype and _same(a, w)
    # a returned tensor never aliases a later call's output (each was
    # compared after the later calls were made)
    assert len({o.data_ptr() for out in [first] + replays for o in out}) == 15


def _yuv420p_views(b, seed, u_shift=0, pad=0, w=512, h=256):
    """``b`` wxh yuv420p frames on the card as views of one packed buffer
    (each frame Y, U, V and ``pad`` bytes), with U and V ``u_shift`` bytes
    past their place (1: a U base off 16 bytes)."""
    rng = np.random.default_rng(seed)
    n, nc = h * w, h * w // 4
    buf = torch.from_numpy(rng.integers(0, 256, (b, n + 2 * nc + 16 + pad),
                                        dtype=np.uint8)).to("cuda")
    u0 = n + u_shift
    return (buf[:, :n].unflatten(1, (h, w)),
            buf[:, u0:u0 + nc].unflatten(1, (h // 2, w // 2)),
            buf[:, u0 + nc:u0 + 2 * nc].unflatten(1, (h // 2, w // 2)))


@pytest.mark.parametrize("b", sorted({1, 2, pipeline.GRAPH_MAX_BATCH}))
@pytest.mark.parametrize("opts, w, h", [
    (EXEC_OPTS, 512, 256),
    (EXEC_OPTS + EXEC_PLANS[2][0], 512, 256),
    (EXEC_OPTS.replace("=64", "=256"), 2560, 1280),  # K1 stages aligned planes by TMA
])
def test_replay_reads_strided_views_where_they_lie(opts, w, h, b, gpu, monkeypatch):
    # planes as strided views of packed yuv420p frames: replayed where they
    # lie at 0 LSB against the eager program (K1's tensor maps encoded
    # anew for each replay's planes); a U base off 16 bytes (and V with
    # it) takes a capture of its own, as does a frame stride off 16 bytes;
    # the caller's planes are never written and no plane is copied
    plan = P.open_filter(opts, w, h, device=gpu).plan
    pipeline.clear_executor_cache()
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", max(pipeline.GRAPH_MAX_BATCH, b))
    chroma = pipeline.plane_executor(plan.chroma, gpu)
    layouts = [dict(), dict(), dict(u_shift=1), dict(u_shift=1)] + (
        [dict(pad=8), dict(pad=8)] if b > 1 else [])
    copies = COUNTERS["pipeline.plane_copies"]
    calls = []
    for i, layout in enumerate(layouts):
        planes = _yuv420p_views(b, i, w=w, h=h, **layout)
        kept = [p.clone() for p in planes]
        calls.append((planes, kept, pipeline.transform_batch(plan, *planes)))
        graphs = len(chroma._by_shape)
        assert graphs == (i + 2) // 2  # each layout's first call captures
    torch.cuda.synchronize()
    assert COUNTERS["pipeline.plane_copies"] == copies
    assert all(buf is None for g in chroma._by_shape.values() for buf in g.staged)
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", 0)
    for planes, kept, got in calls:
        assert all(_same(p, k) for p, k in zip(planes, kept))
        for a, w in zip(got, pipeline.transform_batch(plan, *planes)):
            assert _same(a, w)
    assert len({o.data_ptr() for _, _, out in calls for o in out}) == 3 * len(calls)


def test_a_failed_node_update_raises(gpu, monkeypatch):
    # a U base off 16 bytes forced past the key onto a graph captured on
    # aligned planes that K1 stages by TMA (rows wider than a staged row):
    # K1's update refuses TMA on it, the call raises, and no kernel runs in
    # its place
    opts = EXEC_OPTS.replace("=64", "=256")
    plan = P.open_filter(opts, 2560, 1280, device=gpu).plan
    pipeline.clear_executor_cache()
    real = pipeline.graph_key
    monkeypatch.setattr(pipeline, "graph_key", lambda *a: real(*a)[:4])
    aligned = _yuv420p_views(1, 0, w=2560, h=1280)
    pipeline.transform_batch(plan, *aligned)
    assert blur.copy_mode(plan.chroma.tables(gpu).blur, aligned[1:]) == blur.COPY_TMA
    off = _yuv420p_views(1, 1, u_shift=1, w=2560, h=1280)
    n = _counts()
    with pytest.raises(RuntimeError, match="blur kernel node update failed"):
        pipeline.plane_executor(plan.chroma, gpu)(off[1], off[2])
    torch.cuda.synchronize()
    assert _counts() == n
    monkeypatch.setattr(pipeline, "graph_key", real)
    got = pipeline.transform_batch(plan, *off)  # its own capture
    monkeypatch.setattr(pipeline, "GRAPH_MAX_BATCH", 0)
    assert all(_same(a, w) for a, w in zip(got, pipeline.transform_batch(plan, *off)))


def test_banded_frame_replays_one_graph_per_band_and_plane(gpu):
    from transform360_tpu_torch.parallel import latency

    pf = P.config.get_pixel_format("yuv420p")
    planes = [p[0] for p in _exec_planes(pf, 1, 2)]
    eng = P.open_filter(EXEC_OPTS, 512, 256, device=gpu)
    want = [o.cpu().numpy() for o in eng.transform(*planes)]
    latency.clear_band_caches()
    n0 = _counts()
    first = latency.transform_frame_banded(eng.plan, planes, devices=[gpu], n=3)
    n1 = _counts()
    again = latency.transform_frame_banded(eng.plan, planes, devices=[gpu], n=3)
    n2 = _counts()
    assert [c - a for c, a in zip(n1, n0)] == [c - a for c, a in zip(n2, n1)]
    assert n2[0] - n1[0] == 6  # K1 per band and plane batch
    # every band reads the frame where it lies on the card: its graphs
    # keep no buffer of it, and no replay copies it
    for band in latency.band_plans(eng.plan, 3):
        for pp in (band.luma, band.chroma):
            graphs = list(pipeline.plane_executor(pp, gpu)._by_shape.values())
            assert [type(g).__name__ for g in graphs] == ["_Graph"]
            assert all(buf is None for g in graphs for buf in g.staged)
    for got in (first, again):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    bands = latency.band_plans(eng.plan, 3)
    latency.clear_band_caches()
    assert not any(ex.pp is pp for band in bands for pp in (band.luma, band.chroma)
                   for ex in pipeline._EXEC_CACHE.values())


def test_engines_with_one_config_share_graphs(gpu):
    # engines that each build the plan anew replay the first one's graphs:
    # one executor per plane, and no device memory held for the others
    import gc

    from transform360_tpu_torch import pipeline
    from transform360_tpu_torch.plan import clear_plan_cache

    pf = P.config.get_pixel_format("yuv420p")
    planes = [torch.from_numpy(p).to(gpu) for p in _exec_planes(pf, 1, 7)]
    pipeline.clear_executor_cache()
    held, outs = [], []
    for _ in range(4):
        clear_plan_cache()
        eng = P.open_filter(EXEC_OPTS, 512, 256, device=gpu)
        outs.append(eng.transform(*planes))
        del eng
        clear_plan_cache()
        gc.collect()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
    assert len(pipeline._EXEC_CACHE) == 2
    # from the second engine on, each adds only its kept outputs (the
    # allocator rounds blocks up to 512 B)
    kept = sum(-(-o.nbytes // 512) * 512 for o in outs[0])
    assert held[2] - held[1] == held[3] - held[2] == kept
    assert all(_same(a, b) for out in outs[1:] for a, b in zip(out, outs[0]))


def test_executor_inside_an_outer_capture(gpu, monkeypatch):
    # a caller's own capture takes the program's kernels; the executor
    # starts no capture of its own and caches nothing for it
    from transform360_tpu_torch import pipeline

    pf = P.config.get_pixel_format("yuv420p")
    plan = P.open_filter(EXEC_OPTS, 512, 256, device=gpu).plan
    pipeline.device_put_plan(plan, gpu)
    ex = pipeline.plane_executor(plan.luma, gpu)
    for b in (1, 3):  # a shape with a graph of its own, and one seen only in the capture
        xs = [torch.from_numpy(p).to(gpu) for p in _exec_planes(pf, b, 5)]
        if b == 1:
            pipeline.transform_frame_planes(plan, xs)
        with monkeypatch.context() as m:
            m.setattr(pipeline, "GRAPH_MAX_BATCH", 0)
            want = pipeline.transform_frame_planes(plan, xs)
        shapes = dict(ex._by_shape)
        outer = torch.cuda.CUDAGraph()
        with torch.cuda.graph(outer):
            out = pipeline.transform_frame_planes(plan, xs)
        assert ex._by_shape == shapes
        outer.replay()
        torch.cuda.synchronize()
        assert all(_same(a, w) for a, w in zip(out, want))


def test_failed_capture_raises_and_never_runs_eagerly(gpu, monkeypatch):
    from transform360_tpu_torch import pipeline

    pf = P.config.get_pixel_format("yuv420p")
    plan = P.open_filter(EXEC_OPTS, 512, 256, device=gpu).plan
    pipeline.clear_executor_cache()
    real = pipeline._plane_program

    def unsafe(pp, x):  # synchronizes the device, which no capture may record
        out = real(pp, x)
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return out

    monkeypatch.setattr(pipeline, "_plane_program", unsafe)
    planes = [torch.from_numpy(p).to(gpu) for p in _exec_planes(pf, 2, 6)]
    for _ in range(2):  # no eager result in its place, and no graph kept
        n = _counts()
        with pytest.raises(RuntimeError, match="CUDA graph"):
            pipeline.transform_batch(plan, *planes)
        torch.cuda.synchronize()
        # only the luma warm-up ran: K1 once and K3 once per luma launch
        assert COUNTERS["blur.launches"] - n[0] == 1
        assert COUNTERS["window.launches"] - n[2] == len(
            window.launches(plan.luma.window_tables(gpu).groups, 2))
        assert not pipeline.plane_executor(plan.luma, gpu)._by_shape
    monkeypatch.setattr(pipeline, "_plane_program", real)
    got = pipeline.transform_batch(plan, *planes)  # the device is still usable
    assert all(o.shape[0] == 2 for o in got)


def test_spans_hold_the_launches_cupti_traces(gpu, tmp_path):
    # the program's spans and CUPTI's runtime events share the profiler's
    # clock: in a trace of one-frame calls (graph replays on two frames in
    # turn, each output kept) every cudaGraphLaunch lies inside a
    # t360.executor.replay span, and in an eager batch every K1 and K3
    # kernel's launch (its host event, by correlation) inside its wrapper's
    # t360.k1.launch or t360.k3.launch
    from transform360_tpu_torch.utils.profiling import device_trace, traced

    pf = P.config.get_pixel_format("yuv420p")
    eng = P.open_filter(EXEC_OPTS, 512, 256, device=gpu)
    frames = [[torch.from_numpy(p[0]).to(gpu) for p in _exec_planes(pf, 1, s)] for s in (0, 1)]
    batch = [torch.from_numpy(p).to(gpu) for p in _exec_planes(pf, 16, 2)]
    kept = [eng.transform(*frames[0]), eng.transform(*frames[1]), eng.transform(*batch)]
    torch.cuda.synchronize()

    def within(t, spans):
        return any(a <= t <= b for a, b in spans)

    with device_trace(str(tmp_path / "live")) as path:
        for k in range(6):
            kept[k % 2] = eng.transform(*frames[k % 2])
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    replay = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "t360.executor.replay"]
    launches = [e["ts"] for e in events if e["name"] == "cudaGraphLaunch"]
    assert len(replay) == 12 and len(launches) == 12
    assert all(within(t, replay) for t in launches)
    assert [s.name for s in traced().spans].count("t360.executor.replay") == 12

    with device_trace(str(tmp_path / "batch")) as path:
        kept[2] = eng.transform(*batch)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    wrappers = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e["name"] in ("t360.k1.launch", "t360.k3.launch")]
    host = {e["args"]["correlation"]: e["ts"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")
            and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and ("blur" in e["name"] or "window_kernel" in e["name"])]
    groups = sum(len(window.launches(pp.window_tables(gpu).groups, *b))
                 for pp, b in ((eng.plan.luma, (16,)), (eng.plan.chroma, (32, 16))))
    assert len(wrappers) == 4 and len(kernels) == 2 + groups
    assert all(within(host[k["args"]["correlation"]], wrappers) for k in kernels)
