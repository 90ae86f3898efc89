"""Window-gather remap: the tile plan, the CUDA kernel K3
(``csrc/window.cu``) and, for a tensor on the CPU, its plain version.

K3 computes the function of :func:`..sampling.remap_plain` (the remap
with its half-up round) at every batch size, on uint8 planes and on
uint16 planes (deep formats, rounded and saturated to the depth's
maximum): one CTA of 256 threads per ``TH x TW`` output tile, one pixel
per thread, stages the tile's source window into shared memory frame by
frame and samples every tap from there.

Plan time (numpy, vectorized): :func:`build_window_plan` cuts the output
into tiles and gives each its source window -- origin, height, row
pitch, in samples -- and a class by the window's bytes (``CLASS_BYTES``:
one kernel launch per class, with that class's shared memory; a uint16
window takes twice the bytes of a uint8 one).  Where nearly all of class
0's windows are small (``SMALL_SHARE`` of them at most ``SMALL_BYTES``),
it is launched in two ranges: the small windows take ``WIDE_FRAMES``
frames a pass, the rest two; else class 0 takes two, and the larger
class one.  Tiles whose window exceeds the largest class are flagged
(pitch 0) and gather straight from device memory inside the same
kernel.  Per pixel the plan keeps the
window-relative first tap ``ly``/``lx`` (packed in one int32) and the
1/32 fraction indices ``fy``/``fx`` (one byte each; bit 7 of ``fy``
marks a pixel outside the transparent ``valid`` mask): 6 B per pixel.
Weights come from the float32 table ``wtab`` (:func:`..sampling.weight_table`,
row ``fy * 32 + fx``): ``float32(w1[fy, ty] * w1[fx, tx])`` of the float64
taps.

:func:`remap_window_px` takes a plane batch as one or two sources
(:mod:`.sources`), read where they lie: K3 reads the U and V planes of a
plan without a prefilter from their own bases, its frame groups cut where
the second source starts, so that each CTA reads one source.  For
CUDA tensors it launches the kernel (:func:`launches`: the plan's
launches, class 0's two ranges as one at two frames a pass on batches
of ``CTA_FRAMES_MIN`` frames or fewer) or raises; it never falls
back, and never copies a source.  :mod:`.nodes` binds, launches,
records and re-points the kernel (``KERNEL``).  The counters ``window.launches`` and
``window.launches_u16`` (:data:`..utils.profiling.COUNTERS`) count the
uint8 and the uint16 instantiations' launches, ``window.tiles`` and
``window.tiles_u16`` their tiles, and ``window.tiles_wide`` and
``window.tiles_wide_u16`` the tiles of those that take more than two
frames a pass; the span ``t360.k3.launch`` times :func:`remap_window_px`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..sampling import (
    BORDER_FILL,
    BORDER_WRAP,
    INTER_TAB_SIZE,
    SampleSpec,
    _TAPS,
    _resolve,
    as_gatherable,
    border_mode,
    frac_index,
    round_px,
    weight_table,
)
from ..utils.profiling import count, span
from . import nodes, sources
from .sources import Planes

# Output tile (rows, columns): one CTA of 256 threads, a pixel each.  2 or
# 4 pixels per thread (more weight registers, fewer CTAs per SM) measured
# slower at every batch size.  So did turning each staged sample into a
# float once per frame for the tile's taps to share, even on the 2x2
# supersampled cubemap's small windows (3.6 samples a pixel): 9-26% slower
# at uint8 (PERF.md §6), the shared-memory pipe being the tighter limit.
TH, TW = 16, 16
VEC = 16  # window rows are staged in 16-byte chunks from a 16-byte-aligned column
# Window bytes (height x pitch) of each class, one frame.  Class 0 (12 KB)
# holds nearly every tile with four CTAs per SM; 64 KB takes the pole
# tiles of a 4K cubemap off the global path.
CLASS_BYTES = (12 * 1024, 64 * 1024)
# Class 0's windows of at most SMALL_BYTES are staged WIDE_FRAMES frames a
# pass (two passes and the chunk table, 49.9 KB, keep four CTAs on an SM),
# each pass's copies dealt over all of a CTA's threads, where they are
# SMALL_SHARE of class 0's tiles or more; the rest of class 0 takes two
# frames a pass, in a launch of its own, the larger class one.  83.5% of
# the 2x2 supersampled cubemap's luma tiles have windows of 1 KB or less,
# 44 chunks a frame, whose copies a chunk-per-thread walk left to the
# first warp or two; 98.3% have 3 KB or less, and K3 runs 4% faster (the
# 2 and 6 KB budgets and 4 frames a pass measured slower; PERF.md §6).  The
# 4K cubemap's windows are larger (86.7% of 3 KB or less): its split
# launch measured no faster on the small windows and 3-5% slower on the
# rest (another launch's tail, and its frames cut in more groups).
SMALL_BYTES = 3 * 1024
WIDE_FRAMES = 8
SMALL_SHARE = 15 / 16
# A CTA's dynamic shared memory (smem_bytes) is at most SMEM_MAX, the
# most one CTA may use on Hopper.
SMEM_MAX = 227 * 1024
# A CTA takes at least CTA_FRAMES_MIN frames of the batch (its set-up, the
# chunk table and the weights, costs about as much as a frame), and the
# batch is split among CTAs only while the launch has fewer than
# CTAS_TARGET of them.
CTA_FRAMES_MIN = 16
CTAS_TARGET = 2048
MAX_LX = (1 << 15) - 1  # lx is packed in the high half of an int32

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def frames_per_cta(B: int, n_tiles: int) -> int:
    """Frames one CTA of a launch of ``n_tiles`` tiles loops over: the
    batch split into the fewest groups that reach ``CTAS_TARGET`` CTAs,
    none under ``CTA_FRAMES_MIN`` frames, and no more than 65535 groups."""
    groups = max(1, min(B // CTA_FRAMES_MIN, -(-CTAS_TARGET // n_tiles)))
    return max(-(-B // groups), -(-B // 65535))


def smem_bytes(win_bytes: int, pass_frames: int) -> int:
    """A CTA's dynamic shared memory for windows of ``win_bytes``: two
    passes' windows (double buffer) of ``pass_frames`` frames, and a
    4-byte chunk-table entry per 16 bytes of window."""
    return 2 * pass_frames * win_bytes + win_bytes // 4


def launches(groups, B: int, longest: int = 0) -> list:
    """The launches of a batch of ``B`` frames over a plan's ``groups``,
    ``longest`` of them (default: all) in its longest source:
    ``(first tile, tiles, window bytes, frames a pass, frames per CTA)``
    each.  Where the longest source holds no more than ``CTA_FRAMES_MIN``
    frames (a replayed graph's 8 frames, and the 16 planes of their
    chroma; a live frame), a group of more than two frames a pass goes out
    with the group after it (class 0's other range, where there is one)
    as one launch at two frames a pass over both, with the larger window:
    the launches of a short batch are the same in number whatever the
    windows.  Above it, a CTA walks at least ``CTA_FRAMES_MIN`` frames of
    one source (``frames_per_cta``), unless its source is shorter."""
    out, i = [], 0
    while i < len(groups):
        first, tiles, win, fp = groups[i]
        i += 1
        if fp > 2 and (longest or B) <= CTA_FRAMES_MIN:
            fp = 2
            if i < len(groups) and groups[i][3] == 2:
                tiles, win = tiles + groups[i][1], max(win, groups[i][2])
                i += 1
        out.append((first, tiles, win, fp, frames_per_cta(B, tiles)))
    return out


def _circular_origin_rows(vals: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise narrowest arc covering ``[m, k]`` ints on a ring of size n:
    its origin and extent per row.  The origin is the value after the
    largest gap, or the smallest value when the wrap-around gap is the
    largest (ties keep the first maximal gap), as in the JAX package's
    ``ops/remap_lane._circular_origin_rows``."""
    s = np.sort(vals, axis=1)
    gaps = np.diff(s, axis=1)
    wrap_gap = s[:, 0] + n - s[:, -1]
    k = np.argmax(gaps, axis=1)
    rows = np.arange(len(s))
    use_gap = gaps[rows, k] > wrap_gap
    after = s[rows, k + 1]
    origin = np.where(use_gap, after, s[:, 0])
    extent = np.where(use_gap, s[rows, k] + n - after + 1, s[:, -1] - s[:, 0] + 1)
    return origin, extent


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Host (numpy) tile plan of one plane class; tiles are stored in
    launch order (see ``groups``)."""

    meta: np.ndarray  # int32 [n, 6]: out row, out col, y0, x0, wh, pitch (0: global); samples
    tile_class: np.ndarray  # int8 [n]: class index, or -1 for a global-path tile
    pos: np.ndarray  # int32 [n * TH * TW]: ly | lx << 16
    fy: np.ndarray  # uint8 [n * TH * TW]: fy | (not valid) << 7
    fx: np.ndarray  # uint8 [n * TH * TW]
    wtab: np.ndarray  # float32 [32 * 32, T * T]: sampling.weight_table
    # launches: (first tile, tiles, window bytes, frames a pass)
    groups: Tuple[Tuple[int, int, int, int], ...]
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    taps: int
    mode: int
    fill: float
    sample_bytes: int  # 1: uint8 planes, 2: uint16


def build_window_plan(spec: SampleSpec, fill: float, sample_bytes: int = 1,
                      small: Tuple[int, int, float] = (SMALL_BYTES, WIDE_FRAMES, SMALL_SHARE)
                      ) -> WindowPlan:
    """The tile plan of a sample spec for samples of ``sample_bytes`` (the
    Hopper counterpart of the JAX package's ``build_pallas_remap``, sized
    for shared memory).  Offsets and pitches are in samples; a window's
    size, which picks its class, is in bytes.  ``small``: class 0's
    windows of at most ``small[0]`` bytes take ``small[1]`` frames a pass
    where they are at least a share ``small[2]`` of its tiles (other
    values for measurements)."""
    if sample_bytes not in (1, 2):
        raise ValueError(f"samples of {sample_bytes} bytes: 1 (uint8) or 2 (uint16)")
    T = _TAPS[spec.interp]
    H, W = spec.in_h, spec.in_w
    mode = border_mode(spec)
    out_h, out_w = spec.base_y.shape
    cs = VEC // sample_bytes  # samples per 16-byte chunk
    spw = 4 // sample_bytes  # samples per 32-bit word
    if H + T >= 1 << 16 or W + T + cs > MAX_LX:
        raise ValueError(f"input {W}x{H} is too large for the window plan's 16-bit offsets")
    n_ty, n_tx = -(-out_h // TH), -(-out_w // TW)
    n = n_ty * n_tx

    def tiles(a):
        """[out_h, out_w] -> [n, TH*TW], ragged edge padded by replication."""
        a = np.pad(a, ((0, n_ty * TH - out_h), (0, n_tx * TW - out_w)), mode="edge")
        return a.reshape(n_ty, TH, n_tx, TW).transpose(0, 2, 1, 3).reshape(n, TH * TW)

    by = tiles(spec.base_y.astype(np.int64))
    bx = tiles(spec.base_x.astype(np.int64))
    if mode == BORDER_WRAP:
        y0, ey = _circular_origin_rows(by, H)
        x0, ex = _circular_origin_rows(bx, W)
        ly = np.mod(by - y0[:, None], H)
        lxs = np.mod(bx - x0[:, None], W)
    else:
        # transparent layouts: bases lie in [-(T-1), n-1] and never wrap.
        # Pixels outside the valid mask take the fill whatever they read,
        # so the window covers the valid ones and the others read its
        # first byte.
        ok = np.ones(by.shape, bool) if spec.valid is None else tiles(spec.valid)
        any_ok = ok.any(axis=1)
        big = np.iinfo(np.int64).max

        def span(b):
            lo = np.where(any_ok, np.where(ok, b, big).min(axis=1), 0)
            hi = np.where(any_ok, np.where(ok, b, -big).max(axis=1), 0)
            return lo, hi - lo + 1, np.where(ok, b - lo[:, None], 0)

        y0, ey, ly = span(by)
        x0, ex, lxs = span(bx)
    wh = ey + T - 1
    x0a = np.floor_divide(x0, cs) * cs  # 16-byte-aligned origin: vector loads
    lx = lxs + (x0 - x0a)[:, None]
    pitch = -(-(x0 - x0a + ex + T - 1) // cs) * cs
    nbytes = wh * pitch * sample_bytes
    cls = np.full(n, -1, np.int8)
    for c in range(len(CLASS_BYTES) - 1, -1, -1):
        cls[nbytes <= CLASS_BYTES[c]] = c
    glob = cls < 0
    # The kernel reads a tap row as the aligned 32-bit words from the one
    # holding its first tap to the one holding its last: they end inside
    # the window, so no load leaves the CTA's buffer.
    end = (ly + T - 1) * pitch[:, None] + spw * ((lx + T - 1) // spw) + spw
    if not (end <= (wh * pitch)[:, None])[~glob].all():
        raise AssertionError("a tap row's words reach past its window")
    pitch = np.where(glob, 0, pitch)

    # launch order: class 0's small windows (``small``), its others, then
    # each larger class, each a range of tiles in raster order launched
    # with its own frames a pass; the global-path tiles lead class 0's
    # first range (the longest CTAs start early)
    wide = (cls == 0) & (nbytes <= small[0])
    if not wide.any() or wide.sum() < small[2] * (cls == 0).sum():
        wide[:] = False
    ranges = [[np.flatnonzero(wide), small[1]], [np.flatnonzero((cls == 0) & ~wide), 2]]
    ranges += [[np.flatnonzero(cls == c), 1] for c in range(1, len(CLASS_BYTES))]
    lead = 0 if ranges[0][0].size else 1
    ranges[lead][0] = np.concatenate([np.flatnonzero(glob), ranges[lead][0]])
    order, groups, start = [], [], 0
    for ids, fp in ranges:
        if ids.size:
            win = int(nbytes[ids][~glob[ids]].max(initial=0))
            if smem_bytes(win, fp) > SMEM_MAX:
                raise ValueError(f"window class of {win} B exceeds a CTA's shared memory")
            groups.append((start, int(ids.size), win, fp))
            order.append(ids)
            start += ids.size
    order = np.concatenate(order)

    ti, tj = np.divmod(np.arange(n), n_tx)
    meta = np.stack([ti * TH, tj * TW, y0, x0a, wh, pitch], axis=1)[order]
    fy = frac_index(spec.frac_y)
    if spec.valid is not None:
        fy = fy | ((~spec.valid).astype(np.uint8) << 7)
    return WindowPlan(
        meta=np.ascontiguousarray(meta, np.int32),
        tile_class=cls[order],
        pos=np.ascontiguousarray((ly | (lx << 16))[order].reshape(-1), np.int32),
        fy=np.ascontiguousarray(tiles(fy)[order].reshape(-1)),
        fx=np.ascontiguousarray(tiles(frac_index(spec.frac_x))[order].reshape(-1)),
        wtab=weight_table(spec.interp),
        groups=tuple(groups),
        in_h=H,
        in_w=W,
        out_h=out_h,
        out_w=out_w,
        taps=T,
        mode=mode,
        fill=float(fill),
        sample_bytes=sample_bytes,
    )


@dataclasses.dataclass(frozen=True)
class WindowTables:
    """A window plan's arrays on one device, in the kernel's form."""

    meta: torch.Tensor  # int32 [n, 6]
    pos: torch.Tensor  # int32 [n * TH * TW]
    fy: torch.Tensor  # uint8 [n * TH * TW]
    fx: torch.Tensor  # uint8 [n * TH * TW]
    wtab: torch.Tensor  # float32 [32 * 32, T * T]
    groups: Tuple[Tuple[int, int, int], ...]
    in_h: int
    in_w: int
    out_h: int
    out_w: int
    taps: int
    mode: int
    fill: float
    sample_bytes: int

    @property
    def dtype(self) -> torch.dtype:
        return torch.uint8 if self.sample_bytes == 1 else torch.uint16

    @classmethod
    def from_plan(cls, wp: WindowPlan, device) -> "WindowTables":
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            meta=put(wp.meta), pos=put(wp.pos), fy=put(wp.fy), fx=put(wp.fx),
            wtab=put(wp.wtab), groups=wp.groups, in_h=wp.in_h, in_w=wp.in_w,
            out_h=wp.out_h, out_w=wp.out_w, taps=wp.taps, mode=wp.mode, fill=wp.fill,
            sample_bytes=wp.sample_bytes,
        )


def remap_window_plain(wt: WindowTables, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: uint8 or uint16 ``[B, in_h, in_w]`` → float32
    ``[B, out_h, out_w]`` (before rounding), walking the tile plan as the
    kernel does.  A tap at window offset (i, j) of a tile reads source
    pixel (y0 + i, x0 + j) under the loader's border rule; its weight is
    the table's ``float32(w1[fy, ty] * w1[fx, tx])``; the sum runs ty-major and
    tx-minor, the fill term is added last, then the ``valid`` mask --
    the order of :func:`..sampling.remap_plain`, which it equals exactly."""
    B = x.shape[0]
    H, W, T, mode = wt.in_h, wt.in_w, wt.taps, wt.mode
    flat = as_gatherable(x).reshape(B, H * W)
    meta = wt.meta.long()
    npx = TH * TW
    tile = torch.arange(meta.shape[0], device=x.device).repeat_interleave(npx)
    p = torch.arange(npx, device=x.device).repeat(meta.shape[0])
    pos = wt.pos.long()
    ay = meta[tile, 2] + (pos & 0xFFFF)  # source row of the first tap
    ax = meta[tile, 3] + (pos >> 16)  # source column of the first tap
    fy = wt.fy.long()
    fx = wt.fx.long()
    invalid = (fy & 0x80) != 0
    fy = fy & 0x7F
    acc = None
    fill_w = None
    for ty in range(T):
        yy = ay + ty
        row = _resolve(yy, H, mode) * W
        for tx in range(T):
            xx = ax + tx
            g = flat[:, row + _resolve(xx, W, mode)].float()
            if T == 1:
                term = g
            else:
                w = wt.wtab[fy * INTER_TAB_SIZE + fx, ty * T + tx]
                if mode == BORDER_FILL:  # on absolute coordinates
                    outside = (yy < 0) | (yy >= H) | (xx < 0) | (xx >= W)
                    ow = torch.where(outside, w, 0.0)
                    fill_w = ow if fill_w is None else fill_w + ow
                    w = torch.where(outside, 0.0, w)
                term = w[None, :] * g
            acc = term if acc is None else acc + term
    if fill_w is not None:
        acc = acc + (fill_w * wt.fill)[None, :]
    acc = torch.where(invalid[None, :], wt.fill, acc)
    oy = meta[tile, 0] + torch.div(p, TW, rounding_mode="floor")
    ox = meta[tile, 1] + p % TW
    inside = (oy < wt.out_h) & (ox < wt.out_w)
    out = torch.empty((B, wt.out_h * wt.out_w), dtype=torch.float32, device=x.device)
    out[:, (oy * wt.out_w + ox)[inside]] = acc[:, inside]
    return out.reshape(B, wt.out_h, wt.out_w)


class WindowCall(nodes.PlaneCall):
    """The arguments of a launch of K3 and of a graph node's update, as
    ``csrc/window.cu``'s ``WindowCall`` lays them out past the pointers."""

    _fields_ = [
        ("sample_bytes", _c_int), ("maxval", ctypes.c_float),  # largest sample
        ("B", _c_int), ("H", _c_int), ("W", _c_int), ("out_h", _c_int), ("out_w", _c_int),
        ("meta", _c_void_p), ("pos", _c_void_p), ("fy", _c_void_p), ("fx", _c_void_p),
        ("wtab", _c_void_p),
        ("first", _c_int), ("tiles", _c_int), ("win_bytes", _c_int),  # the class's tiles
        ("taps", _c_int), ("mode", _c_int), ("fill", ctypes.c_float), ("vec", _c_int),
        ("frames", _c_int), ("pass_frames", _c_int),  # frames per CTA, per pass
    ]


KERNEL = nodes.Kernel("window", WindowCall, 5, 4, "remap")


def launch_class(lib: ctypes.CDLL, wt: WindowTables, x: Planes, out: torch.Tensor,
                 group: Tuple[int, ...], frames: int, pass_frames: int, stream: int,
                 maxval: int = 255, src: tuple = None) -> None:
    """One launch of K3 from ``lib`` over the tiles of ``group`` (first
    tile, tiles, window bytes, ...) of ``wt``: up to ``frames`` frames of
    one source of ``x`` (described by ``src``, or here) per CTA (the
    groups cut where source 1 starts), ``pass_frames`` (1, or even up to
    8) a pass, into ``out`` (stacked) on the CUDA stream ``stream``;
    uint16 samples round and saturate to ``maxval``.  Raises if the
    launch fails."""
    src = src or sources.describe(sources.as_sources(x))
    first, tiles, win = group[:3]
    call = WindowCall(
        sample_bytes=wt.sample_bytes, maxval=float(maxval),
        B=sum(s.frames for s in src), H=wt.in_h, W=wt.in_w, out_h=wt.out_h, out_w=wt.out_w,
        meta=wt.meta.data_ptr(), pos=wt.pos.data_ptr(), fy=wt.fy.data_ptr(),
        fx=wt.fx.data_ptr(), wtab=wt.wtab.data_ptr(),
        first=first, tiles=tiles, win_bytes=win, taps=wt.taps, mode=wt.mode, fill=wt.fill,
        vec=int(wt.in_w * wt.sample_bytes % VEC == 0 and all(s.aligned for s in src)),
        frames=frames, pass_frames=pass_frames)
    KERNEL.launch(lib, call, src, out.data_ptr(), stream)


def remap_window_px(wt: WindowTables, x: Planes, maxval: int = 255) -> torch.Tensor:
    """Remap + half-up round through the tile plan: ``[B, in_h, in_w]``
    samples, or one or two sources (:mod:`.sources`) read where they lie
    → ``[B, out_h, out_w]`` (the sources' frames stacked) of the same
    dtype on their device: uint8 (saturated at 255), or uint16 saturated
    at ``maxval`` (the depth's largest sample, 1023 at 10 bits).  Any
    batch size is accepted."""
    with span("k3.launch"):
        xs, src = sources.check_sources(x, wt.in_h, wt.in_w, wt.dtype, wt.meta.device, "remap")
        return KERNEL.run(
            xs[0].device, wt.sample_bytes, maxval, (sources.frames(xs), wt.out_h, wt.out_w),
            wt.dtype,
            lambda: round_px(remap_window_plain(wt, sources.stacked(xs)), maxval, wt.dtype),
            lambda lib, out, stream: _launch_plan(lib, wt, src, out, stream, maxval))


def _launch_plan(lib: ctypes.CDLL, wt: WindowTables, src: tuple, out: torch.Tensor,
                 stream: int, maxval: int) -> None:
    """Every launch of K3 (:func:`launches`) on the described sources
    ``src`` into ``out``, each counted: ``window.launches``, its tiles in
    ``window.tiles`` and, where it takes more than two frames a pass, in
    ``window.tiles_wide`` (``_u16`` for uint16 samples)."""
    u16 = "" if wt.sample_bytes == 1 else "_u16"
    counts = [s.frames for s in src]
    for first, tiles, win, fp, frames in launches(wt.groups, sum(counts), max(counts)):
        launch_class(lib, wt, None, out, (first, tiles, win), frames, fp, stream, maxval, src)
        count("window.launches" + u16)
        count("window.tiles" + u16, tiles)
        if fp > 2:
            count("window.tiles_wide" + u16, tiles)


def kernel_attrs(taps: int, mode: int, win_bytes: int, pass_frames: int,
                 sample_bytes: int = 1) -> dict:
    """One instantiation of K3 on the current GPU: its registers, local
    memory bytes (spills and stack), resident CTAs per SM for a launch with
    ``win_bytes`` of window and ``pass_frames`` frames a pass, and that
    launch's dynamic shared memory."""
    return KERNEL.attrs(None, sample_bytes, taps, mode, win_bytes, pass_frames)


def row_costs(wp: WindowPlan) -> np.ndarray:
    """[wp.out_h] modelled cost of each output row of the plan: each tile
    weighs the window bytes its launch stages per frame at one frame (its
    class's largest: class 0's two ranges go out as one launch there; a
    global-path tile, whose window exceeds the largest class, weighs the
    largest class), spread evenly over its rows."""
    win = {c: CLASS_BYTES[c] for c in range(len(CLASS_BYTES))}
    launched = {}  # a class's largest launch window (class 0 has two launches)
    for first, n, nbytes, _ in wp.groups:
        c = int(wp.tile_class[first + n - 1])
        if c >= 0:
            launched[c] = max(launched.get(c, 0), nbytes)
    win.update(launched)
    cost = np.array([win[c] if c >= 0 else CLASS_BYTES[-1] for c in wp.tile_class.tolist()],
                    np.float64)
    per_tile_row = np.bincount(wp.meta[:, 0] // TH, weights=cost, minlength=-(-wp.out_h // TH))
    return np.repeat(per_tile_row / TH, TH)[: wp.out_h]
