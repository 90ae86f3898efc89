"""INTER_AREA resize + half-up round: the tile plan, the CUDA kernel K4
(``csrc/area.cu``) and, for a tensor on the CPU, its plain version.

K4 computes :func:`area_plain`, ``round_px(area_resize(da, x), maxval,
dtype)``, bit for bit, on uint8 planes and on uint16 planes (deep
formats, saturated at the depth's maximum): the epilogue of a
supersampled plane, from the scaled size to the output size.  It is
bound by bytes; the kernel's header says how its design keeps them in
flight (persistent CTAs, a ring of stages filled by TMA, packed taps).

Plan time (numpy, vectorized, once per plan and device in
:meth:`..sampling.DeviceArea.from_tables`): :func:`build_area_tiles` cuts
the output into ``TR x TC`` tiles and gives each the span of input rows
and columns its taps read (clamped padding taps included), from a column
aligned down to ``ALIGN`` samples, so that one plan serves both sample
sizes, and a mode.  A tile is staged through the kernel's ring when the
plan has at most ``MAX_TAPS`` taps per axis (the kernel holds them in
registers: :func:`taps` picks its instantiation) and two ring stages fit
``SMEM_BUDGET`` at uint16; a staged tile is packed when every output
column's taps are ``K`` consecutive samples with one weight (whole-number
factors); any other tile is direct and reads device memory inside the
same kernel.  One stage layout serves the plan: ``box`` = (width, rows,
count) of the TMA boxes that hold the widest and tallest span.

Launch time: the grid is persistent (:func:`grid_ctas`: the CTAs resident
on every SM, at most one per item) and each CTA walks its share of the
(tile, frame) items (:func:`work_list`, :func:`walk_order`), each tile's
frames in order.  A plane whose rows and base are
16-byte aligned is staged by TMA, any other by every thread of the CTA
with plain loads (``COPY_SCALAR``): the shape chooses, never a failure.

For a CUDA tensor :func:`area_px` launches the kernel or raises; it never
falls back.  :mod:`.nodes` binds, launches, records and re-points the
kernel (``KERNEL``).  The counters ``area.launches`` and ``area.launches_u16``
(:data:`..utils.profiling.COUNTERS`) count the uint8 and the uint16
instantiations' launches (one per call on a CUDA tensor); the span
``t360.k4.launch`` times :func:`area_px`.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from ..sampling import AreaAxis, AreaTables, DeviceArea, area_resize, round_px
from ..utils.profiling import span
from . import nodes, sources
from .nodes import grid_ctas

TR, TC = 8, 128  # output tile: a warp per row, 4 columns per thread
ALIGN = 16  # span origin, in samples: whole 16-byte chunks at either size
BOX_MAX = 256  # samples or rows in one dimension of a TMA box
SMEM_BUDGET = 96 * 1024  # two ring stages at uint16 fit in it
MAX_TAPS = 4  # taps per axis that the staged path holds in registers
RING = 4  # ring stages a launch takes, as SMEM_BUDGET allows
DIRECT, STAGED, PACKED = 0, 1, 2  # a tile's mode, its row's last entry
COPY_TMA, COPY_ASYNC, COPY_SCALAR = 0, 1, 2  # how a stage is filled

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def taps(kr: int, kc: int) -> int:
    """K4's instantiation for ``kr`` row and ``kc`` column taps: 2 or 4
    register taps per axis (its staged tiles need kr, kc <= 4)."""
    return 2 if max(kr, kc) <= 2 else 4


def stage_bytes(box: Tuple[int, int, int], sample_bytes: int) -> int:
    """One ring stage: ``box`` = (width, rows, count) boxes of samples,
    rounded up to 128 bytes (TMA's alignment); 0 with no staged tile."""
    w, h, n = box
    return -(-w * h * n * sample_bytes // 128) * 128


def ring_stages(da: DeviceArea, sample_bytes: int) -> int:
    """The stages of a launch's ring: ``RING`` or as many as
    ``SMEM_BUDGET`` holds, and at least 2."""
    sb = stage_bytes(da.box, sample_bytes)
    return max(2, min(RING, SMEM_BUDGET // sb)) if sb else 2


def smem_bytes(da: DeviceArea, sample_bytes: int, stages: int = 0) -> int:
    """A launch's dynamic shared memory: its ring (``stages`` or
    :func:`ring_stages`) and 128 bytes to align it, or 0 when every tile
    reads device memory directly."""
    sb = stage_bytes(da.box, sample_bytes)
    return (stages or ring_stages(da, sample_bytes)) * sb + 128 if sb else 0


def _spans(idx: np.ndarray, step: int):
    """Per run of ``step`` outputs: its first output, its count, and the
    lowest and highest input index its taps read."""
    starts = np.arange(0, idx.shape[0], step)
    count = np.minimum(step, idx.shape[0] - starts)
    return (starts, count, np.minimum.reduceat(idx.min(axis=1), starts),
            np.maximum.reduceat(idx.max(axis=1), starts))


def _box(span: np.ndarray, pitch: np.ndarray) -> Tuple[int, int, int]:
    """The TMA boxes of a stage that holds every given span: ``count``
    boxes of ``rows`` x ``width`` samples side by side, each at most
    ``BOX_MAX`` wide (and a multiple of 128 samples when there are
    several, so each box starts 128-byte aligned)."""
    if span.size == 0:
        return 0, 0, 0
    pm = int(pitch.max())
    n = -(-pm // BOX_MAX)
    w = pm if n == 1 else -(-pm // (n * 128)) * 128
    return w, int(span.max()), n


def _packed_columns(col: AreaAxis, c0: np.ndarray, nc: np.ndarray, K: int) -> np.ndarray:
    """Per column tile: every output column's taps are ``K`` consecutive
    samples, ``K`` apart from its neighbour's, starting 16-aligned at the
    tile's first column, inside the input, all with one weight; and the
    output width is whole groups of 4 (the kernel's vector stores)."""
    w = col.weights
    if w.shape[1] != K or w.shape[0] % 4:
        return np.zeros(c0.size, bool)
    first = col.first.astype(np.int64)
    out = np.arange(first.size)
    tile = np.repeat(np.arange(c0.size), nc)
    lead = c0[tile]
    steps = first == first[lead] + K * (out - lead)
    inside = first + K - 1 <= col.n_in - 1
    same = (w == w[lead, :1]).all(axis=1)
    ok = np.logical_and.reduceat(steps & inside & same, c0)
    return ok & (first[c0] % ALIGN == 0)


def build_area_tiles(at: AreaTables) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """K4's tile plan: int32 ``[n, 8]`` rows of (out row, out col, rows,
    cols, y0, x0, span rows, mode) -- the tile's input span starts at (y0,
    x0) and holds ``span`` rows; mode ``DIRECT`` (read device memory),
    ``STAGED`` or ``PACKED`` -- direct tiles first (the longest items
    start early), and the stage's boxes (width, rows, count) that hold
    every staged span ((0, 0, 0): none)."""
    kr, kc = at.row.weights.shape[1], at.col.weights.shape[1]
    r0, nr, ylo, yhi = _spans(at.row.indices(), TR)
    c0, nc, xlo, xhi = _spans(at.col.indices(), TC)
    R, C = (g.reshape(-1) for g in np.meshgrid(np.arange(r0.size), np.arange(c0.size),
                                                indexing="ij"))
    span = yhi[R] - ylo[R] + 1
    x0 = xlo[C] // ALIGN * ALIGN
    pitch = -(-(xhi[C] + 1 - x0) // ALIGN) * ALIGN
    staged = ((max(kr, kc) <= MAX_TAPS) & (span <= BOX_MAX)
              & (2 * 2 * span * pitch <= SMEM_BUDGET))
    box = _box(span[staged], pitch[staged])
    if 2 * stage_bytes(box, 2) > SMEM_BUDGET:  # the spans' union is too large
        staged[:], box = False, (0, 0, 0)
    packed = staged & _packed_columns(at.col, c0, nc, taps(kr, kc))[C]
    mode = np.where(packed, PACKED, np.where(staged, STAGED, DIRECT))
    tiles = np.stack([r0[R], c0[C], nr[R], nc[C], ylo[R], x0, span, mode], axis=1)
    return np.ascontiguousarray(tiles[np.argsort(staged, kind="stable")], np.int32), box


def work_list(n_tiles: int, B: int, ctas: int,
              order: int = 0) -> List[List[Tuple[int, int, int]]]:
    """Each CTA's work as the kernel walks it, as runs (tile, first frame,
    frames), each tile's frames in order.  Order 0: CTA ``i`` of ``ctas``
    takes the items ``[i T / ctas, (i + 1) T / ctas)`` of the ``T =
    n_tiles * B`` (tile, frame) items in tile-major order.  Order 1: CTA
    ``i`` takes tiles ``i, i + ctas, i + 2 ctas, ...``, all frames of
    each, so that the CTAs take adjacent tiles at one frame at a time."""
    if order == 1:
        return [[(j, 0, B) for j in range(i, n_tiles, ctas)] for i in range(ctas)]
    T = n_tiles * B
    out = []
    for i in range(ctas):
        t, t1 = i * T // ctas, (i + 1) * T // ctas
        runs = []
        while t < t1:
            tile, f = divmod(t, B)
            n = min(t1 - t, B - f)
            runs.append((tile, f, n))
            t += n
        out.append(runs)
    return out


def area_plain(da: DeviceArea, x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """Plain version of K4: INTER_AREA (:func:`..sampling.area_resize`)
    then the half-up round saturated at ``maxval``, in ``x``'s dtype."""
    return round_px(area_resize(da, x), maxval, x.dtype)


class AreaCall(ctypes.Structure):
    """The arguments of a launch of K4 and of a graph node's update, as
    ``csrc/area.cu``'s ``AreaCall`` lays them out."""

    _fields_ = [
        ("src", _c_void_p), ("dst", _c_void_p),
        ("sample_bytes", _c_int), ("maxval", _c_int),  # largest sample
        ("B", _c_int), ("H", _c_int), ("W", _c_int), ("OH", _c_int), ("OW", _c_int),
        ("row_first", _c_void_p), ("row_w", _c_void_p), ("kr", _c_int),
        ("col_first", _c_void_p), ("col_w", _c_void_p), ("kc", _c_int),
        ("taps", _c_int),  # register taps
        ("tiles", _c_void_p), ("n_tiles", _c_int),
        ("box_w", _c_int), ("box_h", _c_int), ("nbox", _c_int), ("stages", _c_int),
        ("copy", _c_int), ("packed", _c_int), ("ctas", _c_int), ("order", _c_int),
    ]

    def point(self, src: tuple, out: int) -> None:
        """Set the source (one, described) and the output."""
        (s,) = src
        self.src, self.dst = s.ptr, out


KERNEL = nodes.Kernel("area", AreaCall, 4, 4, "INTER_AREA", "area.launches")


def _check_input(da: DeviceArea, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"INTER_AREA takes uint8 or uint16 planes, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (da.in_h, da.in_w):
        raise ValueError(f"INTER_AREA expects [B, {da.in_h}, {da.in_w}], got {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous():
        raise ValueError("INTER_AREA takes contiguous planes")
    if x.device != da.tiles.device:
        raise ValueError(f"plane on {x.device} but the area tables on {da.tiles.device}")


def copy_mode(da: DeviceArea, x: torch.Tensor) -> int:
    """How a launch stages ``x``: by TMA when its rows and base are
    16-byte aligned (TMA's rule), else by every thread of a CTA with plain
    loads (``COPY_SCALAR``)."""
    sb = x.element_size()
    return COPY_TMA if da.in_w * sb % 16 == 0 and x.data_ptr() % 16 == 0 else COPY_SCALAR


def walk_order(da: DeviceArea, x: torch.Tensor) -> int:
    """How a launch's CTAs walk their items (:func:`work_list`): order 0,
    contiguous runs, when the plane's rows are whole 128-byte lines; else
    order 1, where the CTAs take adjacent tiles at one frame at a time
    and so share the lines that straddle two tiles (measured faster on
    such planes by ``port_tools/k4_check.py``)."""
    return 0 if da.in_w * x.element_size() % 128 == 0 else 1


def resident_ctas(lib: ctypes.CDLL, da: DeviceArea, sample_bytes: int, stages: int = 0) -> int:
    """CTAs of K4 resident on all of the current card's SMs at once for a
    launch of ``da``'s plan (memoized per card, sample size, taps and
    shared memory)."""
    return KERNEL.resident(
        (sample_bytes, taps(da.row_w.shape[1], da.col_w.shape[1]),
         smem_bytes(da, sample_bytes, stages)),
        lambda: kernel_attrs(da, sample_bytes, stages, lib)["ctas_per_sm"])


def launch(lib: ctypes.CDLL, da: DeviceArea, x: torch.Tensor, out: torch.Tensor, stream: int,
           maxval: int = 255, *, copy: int = -1, stages: int = 0, packed: bool = True,
           ctas: int = 0, order: int = -1) -> None:
    """One launch of K4 from ``lib`` over ``da``'s tiles into ``out`` on
    the CUDA stream ``stream``; uint16 samples round and saturate to
    ``maxval``.  By default the plane's alignment picks the copy
    (:func:`copy_mode`) and the walk (:func:`walk_order`), the ring has
    :func:`ring_stages` stages (2 when every thread stages,
    ``COPY_SCALAR``), packed tiles take the packed path and the grid is
    persistent (:func:`grid_ctas`); ``port_tools/k4_check.py`` sets each
    to time its variants.  Raises if the launch fails."""
    sb = x.element_size()
    copy = copy_mode(da, x) if copy < 0 else copy
    order = walk_order(da, x) if order < 0 else order
    stages = stages or (2 if copy == COPY_SCALAR else ring_stages(da, sb))
    n_items = da.tiles.shape[0] * x.shape[0]
    kr, kc = da.row_w.shape[1], da.col_w.shape[1]
    call = AreaCall(
        sample_bytes=sb, maxval=maxval, B=x.shape[0],
        H=da.in_h, W=da.in_w, OH=da.out_shape[0], OW=da.out_shape[1],
        row_first=da.row_first.data_ptr(), row_w=da.row_w.data_ptr(), kr=kr,
        col_first=da.col_first.data_ptr(), col_w=da.col_w.data_ptr(), kc=kc, taps=taps(kr, kc),
        tiles=da.tiles.data_ptr(), n_tiles=da.tiles.shape[0],
        box_w=da.box[0], box_h=da.box[1], nbox=da.box[2], stages=stages, copy=copy,
        packed=int(packed),
        ctas=min(ctas or grid_ctas(n_items, resident_ctas(lib, da, sb, stages)), n_items),
        order=order)
    KERNEL.launch(lib, call, sources.describe((x,)), out.data_ptr(), stream)


def area_px(da: DeviceArea, x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """INTER_AREA + half-up round: ``[B, in_h, in_w]`` samples → ``[B,
    out_h, out_w]`` of the same dtype on ``x``'s device: uint8 (saturated
    at 255), or uint16 saturated at ``maxval`` (the depth's largest
    sample)."""
    with span("k4.launch"):
        _check_input(da, x)
        return KERNEL.run(x.device, x.element_size(), maxval, (x.shape[0],) + da.out_shape,
                          x.dtype, lambda: area_plain(da, x, maxval),
                          lambda lib, out, stream: launch(lib, da, x, out, stream, maxval))


def kernel_attrs(da: DeviceArea, sample_bytes: int = 1, stages: int = 0,
                 lib: ctypes.CDLL = None) -> dict:
    """K4's instantiation for ``sample_bytes`` on the current GPU: its
    registers, local memory bytes (spills and stack), resident CTAs per SM
    for a launch of ``da``'s plan with a ring of ``stages`` (default
    :func:`ring_stages`), that launch's dynamic shared memory, and the
    stages."""
    stages = stages or ring_stages(da, sample_bytes)
    return dict(KERNEL.attrs(lib, sample_bytes, taps(da.row_w.shape[1], da.col_w.shape[1]),
                             stage_bytes(da.box, sample_bytes), stages), stages=stages)
