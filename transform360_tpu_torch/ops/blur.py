"""Prefilter wrapper: the CUDA kernel K1 (``csrc/blur.cu``) or, for a
tensor on the CPU, its plain version :func:`..filtering.blur_plain`
followed by the half-up round, on uint8 planes or on uint16 planes (the
deep formats, saturated at the depth's maximum).

:class:`BlurTables` cuts a :class:`..filtering.BlurPlan`'s band raster
into the kernel's tiles, vectorized in numpy: rectangles of at most
``TH`` rows by :func:`tile_width` columns (the CTA's consumer warps side
by side, 8 or 16 adjacent columns per thread) that never cross a latitude
band, a blur segment or a stereo eye, so that each tile has one tap set.
A tile names its tap set (-1: the zeroed leftover row or column of odd
stereo dims) and ``x0``, the first sample of its staged rows.  The
tables also fix the ring's layout for the plan and sample size: each
staged row holds ``row_bytes`` (one TMA box), ``pitch`` bytes apart,
``slab`` rows to a stage.  The ring kernel takes Gaussian taps only
(symmetric and non-negative, bit for bit: it computes each mirrored
product once); other plans, y radii over 3 and rows over one box take the
direct kernel.  ``csrc/blur.cu`` documents how the kernel walks them.

A launch (:func:`launch`) runs a persistent grid (:func:`grid_ctas`: the
CTAs resident on the card) over the tile-major (tile, frame, part) items
(:func:`work_list`), a part being an even share of a tile's rows
(:func:`part_rows`; :func:`launch_parts` cuts tiles into parts where the
batch gives too few items) and :func:`launch_cols` picks the columns per
thread.  A launch reads its batch where it lies, from one or two sources
(:mod:`.sources`: the U and V planes of a chroma batch, or slices of a
packed frame buffer), each through its own tensor map, into one stacked
output.  A batch whose sources' bases, rows and frame strides are all
16-byte aligned and whose rows hold a staged row is staged by TMA, any
other by the producer warp's loads (``COPY_WARP``): the shape chooses,
never a failure.  The tables memoize each batch's choices
(:func:`geometry`) by its sources' frame counts and alignment, so that
a call after the first spends no host time on them.  For CUDA tensors the
wrapper launches the kernel or raises; it never falls back, and never
copies a source.  :mod:`.nodes` binds, launches, records and re-points
the kernel (``KERNEL``); its update encodes the tensor maps anew, as a
launch does.  The counters ``blur.launches`` and ``blur.launches_u16``
(:data:`..utils.profiling.COUNTERS`) count the uint8 and the uint16
instantiations' launches (one per call on a CUDA tensor); the span
``t360.k1.launch`` times :func:`blur_px`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import StereoFormat
from ..filtering import BlurPlan, band_radii, blur_plain, plan_radii
from ..sampling import round_px
from ..utils.profiling import span
from . import nodes, sources
from .nodes import grid_ctas
from .sources import Planes

TILE_COLS = {1: 1024, 2: 768}  # a tile's columns by sample bytes (csrc/blur.cu: kTW)
GROUP = 16  # tiles are cut, and their threads start, at columns aligned to this
# a uint8 ring launch at y radius 1 gives each thread 16 adjacent columns
# (fewer instructions per pixel) once it has this many tile-frames per
# resident CTA, else 8 (twice the warps on an item: a small batch ends
# sooner); every other ring launch 8
WIDE_TILES_PER_CTA = 1
TH = 144  # rows of a tile at most
# y radii of the ring kernels; a plan's is padded up to the first that
# holds it (zero taps change no bit), larger ones take the direct kernel
RING_RY = (1, 3)
ROW_MAX = 2048  # bytes of a staged row: one TMA box of 256 8-byte elements
PITCH_ALIGN = 128  # TMA writes each row 128-byte aligned
SMEM_CTA = 54 * 1024  # a CTA's ring: four CTAs share an SM
STAGES = 3  # the ring's depth
ITEMS_PER_CTA = 8  # a launch cuts tiles into parts until each CTA has this many items
PART_ROWS_MIN = 16  # but no part under this many rows
COPY_TMA, COPY_WARP = 0, 1  # how a stage is filled

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def tile_width(sample_bytes: int) -> int:
    """Columns of a tile: the CTA's consumer warps side by side, 32
    threads of 8 or 16 columns each (1024 at uint8, 768 at uint16)."""
    return TILE_COLS[sample_bytes]


def thread_cols(bt: "BlurTables", B: int, resident: int) -> int:
    """Adjacent columns per thread of a ring launch of ``B`` frames on
    ``resident`` CTAs: 16 for uint8 at y radius 1 from
    ``WIDE_TILES_PER_CTA`` tile-frames per CTA, else 8."""
    wide = bt.tiles.shape[0] * B >= WIDE_TILES_PER_CTA * resident
    return 16 if bt.sample_bytes == 1 and bt.ring_ry == 1 and wide else 8


def staged_row(rx: int, sample_bytes: int) -> Tuple[int, int]:
    """(row_bytes, pitch) of a staged row for taps of x radius up to
    ``rx``: up to 16 bytes of alignment in front (a TMA box starts 16-byte
    aligned) and 8 samples where the threads start past the tile's
    ``GROUP``-aligned column, a tile's columns, the 2*rx halo and the
    words the last thread reads past its taps, in 16-byte chunks; rows
    ``PITCH_ALIGN``-aligned."""
    e, p = 16 // sample_bytes, 4 // sample_bytes  # samples per 16 bytes, per word
    n = e + 8 + tile_width(sample_bytes) + 2 * rx + 2 * p
    row = -(-n * sample_bytes // 16) * 16
    return row, -(-row // PITCH_ALIGN) * PITCH_ALIGN


def slab_rows(pitch: int, ring_ry: int, stages: int = STAGES, budget: int = SMEM_CTA) -> int:
    """Rows of a stage: as many as ``stages`` stages fit in ``budget``,
    a multiple of the rotation's 2 * ring_ry rows (0: none fits)."""
    return budget // (stages * pitch) // (2 * ring_ry) * (2 * ring_ry)


def gaussian_taps(kx: np.ndarray, ky: np.ndarray) -> bool:
    """Every set's x and y taps read the same backwards, bit for bit, and
    none has its sign bit set (the ring kernel computes k[u] * p once for
    u and 2 r - u, and omits the round's clamp at 0).  The arrays are
    centred and zero-padded, so the symmetry of a row is its set's."""
    bits = [np.ascontiguousarray(a, np.float32).view(np.uint32) for a in (kx, ky)]
    return all(np.array_equal(b, b[:, ::-1]) and not (b >> 31).any() for b in bits)


def _runs(key: np.ndarray):
    """[start, end) and key of each run of equal values."""
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    return starts, np.r_[starts[1:], key.size], key[starts]


def _split_even(starts, ends, keys, most: int):
    """Cut each run into the fewest nearly equal pieces of at most
    ``most``.  Returns (start, length, key)."""
    n = -(-(ends - starts) // most)
    run = np.repeat(np.arange(starts.size), n)
    i = np.arange(run.size) - np.repeat(np.cumsum(n) - n, n)
    length = ends[run] - starts[run]
    lo = i * length // n[run]
    hi = (i + 1) * length // n[run]
    return starts[run] + lo, hi - lo, keys[run]


def _split_aligned(starts, ends, keys, width: int):
    """Cut each run at the multiples of ``width`` past its start aligned
    down to ``GROUP`` samples, so that every piece's threads cover it from
    an aligned column.  Returns (start, length, key)."""
    g = starts // GROUP * GROUP
    n = 1 + np.maximum(0, -(-(ends - g - width) // width))
    run = np.repeat(np.arange(starts.size), n)
    i = np.arange(run.size) - np.repeat(np.cumsum(n) - n, n)
    lo = np.where(i == 0, starts[run], g[run] + i * width)
    hi = np.minimum(ends[run], g[run] + (i + 1) * width)
    return lo, hi - lo, keys[run]


@dataclasses.dataclass(frozen=True)
class BlurTables:
    """A blur plan cut into the kernel's tiles, on one device."""

    plan: BlurPlan
    H: int
    W: int
    tiles: torch.Tensor  # int32 [n, 6]: r0, c0, nrows, ncols, set (-1: zeros), x0
    kx: torch.Tensor  # float32 [sets, 2*RX+1] centred x taps (set = band * nseg + segment)
    rx: torch.Tensor  # int32 [sets]
    ky: torch.Tensor  # float32 [sets, 2*ring_ry+1] (direct: 2*RY+1) centred y taps
    ry: torch.Tensor  # int32 [sets], the plan's own radii
    ring_ry: int  # y radius of the ring kernel, or -1: the direct kernel
    row_bytes: int  # bytes of a staged row (ring kernel)
    pitch: int  # bytes between staged rows
    slab: int  # staged rows per stage
    min_rows: int  # rows of the shortest tile that is not zeros
    sample_bytes: int  # 1: uint8 planes, 2: uint16
    # (device, sources' frame counts, sources' 16-byte alignment) -> (copy,
    # cols, parts, ctas) of a launch
    memo: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    @property
    def dtype(self) -> torch.dtype:
        return torch.uint8 if self.sample_bytes == 1 else torch.uint16

    @classmethod
    def from_plan(cls, plan: BlurPlan, H: int, W: int, device,
                  sample_bytes: int = 1) -> "BlurTables":
        if sample_bytes not in (1, 2):
            raise ValueError(f"samples of {sample_bytes} bytes: 1 (uint8) or 2 (uint16)")
        RX, RY = plan_radii(plan)
        nseg = max(b.kx.shape[0] for b in plan.bands)
        sets = len(plan.bands) * nseg
        rx = np.zeros(sets, np.int32)
        ry = np.zeros(sets, np.int32)
        for i, b in enumerate(plan.bands):
            rx[i * nseg : (i + 1) * nseg], ry[i * nseg : (i + 1) * nseg] = band_radii(b)

        def taps(ly):
            kx = np.zeros((sets, 2 * RX + 1), np.float32)
            ky = np.zeros((sets, 2 * ly + 1), np.float32)
            for i, b in enumerate(plan.bands):
                brx, bry = band_radii(b)
                s = slice(i * nseg, i * nseg + b.kx.shape[0])
                kx[s, RX - brx : RX + brx + 1] = b.kx
                ky[s, ly - bry : ly + bry + 1] = b.ky
            return kx, ky

        ring = next((r for r in RING_RY if r >= RY), -1)
        row_bytes, pitch = staged_row(RX, sample_bytes)
        slab = slab_rows(pitch, ring) if ring > 0 else 0
        kx, ky = taps(max(ring, RY))
        if ring > 0 and not (row_bytes <= ROW_MAX and slab > 0 and gaussian_taps(kx, ky)):
            ring, kx, ky = -1, *taps(RY)
        if ring < 0:
            row_bytes = pitch = slab = 0

        # row runs keyed by band (-1: the leftover row of odd TB dims);
        # column runs keyed by eye and segment (-1: odd LR's leftover column)
        band_of = np.full(H, -1, np.int64)
        for off in (0, plan.eye_h) if plan.stereo == StereoFormat.TB else (0,):
            for i, b in enumerate(plan.bands):
                band_of[off + b.top : off + b.top + b.height] = i
        c = np.arange(W)
        eye = (c >= plan.eye_w) if plan.stereo == StereoFormat.LR else np.zeros(W, bool)
        covered = c < (2 if plan.stereo == StereoFormat.LR else 1) * plan.eye_w
        seg = np.minimum((c - eye * plan.eye_w) // plan.tile_w, nseg - 1)
        col_key = np.where(covered, eye * nseg + seg, -1)
        r0, nr, band = _split_even(*_runs(band_of), TH)
        c0, nc, ck = _split_aligned(*_runs(col_key), tile_width(sample_bytes))
        cseg = np.where(ck >= 0, ck % nseg, -1)

        R, C = np.meshgrid(np.arange(r0.size), np.arange(c0.size), indexing="ij")
        R, C = R.reshape(-1), C.reshape(-1)
        tset = np.where((band[R] >= 0) & (cseg[C] >= 0), band[R] * nseg + cseg[C], -1)
        e = 16 // sample_bytes  # a staged row starts 16-byte aligned (TMA's rule)
        x0 = np.where(tset >= 0, (c0[C] // GROUP * GROUP - rx[np.maximum(tset, 0)]) // e * e, 0)
        tiles = np.stack([r0[R], c0[C], nr[R], nc[C], tset, x0], axis=1)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        return cls(
            plan=plan,
            H=H,
            W=W,
            tiles=put(tiles, np.int32),
            kx=put(kx, np.float32),
            rx=put(rx, np.int32),
            ky=put(ky, np.float32),
            ry=put(ry, np.int32),
            ring_ry=ring,
            row_bytes=row_bytes,
            pitch=pitch,
            slab=slab,
            min_rows=int(nr[R][tset >= 0].min()) if (tset >= 0).any() else 1,
            sample_bytes=sample_bytes,
        )


def part_rows(r0: int, nrows: int, part: int, parts: int) -> Tuple[int, int]:
    """Rows [p0, p1) of part ``part`` of ``parts`` of a tile's rows
    (csrc/blur.cu: Item)."""
    return r0 + part * nrows // parts, r0 + (part + 1) * nrows // parts


def work_list(n_tiles: int, B: int, parts: int, ctas: int) -> List[List[Tuple[int, int, int]]]:
    """Each CTA's items as the kernel walks them: CTA ``i`` of ``ctas``
    takes items i, i + ctas, i + 2 ctas, ... of the tile-major list of the
    ``n_tiles * B * parts`` (tile, frame, part) items."""
    per_tile = B * parts
    return [[(j // per_tile, j % per_tile // parts, j % parts)
             for j in range(i, n_tiles * per_tile, ctas)] for i in range(ctas)]


def launch_parts(bt: BlurTables, B: int, ctas: int) -> int:
    """Parts per tile for a launch of ``B`` frames on ``ctas`` CTAs: the
    fewest that give every CTA ``ITEMS_PER_CTA`` items, but none that
    leaves a part of the shortest tile under ``PART_ROWS_MIN`` rows, and
    no more than one item per CTA where the tile-frames fit on the CTAs
    (a second round for a few CTAs would double a small batch's time); 1
    for the direct kernel.  ``port_tools/k1_variants.py --parts`` times
    the alternatives."""
    if bt.ring_ry < 0:
        return 1
    items = bt.tiles.shape[0] * B
    parts = max(1, min(-(-ITEMS_PER_CTA * ctas // items), bt.min_rows // PART_ROWS_MIN))
    return max(1, min(parts, ctas // items)) if items <= ctas else parts


class BlurCall(nodes.PlaneCall):
    """The arguments of a launch of K1 and of a graph node's update, as
    ``csrc/blur.cu``'s ``BlurCall`` lays them out past the pointers."""

    _fields_ = [
        ("sample_bytes", _c_int), ("maxval", _c_int),  # largest sample
        ("B", _c_int), ("H", _c_int), ("W", _c_int),
        ("tiles", _c_void_p), ("n_tiles", _c_int),
        ("kx", _c_void_p), ("rx", _c_void_p), ("lx", _c_int),
        ("ky", _c_void_p), ("ry", _c_void_p), ("ly", _c_int),
        ("ring_ry", _c_int), ("cols", _c_int),  # columns per thread
        ("row_bytes", _c_int), ("pitch", _c_int), ("slab", _c_int), ("stages", _c_int),
        ("parts", _c_int), ("copy", _c_int), ("ctas", _c_int), ("vec_out", _c_int),
    ]


KERNEL = nodes.Kernel("blur", BlurCall, 6, 5, "blur", "blur.launches")


def copy_mode(bt: BlurTables, x: Planes) -> int:
    """How a launch stages the sources ``x``: by TMA when every source's
    base and frame stride and the rows are 16-byte aligned (TMA's rule)
    and a row holds a staged row (a box is no wider than the plane), else
    by the producer warp's loads."""
    rows = bt.W * bt.sample_bytes
    tma = (rows % 16 == 0 and rows >= bt.row_bytes
           and all(s.aligned for s in sources.describe(sources.as_sources(x))))
    return COPY_TMA if tma else COPY_WARP


def kernel_attrs(bt: BlurTables, stages: int = STAGES, lib: ctypes.CDLL = None,
                 cols: int = 8) -> dict:
    """K1's instantiation for ``bt`` and ``cols`` columns per thread on
    the current GPU: its registers, local memory bytes (spills and stack),
    resident CTAs per SM and dynamic shared memory for a launch with a
    ring of ``stages``, its threads per CTA, and the stages."""
    return dict(KERNEL.attrs(lib, bt.sample_bytes, bt.ring_ry, cols, bt.pitch, bt.slab, stages),
                stages=stages, cols=cols)


def resident_ctas(lib: ctypes.CDLL, bt: BlurTables, stages: int = STAGES, cols: int = 8) -> int:
    """CTAs of K1 resident on all of the current card's SMs at once for a
    launch of ``bt`` (memoized per card, sample size, kernel and ring
    bytes)."""
    return KERNEL.resident((bt.sample_bytes, bt.ring_ry, cols, bt.pitch * bt.slab * stages),
                           lambda: kernel_attrs(bt, stages, lib, cols)["ctas_per_sm"])


def launch_cols(lib: ctypes.CDLL, bt: BlurTables, B: int, stages: int = STAGES) -> int:
    """Columns per thread of a ring launch of ``B`` frames of ``bt``:
    :func:`thread_cols` on the 16-column instantiation's resident CTAs,
    where there is one (uint8 at y radius 1), else 8."""
    if bt.sample_bytes == 1 and bt.ring_ry == 1:
        return thread_cols(bt, B, resident_ctas(lib, bt, stages, 16))
    return 8


def geometry(lib: ctypes.CDLL, bt: BlurTables, B: int, stages: int = STAGES, *, cols: int = 0,
             parts: int = 0, ctas: int = 0) -> Tuple[int, int, int]:
    """(columns per thread, parts per tile, CTAs) of a launch of ``B``
    frames of ``bt`` with a ring of ``stages``, each as given or, where 0,
    as the launch picks it: :func:`launch_cols`, :func:`launch_parts` and
    the persistent grid (:func:`grid_ctas`); the direct kernel takes 8,
    1 and a CTA per item."""
    n = bt.tiles.shape[0]
    if bt.ring_ry < 0:
        return 8, 1, ctas or n * B
    cols = cols or launch_cols(lib, bt, B, stages)
    resident = resident_ctas(lib, bt, stages, cols)
    parts = parts or launch_parts(bt, B, resident)
    return cols, parts, ctas or grid_ctas(n * B * parts, resident)


def launch(lib: ctypes.CDLL, bt: BlurTables, x: Planes, out: torch.Tensor, stream: int,
           maxval: int = 255, src: tuple = None, *, copy: int = -1, stages: int = STAGES,
           parts: int = 0, ctas: int = 0, cols: int = 0) -> None:
    """One launch of K1 from ``lib`` over ``bt``'s tiles, reading the
    sources ``x`` (described by ``src``, or here) where they lie, into
    ``out`` (stacked) on the CUDA stream ``stream``; uint16 samples round
    and saturate to ``maxval``.  The sources' alignment picks the copy
    (:func:`copy_mode`) and the batch the rest (:func:`geometry`),
    memoized in ``bt``.  The tests and ``port_tools/`` may set each
    choice: the copy (-1: as picked), the ring's depth, and the columns
    per thread, parts per tile and CTAs (0: as picked); a launch with any
    of them set memoizes nothing.  Raises if the launch fails."""
    xs = sources.as_sources(x)
    src = src or sources.describe(xs)
    B = sources.frames(xs)
    if copy < 0 and stages == STAGES and not (parts or ctas or cols):
        key = (xs[0].device.index, tuple([s.frames for s in src]),
               tuple([s.aligned for s in src]))
        g = bt.memo.get(key)
        if g is None:
            g = bt.memo[key] = (copy_mode(bt, xs), *geometry(lib, bt, B))
        copy, cols, parts, ctas = g
    else:
        copy = copy_mode(bt, xs) if copy < 0 else copy
        cols, parts, ctas = geometry(lib, bt, B, stages, cols=cols, parts=parts, ctas=ctas)
    n, ptr = bt.tiles.shape[0], out.data_ptr()
    call = BlurCall(
        sample_bytes=bt.sample_bytes, maxval=maxval, B=B, H=bt.H, W=bt.W,
        tiles=bt.tiles.data_ptr(), n_tiles=n,
        kx=bt.kx.data_ptr(), rx=bt.rx.data_ptr(), lx=bt.kx.shape[1],
        ky=bt.ky.data_ptr(), ry=bt.ry.data_ptr(), ly=bt.ky.shape[1],
        ring_ry=bt.ring_ry, cols=cols, row_bytes=bt.row_bytes, pitch=bt.pitch, slab=bt.slab,
        stages=stages, parts=parts, copy=copy, ctas=min(ctas, n * B * parts),
        vec_out=int(bt.W % 16 == 0 and ptr % 16 == 0))
    KERNEL.launch(lib, call, src, ptr, stream)


def blur_px(bt: BlurTables, x: Planes, maxval: int = 255) -> torch.Tensor:
    """Prefilter + half-up round: ``[B, H, W]`` samples, or one or two
    sources (:mod:`.sources`) read where they lie → ``[B, H, W]`` (the
    sources' frames stacked) of the same dtype, on their device: uint8
    (saturated at 255), or uint16 saturated at ``maxval`` (the depth's
    largest sample)."""
    with span("k1.launch"):
        xs, src = sources.check_sources(x, bt.H, bt.W, bt.dtype, bt.kx.device, "blur")
        return KERNEL.run(
            xs[0].device, bt.sample_bytes, maxval, (sources.frames(xs), bt.H, bt.W), bt.dtype,
            lambda: round_px(blur_plain(bt.plan, sources.stacked(xs).float()), maxval, bt.dtype),
            lambda lib, out, stream: launch(lib, bt, xs, out, stream, maxval, src))
