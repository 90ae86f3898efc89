"""INTER_AREA resize + half-up round: the tile plan, the CUDA kernel K4
(``csrc/area.cu``) and, for a tensor on the CPU, its plain version.

K4 computes :func:`area_plain`, ``round_px(area_resize(da, x), maxval,
dtype)``, bit for bit, on uint8 planes and on uint16 planes (deep
formats, saturated at the depth's maximum): the epilogue of a
supersampled plane, from the scaled size to the output size.

Plan time (numpy, vectorized, once per plan and device in
:meth:`..sampling.DeviceArea.from_tables`): :func:`build_area_tiles` cuts
the output into ``TR x TC`` tiles and gives each the span of input rows
and columns its taps read (clamped padding taps included), from a column
aligned down to ``ALIGN`` samples with a pitch of whole ``ALIGN``s, so
that one plan serves both sample sizes.  A tile is staged through shared
memory when the plan has at most ``MAX_TAPS`` taps per axis (the kernel
holds them in registers: :func:`taps` picks its instantiation) and two of
its spans fit ``SMEM_BUDGET`` at uint16; any other tile has pitch 0 and
reads device memory directly inside the same kernel.

For a CUDA tensor :func:`area_px` launches the kernel or raises; it never
falls back.  ``LAUNCHES`` counts the uint8 instantiation's launches and
``LAUNCHES_U16`` the uint16 one's (one per call on a CUDA tensor).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..sampling import AreaTables, DeviceArea, area_resize, round_px
from . import _build

LAUNCHES = 0  # uint8 planes
LAUNCHES_U16 = 0  # uint16 planes

TR, TC = 8, 128  # output tile: a warp per row, 4 columns per thread
ALIGN = 16  # span origin and pitch, in samples: whole 16-byte chunks at either size
SMEM_BUDGET = 96 * 1024  # a staged CTA's two buffers
MAX_TAPS = 4  # taps per axis that the staged path holds in registers
CTA_FRAMES = 16  # most frames one CTA loops over (measured faster than 4 and 8)
CTAS_TARGET = 4096  # below this many CTAs a CTA takes fewer frames

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def taps(kr: int, kc: int) -> int:
    """K4's instantiation for ``kr`` row and ``kc`` column taps: 2 or 4
    register taps per axis (its staged tiles need kr, kc <= 4)."""
    return 2 if max(kr, kc) <= 2 else 4


def smem_bytes(da: DeviceArea, sample_bytes: int) -> int:
    """A launch's dynamic shared memory: two staged buffers, or 0 when
    every tile reads device memory directly."""
    return 2 * da.stage * sample_bytes


def _spans(idx: np.ndarray, step: int):
    """Per run of ``step`` outputs: its first output, its count, and the
    lowest and highest input index its taps read."""
    starts = np.arange(0, idx.shape[0], step)
    count = np.minimum(step, idx.shape[0] - starts)
    return (starts, count, np.minimum.reduceat(idx.min(axis=1), starts),
            np.maximum.reduceat(idx.max(axis=1), starts))


def build_area_tiles(at: AreaTables) -> Tuple[np.ndarray, int]:
    """K4's tile plan: int32 ``[n, 8]`` rows of (out row, out col, rows,
    cols, y0, x0, span rows, pitch) -- the tile's input span starts at
    (y0, x0) and holds ``span`` rows of ``pitch`` samples; pitch 0: read
    device memory directly -- direct tiles first (the longest CTAs start
    early), and the samples of the largest staged span (0: none)."""
    kr, kc = at.row.weights.shape[1], at.col.weights.shape[1]
    r0, nr, ylo, yhi = _spans(at.row.indices(), TR)
    c0, nc, xlo, xhi = _spans(at.col.indices(), TC)
    R, C = (g.reshape(-1) for g in np.meshgrid(np.arange(r0.size), np.arange(c0.size),
                                                indexing="ij"))
    span = yhi[R] - ylo[R] + 1
    x0 = xlo[C] // ALIGN * ALIGN
    pitch = -(-(xhi[C] + 1 - x0) // ALIGN) * ALIGN
    staged = (max(kr, kc) <= MAX_TAPS) & (2 * 2 * span * pitch <= SMEM_BUDGET)
    stage = int((span * pitch)[staged].max(initial=0))
    tiles = np.stack([r0[R], c0[C], nr[R], nc[C], ylo[R], x0, span,
                      np.where(staged, pitch, 0)], axis=1)
    return np.ascontiguousarray(tiles[np.argsort(staged, kind="stable")], np.int32), stage


def frames_per_cta(B: int, n_tiles: int) -> int:
    """Frames one CTA loops over: up to ``CTA_FRAMES`` while the grid keeps
    ``CTAS_TARGET`` CTAs, and never a grid of more than 65535 frame groups."""
    f = max(1, min(CTA_FRAMES, B * n_tiles // CTAS_TARGET))
    return max(f, -(-B // 65535))


def area_plain(da: DeviceArea, x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """Plain version of K4: INTER_AREA (:func:`..sampling.area_resize`)
    then the half-up round saturated at ``maxval``, in ``x``'s dtype."""
    return round_px(area_resize(da, x), maxval, x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.library("area")
    fn = lib.t360_area
    if fn.argtypes is None:
        fn.argtypes = [
            _c_void_p, _c_void_p,  # src, dst
            _c_int, ctypes.c_float,  # sample bytes, largest sample
            _c_int, _c_int, _c_int, _c_int, _c_int,  # B, H, W, OH, OW
            _c_void_p, _c_void_p, _c_int,  # row_first, row_w, kr
            _c_void_p, _c_void_p, _c_int, _c_int,  # col_first, col_w, kc, register taps
            _c_void_p, _c_int, _c_int,  # tiles, n_tiles, stage bytes
            _c_int, _c_int,  # frames per CTA, vec
            _c_void_p,  # stream
        ]
        fn.restype = _c_int
        lib.t360_area_attrs.argtypes = [_c_int, _c_int, _c_int, _c_void_p]
        lib.t360_area_attrs.restype = _c_int
        lib.t360_error_string.argtypes = [_c_int]
        lib.t360_error_string.restype = ctypes.c_char_p
    return lib


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


def launch(lib: ctypes.CDLL, da: DeviceArea, x: torch.Tensor, out: torch.Tensor,
           frames: int, stream: int, maxval: int = 255) -> None:
    """One launch of K4 from ``lib`` over ``da``'s tiles, ``frames``
    frames of ``x`` per CTA, into ``out`` on the CUDA stream ``stream``;
    uint16 samples round and saturate to ``maxval``.  Raises if the launch
    fails."""
    sb = x.element_size()
    kr, kc = da.row_w.shape[1], da.col_w.shape[1]
    err = lib.t360_area(
        x.data_ptr(), out.data_ptr(), sb, float(maxval), x.shape[0], da.in_h, da.in_w,
        *da.out_shape, da.row_first.data_ptr(), da.row_w.data_ptr(), kr,
        da.col_first.data_ptr(), da.col_w.data_ptr(), kc, taps(kr, kc),
        da.tiles.data_ptr(), da.tiles.shape[0], da.stage * sb, frames,
        int(da.in_w * sb % 16 == 0 and x.data_ptr() % 16 == 0), stream,
    )
    if err:
        raise RuntimeError(f"area kernel launch failed: {lib.t360_error_string(err).decode()}")


def area_px(da: DeviceArea, x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """INTER_AREA + half-up round: ``[B, in_h, in_w]`` samples → ``[B,
    out_h, out_w]`` of the same dtype on ``x``'s device: uint8 (saturated
    at 255), or uint16 saturated at ``maxval`` (the depth's largest
    sample)."""
    global LAUNCHES, LAUNCHES_U16
    _check_input(da, x)
    sb = x.element_size()
    if sb == 1 and maxval != 255:
        raise ValueError(f"uint8 samples saturate at 255, not {maxval}")
    if not 255 <= maxval <= 65535:
        raise ValueError(f"largest sample {maxval} is not a depth of 8 to 16 bits")
    if x.device.type == "cpu":
        return area_plain(da, x, maxval)
    if x.device.type != "cuda":
        raise ValueError(f"INTER_AREA runs on cpu or cuda tensors, not {x.device}")
    out = torch.empty((x.shape[0],) + da.out_shape, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        launch(lib, da, x, out, frames_per_cta(x.shape[0], da.tiles.shape[0]),
               torch.cuda.current_stream(x.device).cuda_stream, maxval)
    if sb == 1:
        LAUNCHES += 1
    else:
        LAUNCHES_U16 += 1
    return out


def kernel_attrs(da: DeviceArea, sample_bytes: int = 1) -> dict:
    """K4's instantiation for ``sample_bytes`` on the current GPU: its
    registers, local memory bytes (spills and stack), resident CTAs per SM
    for a launch of ``da``'s plan, and that launch's dynamic shared
    memory."""
    lib = _lib()
    out = (_c_int * 4)()
    err = lib.t360_area_attrs(sample_bytes, taps(da.row_w.shape[1], da.col_w.shape[1]),
                              da.stage * sample_bytes, out)
    if err:
        raise RuntimeError(f"area kernel attributes: {lib.t360_error_string(err).decode()}")
    return dict(zip(("registers", "local_bytes", "ctas_per_sm", "smem_bytes"), out))
