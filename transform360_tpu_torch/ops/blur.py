"""Prefilter wrapper: the CUDA kernel K1 (``csrc/blur.cu``) or, for a
tensor on the CPU, its plain version :func:`..filtering.blur_plain`
followed by the half-up round, on uint8 planes or on uint16 planes (the
deep formats, saturated at the depth's maximum).

:class:`BlurTables` cuts a :class:`..filtering.BlurPlan`'s band raster
into the kernel's tiles, vectorized in numpy: rectangles of at most
``WARPS * strip`` rows by ``TW`` columns that never cross a latitude
band, a blur segment or a stereo eye, so that each tile has one tap set.
A tile names its tap set (-1: the zeroed leftover row or column of odd
stereo dims) and the row pitch, in samples, of its staged source rows;
``csrc/blur.cu`` documents how the kernel walks them.  The tables are cut
for one sample size: two staged buffers of a tile must fit the shared
memory budget, so uint16 tiles are about half as tall.  For a CUDA tensor
the wrapper launches the kernel or raises; it never falls back.
``LAUNCHES`` counts the uint8 instantiation's launches and
``LAUNCHES_U16`` the uint16 one's (one per call on a CUDA tensor).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import StereoFormat
from ..filtering import BlurPlan, band_radii, blur_plain, plan_radii
from ..sampling import round_px
from . import _build

LAUNCHES = 0  # uint8 planes
LAUNCHES_U16 = 0  # uint16 planes

WARPS = 8  # a CTA: 8 warps, each walking a strip of rows
TW = 32 * 4  # tile width: 32 threads of 4 adjacent columns
STRIP_MAX = 24  # rows of a warp's strip
# y radii of the register-ring kernels; a plan's is padded up to the
# first that holds it (zero taps change no bit), larger ones take the
# direct kernel
RING_RY = (1, 3)
SMEM_TARGET = 64 * 1024  # two staged buffers per CTA: three CTAs share an SM
SMEM_MAX = 227 * 1024  # the most one CTA may use on Hopper
CTA_FRAMES = 8  # most frames one CTA loops over
CTAS_TARGET = 4096  # below this many CTAs a CTA takes fewer frames

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def tile_pitch(ncols, rx, sample_bytes: int = 1):
    """Staged samples per row of a tile: its whole 4-column groups, the
    2*rx halo, up to one 16-byte chunk less a sample of alignment in front
    and the last thread's word read past its taps (``x_pass`` in
    ``csrc/blur.cu``), in 16-byte chunks."""
    cs = 16 // sample_bytes  # samples per 16-byte chunk
    return (4 * (-(-ncols // 4)) + 2 * rx + cs + 4 // sample_bytes + cs - 1) // cs * cs


def _runs(key: np.ndarray):
    """[start, end) and key of each run of equal values."""
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    return starts, np.r_[starts[1:], key.size], key[starts]


def _split(starts, ends, keys, most: int, even: bool):
    """Cut each run into pieces of at most ``most``: nearly equal ones
    (``even``) or ``most`` from the start.  Returns (start, length, key)."""
    n = -(-(ends - starts) // most)
    run = np.repeat(np.arange(starts.size), n)
    i = np.arange(run.size) - np.repeat(np.cumsum(n) - n, n)
    length = ends[run] - starts[run]
    if even:
        lo = i * length // n[run]
        hi = (i + 1) * length // n[run]
    else:
        lo = i * most
        hi = np.minimum(lo + most, length)
    return starts[run] + lo, hi - lo, keys[run]


@dataclasses.dataclass(frozen=True)
class BlurTables:
    """A blur plan cut into the kernel's tiles, on one device."""

    plan: BlurPlan
    H: int
    W: int
    tiles: torch.Tensor  # int32 [n, 6]: r0, c0, nrows, ncols, set (-1: zeros), pitch
    kx: torch.Tensor  # float32 [sets, 2*RX+1] centred x taps (set = band * nseg + segment)
    rx: torch.Tensor  # int32 [sets]
    ky: torch.Tensor  # float32 [sets, 2*ring_ry+1] (direct: 2*RY+1) centred y taps
    ry: torch.Tensor  # int32 [sets], the plan's own radii
    ring_ry: int  # y radius of the ring kernel, or -1: the direct kernel
    buf_bytes: int  # one staged buffer of the ring kernel
    sample_bytes: int  # 1: uint8 planes, 2: uint16

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
        ring = next((r for r in RING_RY if r >= RY), -1)
        strip = 0
        if ring >= 0:  # rows per warp strip that let two buffers fit
            for budget in (SMEM_TARGET, SMEM_MAX):
                rows = budget // (2 * sample_bytes * tile_pitch(TW, RX, sample_bytes)) - 2 * ring
                if rows >= WARPS:
                    strip = min(STRIP_MAX, rows // WARPS)
                    break
            else:
                ring = -1
        ly = ring if ring >= 0 else RY
        sets = len(plan.bands) * nseg
        kx = np.zeros((sets, 2 * RX + 1), np.float32)
        ky = np.zeros((sets, 2 * ly + 1), np.float32)
        rx = np.zeros(sets, np.int32)
        ry = np.zeros(sets, np.int32)
        for i, b in enumerate(plan.bands):
            brx, bry = band_radii(b)
            s = slice(i * nseg, i * nseg + b.kx.shape[0])
            kx[s, RX - brx : RX + brx + 1] = b.kx
            ky[s, ly - bry : ly + bry + 1] = b.ky
            rx[i * nseg : (i + 1) * nseg] = brx
            ry[i * nseg : (i + 1) * nseg] = bry

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
        th = WARPS * (strip or STRIP_MAX)
        r0, nr, band = _split(*_runs(band_of), th, even=True)
        c0, nc, ck = _split(*_runs(col_key), TW, even=False)
        cseg = np.where(ck >= 0, ck % nseg, -1)

        R, C = np.meshgrid(np.arange(r0.size), np.arange(c0.size), indexing="ij")
        R, C = R.reshape(-1), C.reshape(-1)
        tset = np.where((band[R] >= 0) & (cseg[C] >= 0), band[R] * nseg + cseg[C], -1)
        trx = np.where(tset >= 0, rx[tset], 0)
        pitch = np.where(tset >= 0, tile_pitch(nc[C], trx, sample_bytes), 0)
        tiles = np.stack([r0[R], c0[C], nr[R], nc[C], tset, pitch], axis=1)
        # the widest taps first (the longest CTAs start early), zeros last
        tiles = tiles[np.argsort(np.where(tset >= 0, -trx, 1), kind="stable")]
        staged = tiles[:, 4] >= 0
        buf = sample_bytes * int(
            ((tiles[:, 2] + 2 * max(ring, 0)) * tiles[:, 5])[staged].max(initial=0))

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
            buf_bytes=buf if ring >= 0 else 0,
            sample_bytes=sample_bytes,
        )


def frames_per_cta(B: int, n_tiles: int) -> int:
    """Frames one CTA loops over: up to ``CTA_FRAMES`` while the grid keeps
    ``CTAS_TARGET`` CTAs, and never a grid of more than 65535 frame groups."""
    f = max(1, min(CTA_FRAMES, B * n_tiles // CTAS_TARGET))
    return max(f, -(-B // 65535))


def _lib() -> ctypes.CDLL:
    lib = _build.library("blur")
    fn = lib.t360_blur
    if fn.argtypes is None:
        fn.argtypes = [
            _c_void_p, _c_void_p,  # x, out
            _c_int, _c_int,  # sample bytes, largest sample
            _c_int, _c_int, _c_int,  # B, H, W
            _c_void_p, _c_int,  # tiles, n_tiles
            _c_void_p, _c_void_p, _c_int,  # kx, rx, lx
            _c_void_p, _c_void_p, _c_int,  # ky, ry, ly
            _c_int, _c_int, _c_int,  # ring_ry, frames per CTA, buffer bytes
            _c_int, _c_int,  # vec_in, vec_out
            _c_void_p,  # stream
        ]
        fn.restype = _c_int
        lib.t360_error_string.argtypes = [_c_int]
        lib.t360_error_string.restype = ctypes.c_char_p
    return lib


def _check_input(bt: BlurTables, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != bt.dtype:
        raise TypeError(f"these blur tables take {bt.dtype} planes, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (bt.H, bt.W):
        raise ValueError(f"blur expects [B, {bt.H}, {bt.W}], got {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous():
        raise ValueError("blur takes contiguous planes")
    if x.device != bt.kx.device:
        raise ValueError(f"plane on {x.device} but the blur tables on {bt.kx.device}")


def blur_px(bt: BlurTables, x: torch.Tensor, maxval: int = 255) -> torch.Tensor:
    """Prefilter + half-up round: ``[B, H, W]`` samples → same shape and
    dtype, on ``x``'s device: uint8 (saturated at 255), or uint16
    saturated at ``maxval`` (the depth's largest sample)."""
    global LAUNCHES, LAUNCHES_U16
    _check_input(bt, x)
    if bt.sample_bytes == 1 and maxval != 255:
        raise ValueError(f"uint8 samples saturate at 255, not {maxval}")
    if not 255 <= maxval <= 65535:
        raise ValueError(f"largest sample {maxval} is not a depth of 8 to 16 bits")
    if x.device.type == "cpu":
        return round_px(blur_plain(bt.plan, x.float()), maxval, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"blur runs on cpu or cuda tensors, not {x.device}")
    B = x.shape[0]
    n = bt.tiles.shape[0]
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.t360_blur(
            x.data_ptr(), out.data_ptr(), bt.sample_bytes, maxval, B, bt.H, bt.W,
            bt.tiles.data_ptr(), n,
            bt.kx.data_ptr(), bt.rx.data_ptr(), bt.kx.shape[1],
            bt.ky.data_ptr(), bt.ry.data_ptr(), bt.ky.shape[1],
            bt.ring_ry, frames_per_cta(B, n), bt.buf_bytes,
            int(bt.W * bt.sample_bytes % 16 == 0 and x.data_ptr() % 16 == 0),
            int(bt.W % 4 == 0 and out.data_ptr() % (4 * bt.sample_bytes) == 0),
            stream,
        )
    if err:
        raise RuntimeError(f"blur kernel launch failed: {lib.t360_error_string(err).decode()}")
    if bt.sample_bytes == 1:
        LAUNCHES += 1
    else:
        LAUNCHES_U16 += 1
    return out
