"""Prefilter wrapper: the CUDA kernel K1 (``csrc/blur.cu``) or, for a
tensor on the CPU, its plain version :func:`..filtering.blur_plain`
followed by the half-up round.

:class:`BlurTables` flattens a :class:`..filtering.BlurPlan`'s band raster
into the per-row, per-column and per-(band, segment) tables the kernel
reads; ``csrc/blur.cu`` documents their meaning.  For a CUDA tensor the
wrapper launches the kernel or raises; it never falls back.  ``LAUNCHES``
counts kernel launches (one per frame chunk).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..config import StereoFormat
from ..filtering import BlurPlan, band_radii, blur_plain, plan_radii
from ..sampling import round_u8
from . import _build

LAUNCHES = 0

# Bound on the float32 scratch of the two-pass kernel; the batch is
# chunked to stay below it (128 4K luma frames would need 4.2 GB).
SCRATCH_BYTES = 512 << 20

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class BlurTables:
    """A blur plan flattened for the kernel, on one device."""

    plan: BlurPlan
    H: int
    W: int
    S: int  # scratch rows per frame
    s_src: torch.Tensor  # int32 [S] source row of scratch row s
    s_band: torch.Tensor  # int32 [S] band whose x taps filter it
    row_band: torch.Tensor  # int32 [H] band of output row r (-1: zero row)
    row_s0: torch.Tensor  # int32 [H] scratch row of its first y tap
    col_seg: torch.Tensor  # int32 [W] blur segment of column c (-1: zero column)
    kx: torch.Tensor  # float32 [G, nseg, 2*RX+1] centred x taps
    rx: torch.Tensor  # int32 [G]
    ky: torch.Tensor  # float32 [G, nseg, 2*RY+1] centred y taps
    ry: torch.Tensor  # int32 [G]

    @classmethod
    def from_plan(cls, plan: BlurPlan, H: int, W: int, device) -> "BlurTables":
        # global bands: TB repeats the per-eye raster for the second eye's
        # rows; LR eyes share the rows and split the columns
        offs = (0, plan.eye_h) if plan.stereo == StereoFormat.TB else (0,)
        gbands = [(off, b) for off in offs for b in plan.bands]
        RX, RY = plan_radii(plan)
        nseg = max(b.kx.shape[0] for b in plan.bands)
        G = len(gbands)
        kx = np.zeros((G, nseg, 2 * RX + 1), np.float32)
        ky = np.zeros((G, nseg, 2 * RY + 1), np.float32)
        rx = np.zeros(G, np.int32)
        ry = np.zeros(G, np.int32)
        row_band = np.full(H, -1, np.int32)
        row_s0 = np.zeros(H, np.int32)
        s_src, s_band = [], []
        for g, (off, b) in enumerate(gbands):
            brx, bry = band_radii(b)
            rx[g], ry[g] = brx, bry
            kx[g, : b.kx.shape[0], RX - brx : RX + brx + 1] = b.kx
            ky[g, : b.ky.shape[0], RY - bry : RY + bry + 1] = b.ky
            top = off + b.top
            s0 = len(s_src)
            s_src.extend(np.clip(np.arange(top - bry, top + b.height + bry), 0, H - 1))
            s_band.extend([g] * (b.height + 2 * bry))
            row_band[top : top + b.height] = g
            row_s0[top : top + b.height] = s0 + np.arange(b.height)
        c = np.arange(W)
        if plan.stereo == StereoFormat.LR:
            ec = np.where(c >= plan.eye_w, c - plan.eye_w, c)
            covered = c < 2 * plan.eye_w
        else:
            ec = c
            covered = c < plan.eye_w
        col_seg = np.where(covered, np.minimum(ec // plan.tile_w, nseg - 1), -1)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        return cls(
            plan=plan,
            H=H,
            W=W,
            S=len(s_src),
            s_src=put(s_src, np.int32),
            s_band=put(s_band, np.int32),
            row_band=put(row_band, np.int32),
            row_s0=put(row_s0, np.int32),
            col_seg=put(col_seg, np.int32),
            kx=put(kx, np.float32),
            rx=put(rx, np.int32),
            ky=put(ky, np.float32),
            ry=put(ry, np.int32),
        )


def _lib() -> ctypes.CDLL:
    lib = _build.library("blur")
    fn = lib.t360_blur
    if fn.argtypes is None:
        fn.argtypes = [
            _c_void_p, _c_void_p, _c_void_p,  # x, scratch, out
            _c_int, _c_int, _c_int, _c_int,  # B, H, W, S
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,  # row/col tables
            _c_void_p, _c_void_p, _c_int,  # kx, rx, lx
            _c_void_p, _c_void_p, _c_int,  # ky, ry, ly
            _c_int,  # nseg
            _c_void_p,  # stream
        ]
        fn.restype = _c_int
        lib.t360_error_string.argtypes = [_c_int]
        lib.t360_error_string.restype = ctypes.c_char_p
    return lib


def _check_input(bt: BlurTables, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"blur takes uint8 planes, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (bt.H, bt.W):
        raise ValueError(f"blur expects [B, {bt.H}, {bt.W}], got {tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous():
        raise ValueError("blur takes contiguous planes")
    if x.device != bt.kx.device:
        raise ValueError(f"plane on {x.device} but the blur tables on {bt.kx.device}")


def blur_u8(bt: BlurTables, x: torch.Tensor) -> torch.Tensor:
    """Prefilter + half-up round: uint8 ``[B, H, W]`` → same shape, on
    ``x``'s device."""
    global LAUNCHES
    _check_input(bt, x)
    if x.device.type == "cpu":
        return round_u8(blur_plain(bt.plan, x.float()))
    if x.device.type != "cuda":
        raise ValueError(f"blur runs on cpu or cuda tensors, not {x.device}")
    B = x.shape[0]
    chunk = max(1, min(B, SCRATCH_BYTES // (bt.S * bt.W * 4)))
    out = torch.empty_like(x)
    scratch = torch.empty((chunk, bt.S, bt.W), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for f0 in range(0, B, chunk):
            n = min(chunk, B - f0)
            err = lib.t360_blur(
                x[f0].data_ptr(), scratch.data_ptr(), out[f0].data_ptr(),
                n, bt.H, bt.W, bt.S,
                bt.s_src.data_ptr(), bt.s_band.data_ptr(),
                bt.row_band.data_ptr(), bt.row_s0.data_ptr(),
                bt.col_seg.data_ptr(),
                bt.kx.data_ptr(), bt.rx.data_ptr(), bt.kx.shape[2],
                bt.ky.data_ptr(), bt.ry.data_ptr(), bt.ky.shape[2],
                bt.kx.shape[1],
                stream,
            )
            if err:
                raise RuntimeError(
                    f"blur kernel launch failed: {lib.t360_error_string(err).decode()}"
                )
            LAUNCHES += 1
    return out
