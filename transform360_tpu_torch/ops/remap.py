"""Remap wrapper: the CUDA kernel K2 (``csrc/remap.cu``) or, for a tensor
on the CPU, its plain version :func:`..sampling.remap_plain`.

For a CUDA tensor the wrapper launches the kernel or raises; it never
falls back.  ``LAUNCHES`` counts kernel launches (one per call on a CUDA
tensor), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..sampling import DeviceSpec, remap_plain, round_u8
from . import _build

LAUNCHES = 0

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("remap")
    fn = lib.t360_remap
    if fn.argtypes is None:
        fn.argtypes = [
            _c_void_p, _c_void_p,  # src, dst
            _c_int, _c_int, _c_int, _c_int,  # B, H, W, N
            _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,  # base_y..valid
            _c_void_p,  # wtab
            _c_int, _c_int, ctypes.c_float,  # taps, mode, fill
            _c_void_p,  # stream
        ]
        fn.restype = _c_int
        lib.t360_error_string.argtypes = [_c_int]
        lib.t360_error_string.restype = ctypes.c_char_p
    return lib


def _check_input(ds: DeviceSpec, x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"remap takes uint8 planes, got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (ds.in_h, ds.in_w):
        raise ValueError(
            f"remap expects [B, {ds.in_h}, {ds.in_w}], got {tuple(x.shape)}"
        )
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    if not x.is_contiguous():
        raise ValueError("remap takes contiguous planes")
    if x.device != ds.base_y.device:
        raise ValueError(
            f"plane on {x.device} but the remap tables on {ds.base_y.device}"
        )


def remap_u8(ds: DeviceSpec, x: torch.Tensor) -> torch.Tensor:
    """Remap + half-up round: uint8 ``[B, in_h, in_w]`` → uint8
    ``[B, out_h, out_w]`` on ``x``'s device."""
    global LAUNCHES
    _check_input(ds, x)
    if x.device.type == "cpu":
        return round_u8(remap_plain(ds, x))
    if x.device.type != "cuda":
        raise ValueError(f"remap runs on cpu or cuda tensors, not {x.device}")
    B = x.shape[0]
    out_h, out_w = ds.out_shape
    out = torch.empty((B, out_h, out_w), dtype=torch.uint8, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.t360_remap(
            x.data_ptr(), out.data_ptr(),
            B, ds.in_h, ds.in_w, out_h * out_w,
            ds.base_y.data_ptr(), ds.base_x.data_ptr(),
            ds.fy.data_ptr(), ds.fx.data_ptr(),
            None if ds.valid is None else ds.valid.data_ptr(),
            ds.wtab.data_ptr(),
            ds.taps, ds.mode, ds.fill,
            stream,
        )
    if err:
        raise RuntimeError(
            f"remap kernel launch failed: {lib.t360_error_string(err).decode()}"
        )
    LAUNCHES += 1
    return out
