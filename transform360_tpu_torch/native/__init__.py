"""ctypes bindings for the native C++ engine (``native/t360.cpp``).

The port's own copy of ``transform360_tpu.native``: a dependency-free
C++17 implementation of the full Transform360 pipeline with a C ABI
mirroring the reference's stable library surface
(``VideoFrameTransformHandler.h:24-47``), run on the host's CPU.  It
shares no code with the port's PyTorch path or its CUDA kernels, so it
checks them at any size on a host without OpenCV or jax.

The library is built from ``native/t360.cpp`` with the host's C++
compiler at first use, into ``transform360_tpu_torch/build/``
(:func:`..ops._build.native_library`).  Without a compiler, or when the
build fails, :func:`available` returns False and :class:`NativeTransform`
raises ``RuntimeError`` with the compiler's message; nothing falls back
to another engine.  Planes cross the C boundary as numpy arrays: the
engine takes uint8 numpy arrays or CPU tensors and returns numpy arrays.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import StereoFormat, TransformConfig, chroma_dims, get_pixel_format
from ..ops import _build


class _CtxStruct(ctypes.Structure):
    # Field order must match struct Ctx in t360.cpp.
    _fields_ = [
        ("input_layout", ctypes.c_int32),
        ("output_layout", ctypes.c_int32),
        ("input_stereo_format", ctypes.c_int32),
        ("output_stereo_format", ctypes.c_int32),
        ("vflip", ctypes.c_int32),
        ("input_expand_coef", ctypes.c_float),
        ("expand_coef", ctypes.c_float),
        ("interpolation_alg", ctypes.c_int32),
        ("width_scale_factor", ctypes.c_float),
        ("height_scale_factor", ctypes.c_float),
        ("fixed_yaw", ctypes.c_float),
        ("fixed_pitch", ctypes.c_float),
        ("fixed_roll", ctypes.c_float),
        ("fixed_hfov", ctypes.c_float),
        ("fixed_vfov", ctypes.c_float),
        ("fixed_cube_offcenter_x", ctypes.c_float),
        ("fixed_cube_offcenter_y", ctypes.c_float),
        ("fixed_cube_offcenter_z", ctypes.c_float),
        ("is_horizontal_offset", ctypes.c_int32),
        ("enable_low_pass_filter", ctypes.c_int32),
        ("kernel_height_scale_factor", ctypes.c_float),
        ("min_kernel_half_height", ctypes.c_float),
        ("max_kernel_half_height", ctypes.c_float),
        ("enable_multi_threading", ctypes.c_int32),
        ("num_vertical_segments", ctypes.c_int32),
        ("num_horizontal_segments", ctypes.c_int32),
        ("adjust_kernel", ctypes.c_int32),
        ("kernel_adjust_factor", ctypes.c_float),
    ]


def _cfg_to_struct(cfg: TransformConfig) -> _CtxStruct:
    s = _CtxStruct()
    for name, _ in _CtxStruct._fields_:
        setattr(s, name, getattr(cfg, name))
    return s


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C ABI's argument and result types (``t360.cpp:1011-1107``)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.T360_new.restype = vp
    lib.T360_new.argtypes = [ctypes.POINTER(_CtxStruct)]
    lib.T360_delete.restype = None
    lib.T360_delete.argtypes = [vp]
    lib.T360_generateMapForPlane.restype = i
    lib.T360_generateMapForPlane.argtypes = [vp] + [i] * 5
    lib.T360_transformFramePlane.restype = i
    lib.T360_transformFramePlane.argtypes = [vp, vp, vp] + [i] * 8
    lib.T360_transformFramesPlane.restype = i
    lib.T360_transformFramesPlane.argtypes = [vp, vp, vp] + [i] * 10
    lib.T360_exportWarpMap.restype = i
    lib.T360_exportWarpMap.argtypes = [vp, i, vp]
    lib.T360_planeDims.restype = i
    lib.T360_planeDims.argtypes = [vp, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    return lib


def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """(library, None), or (None, the build's error message)."""
    try:
        return _bind(_build.native_library()), None
    except (RuntimeError, OSError) as e:
        return None, str(e)


def available() -> bool:
    return _load()[0] is not None


def build_error() -> Optional[str]:
    return _load()[1]


def _host_u8(p, what: str) -> np.ndarray:
    """A C-contiguous uint8 numpy view (or copy) of a numpy array or a CPU
    tensor; anything else raises (a device tensor is the caller's to copy)."""
    if isinstance(p, torch.Tensor):
        if p.device.type != "cpu":
            raise ValueError(
                f"{what}: the native engine runs on the host's CPU; copy the "
                f"{p.device.type} tensor to the host first"
            )
        p = p.numpy()
    p = np.asarray(p)
    if p.dtype != np.uint8:
        raise ValueError(f"{what}: the native engine takes uint8 samples, not {p.dtype}")
    return np.ascontiguousarray(p)


class NativeTransform:
    """CPU-native engine instance: the C ABI surface as a Python object.

    Method shape mirrors the reference handler
    (``VideoFrameTransformHandler.h``): construct with a config, generate
    maps per plane class, transform raw plane buffers.
    """

    def __init__(self, cfg: TransformConfig):
        if StereoFormat.GUESS in (cfg.input_stereo_format, cfg.output_stereo_format):
            raise ValueError(
                "resolve GUESS stereo formats before constructing the "
                "native engine (config.resolve_stereo_formats)"
            )
        lib, err = _load()
        if lib is None:
            raise RuntimeError(f"native engine unavailable: {err}")
        self._lib = lib
        self._cfg = cfg
        ctx = _cfg_to_struct(cfg)
        self._h = lib.T360_new(ctypes.byref(ctx))
        if not self._h:
            raise MemoryError("T360_new failed")
        # generated-map memo: the C engine recomputes on every
        # T360_generateMapForPlane call (like the reference's
        # generateMapForPlane); the lazy once-per-stream behavior lives
        # here, mirroring vf_transform360.c:346-352.
        self._maps = {}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.T360_delete(h)
            self._h = None

    @property
    def config(self) -> TransformConfig:
        return self._cfg

    def generate_map_for_plane(
        self, in_w: int, in_h: int, out_w: int, out_h: int, plane_idx: int
    ) -> None:
        key = (in_w, in_h, out_w, out_h, plane_idx)
        if self._maps.get(plane_idx) == key:
            return
        if not self._lib.T360_generateMapForPlane(self._h, in_w, in_h, out_w, out_h, plane_idx):
            raise ValueError("T360_generateMapForPlane failed")
        self._maps[plane_idx] = key

    def transform_frame_plane(
        self, plane, out_w: int, out_h: int, plane_idx: int, image_plane_idx: int
    ) -> np.ndarray:
        """One uint8 [H, W] plane -> [out_h, out_w]; the map for
        ``plane_idx`` must have been generated for this plane's size."""
        plane = _host_u8(plane, "plane")
        in_h, in_w = plane.shape
        out = np.empty((out_h, out_w), np.uint8)
        ok = self._lib.T360_transformFramePlane(
            self._h, plane.ctypes.data, out.ctypes.data,
            in_w, in_h, in_w, out_w, out_h, out_w, plane_idx, image_plane_idx,
        )
        if not ok:
            raise ValueError("T360_transformFramePlane failed")
        return out

    def transform_frames_plane(
        self,
        planes,
        out_w: int,
        out_h: int,
        plane_idx: int,
        image_plane_idx: int,
        n_threads: int = 0,
    ) -> np.ndarray:
        """Frame-pool runner: uint8 [B, H, W] -> [B, out_h, out_w].

        Frame-level parallelism across a worker pool (the CPU analog of
        the card's batch axis); ``n_threads <= 0`` uses hardware
        concurrency.  Maps must have been generated for ``plane_idx``."""
        planes = _host_u8(planes, "planes")
        b, in_h, in_w = planes.shape
        out = np.empty((b, out_h, out_w), np.uint8)
        done = self._lib.T360_transformFramesPlane(
            self._h, planes.ctypes.data, out.ctypes.data,
            b, in_w, in_h, in_w, out_w, out_h, out_w, plane_idx, image_plane_idx, n_threads,
        )
        if done != b:
            raise ValueError(f"frame pool transformed {done}/{b} frames")
        return out

    def transform_frames(
        self, y, u, v, out_w: int, out_h: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched YUV420 frames: uint8 [B, ...] per plane, frame pool."""
        return self.transform_planar((y, u, v), out_w, out_h, "yuv420p")

    def transform_planar(
        self, planes, out_w: int, out_h: int, pix_fmt="yuv420p"
    ) -> Tuple[np.ndarray, ...]:
        """N-plane planar frames, single ([H, W] planes) or batched
        ([B, H, W], frame pool).  Plane 0 uses the luma
        map, every other plane the chroma map, with chroma dims from the
        format's log2 shifts (``vf_transform360.c:87-97,368-372``)."""
        pf = get_pixel_format(pix_fmt)
        planes = [_host_u8(p, f"plane {i}") for i, p in enumerate(planes)]
        if len(planes) != pf.n_planes:
            raise ValueError(
                f"expected {pf.n_planes} plane(s) for {pf.name}, got {len(planes)}"
            )
        batched = planes[0].ndim == 3
        in_h, in_w = planes[0].shape[-2:]
        self.generate_map_for_plane(in_w, in_h, out_w, out_h, 0)
        if pf.n_planes > 1:
            c_in_w, c_in_h = chroma_dims(in_w, in_h, pf)
            c_out_w, c_out_h = chroma_dims(out_w, out_h, pf)
            self.generate_map_for_plane(c_in_w, c_in_h, c_out_w, c_out_h, 1)
        outs = []
        for i, p in enumerate(planes):
            mp = 0 if i == 0 else 1
            ow, oh = (out_w, out_h) if mp == 0 else (c_out_w, c_out_h)
            if batched:
                outs.append(self.transform_frames_plane(p, ow, oh, mp, i))
            else:
                outs.append(self.transform_frame_plane(p, ow, oh, mp, i))
        return tuple(outs)

    def export_warp_map(self, plane_idx: int) -> np.ndarray:
        """Quantized warp map [H', W', 2] for cross-validation."""
        w, h = ctypes.c_int(), ctypes.c_int()
        if not self._lib.T360_planeDims(self._h, plane_idx, ctypes.byref(w), ctypes.byref(h)):
            raise ValueError("no map for plane")
        out = np.empty((h.value, w.value, 2), np.float32)
        self._lib.T360_exportWarpMap(self._h, plane_idx, out.ctypes.data)
        return out

    def transform_frame(
        self, y, u, v, out_w: int, out_h: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full YUV420 frame: 2 map planes for 3 image planes."""
        return self.transform_planar((y, u, v), out_w, out_h, "yuv420p")
