"""Configuration surface: option parsing, output geometry, pixel formats.

The benchmark's frozen copy of ``transform360_tpu_torch/config.py``
(itself a copy of the reference filter's option table), so that the
reference never imports the program under test.

Configuration surface of the PyTorch/CUDA port.

A copy of ``transform360_tpu.config`` (which is jax-free, but importing it
would run ``transform360_tpu/__init__.py`` and so import jax): same
classes, same defaults, same exceptions on bad options.

Mirrors the reference's two config layers:

* The library-level ``FrameTransformContext`` struct
  (reference ``Transform360/Library/VideoFrameTransformHelper.h:56-90``):
  27 fields copied by value into the engine at construction — config is
  immutable after init.  Here it is a frozen dataclass
  (:class:`TransformConfig`) with identical field names and defaults.

* The FFmpeg ``transform360`` AVOption table
  (reference ``Transform360/vf_transform360.c:407-987``): enum names in
  both upper and lower case, ``w``/``h`` arithmetic expression strings,
  stereo-format GUESS auto-resolution, and cube-edge output sizing.
  :func:`parse_options` accepts the same ``key=value:key=value`` string.

Everything in this module is host-side Python/numpy — no JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
from typing import Optional, Tuple

from .expr import eval_size_expr


class FaceType(enum.IntEnum):
    """Cube face indices (reference ``VideoFrameTransformHelper.h:18-25``)."""

    RIGHT = 0
    LEFT = 1
    TOP = 2
    BOTTOM = 3
    FRONT = 4
    BACK = 5


class Layout(enum.IntEnum):
    """Projection layouts (reference ``VideoFrameTransformHelper.h:27-39``).

    ``LAYOUT_FB`` is omitted: it is dead code in any open-source build of the
    reference (guarded by ``#ifdef FACEBOOK_LAYOUT`` whose implementation
    header is not shipped).
    """

    CUBEMAP_32 = 0
    CUBEMAP_23_OFFCENTER = 1
    FLAT_FIXED = 2
    EQUIRECT = 3
    BARREL = 4
    BARREL_SPLIT = 5
    EAC_32 = 6


class StereoFormat(enum.IntEnum):
    """Stereo frame packing (reference ``VideoFrameTransformHelper.h:41-47``)."""

    TB = 0
    LR = 1
    MONO = 2
    GUESS = 3


class Interpolation(enum.IntEnum):
    """Resampling algorithms (reference ``VideoFrameTransformHelper.h:49-54``).

    Values equal OpenCV ``cv::INTER_*`` codes — the reference passes them
    straight to ``cv::remap`` (``VideoFrameTransform.cpp:753``).  Note there
    is no value 3 (that would be INTER_AREA, which the reference uses only
    for the supersampling downscale epilogue).
    """

    NEAREST = 0
    LINEAR = 1
    CUBIC = 2
    LANCZOS4 = 4


_LAYOUT_NAMES = {
    "cubemap_32": Layout.CUBEMAP_32,
    "cubemap_23_offcenter": Layout.CUBEMAP_23_OFFCENTER,
    "equirect": Layout.EQUIRECT,
    "flat_fixed": Layout.FLAT_FIXED,
    "barrel": Layout.BARREL,
    "barrel_split": Layout.BARREL_SPLIT,
    "eac_32": Layout.EAC_32,
}

_STEREO_NAMES = {
    "tb": StereoFormat.TB,
    "lr": StereoFormat.LR,
    "mono": StereoFormat.MONO,
    "guess": StereoFormat.GUESS,
}

_INTERP_NAMES = {
    "nearest": Interpolation.NEAREST,
    "linear": Interpolation.LINEAR,
    "cubic": Interpolation.CUBIC,
    "lanczos4": Interpolation.LANCZOS4,
}


def _parse_layout(v: str) -> Layout:
    s = str(v).strip().lower()
    if s in _LAYOUT_NAMES:
        return _LAYOUT_NAMES[s]
    return Layout(int(s))


def _parse_stereo(v: str) -> StereoFormat:
    s = str(v).strip().lower()
    if s in _STEREO_NAMES:
        return _STEREO_NAMES[s]
    return StereoFormat(int(s))


def _parse_interp(v: str) -> Interpolation:
    s = str(v).strip().lower()
    if s in _INTERP_NAMES:
        return _INTERP_NAMES[s]
    return Interpolation(int(s))


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Frozen analog of ``FrameTransformContext``.

    Field names, meanings and defaults follow the reference AVOption table
    (``vf_transform360.c:407-987``) and struct
    (``VideoFrameTransformHelper.h:56-90``).
    """

    input_layout: Layout = Layout.EQUIRECT
    output_layout: Layout = Layout.CUBEMAP_32
    input_stereo_format: StereoFormat = StereoFormat.GUESS
    output_stereo_format: StereoFormat = StereoFormat.GUESS
    vflip: int = 0
    input_expand_coef: float = 1.01
    expand_coef: float = 1.01
    interpolation_alg: Interpolation = Interpolation.CUBIC
    width_scale_factor: float = 1.0
    height_scale_factor: float = 1.0
    fixed_yaw: float = 0.0
    fixed_pitch: float = 0.0
    fixed_roll: float = 0.0
    fixed_hfov: float = 120.0
    fixed_vfov: float = 110.0
    fixed_cube_offcenter_x: float = 0.0
    fixed_cube_offcenter_y: float = 0.0
    fixed_cube_offcenter_z: float = 0.0
    is_horizontal_offset: int = 0
    enable_low_pass_filter: int = 1
    kernel_height_scale_factor: float = 1.0
    min_kernel_half_height: float = 1.0
    max_kernel_half_height: float = 10000.0
    enable_multi_threading: int = 1  # accepted for parity; no-op here
    num_vertical_segments: int = 5
    num_horizontal_segments: int = 1
    adjust_kernel: int = 1
    kernel_adjust_factor: float = 1.0

    def replace(self, **kw) -> "TransformConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Input validation paralleling ``VideoFrameTransform.cpp:511-520``."""
        if self.width_scale_factor <= 0 or self.height_scale_factor <= 0:
            raise ValueError("scale factors must be > 0")
        if self.kernel_height_scale_factor <= 0:
            raise ValueError("kernel_height_scale_factor must be > 0")
        if self.num_vertical_segments < 2:
            raise ValueError("num_vertical_segments must be >= 2")
        if self.num_horizontal_segments < 1:
            raise ValueError("num_horizontal_segments must be >= 1")
        if self.min_kernel_half_height < 0.5 or self.max_kernel_half_height < 0.5:
            raise ValueError("kernel half heights must be >= 0.5")
        if self.interpolation_alg not in (
            Interpolation.NEAREST,
            Interpolation.LINEAR,
            Interpolation.CUBIC,
            Interpolation.LANCZOS4,
        ):
            raise ValueError(f"unsupported interpolation {self.interpolation_alg}")

    def cache_key(self) -> str:
        """Stable hash of the config for warp-map/plan caching.

        The reference caches maps implicitly by generating them lazily on
        frame 1 and never again (``vf_transform360.c:346-352``); we key
        explicitly so plans can be reused and serialized across processes.
        """
        d = dataclasses.asdict(self)
        blob = json.dumps(d, sort_keys=True, default=float)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    """The full FFmpeg option surface (filter-shell level, ``vf_transform360.c:39-85``).

    These are the knobs that exist *above* ``TransformConfig``: output sizing
    and stereo guessing.  ``max_output_w``/``max_output_h`` are declared by
    the reference but never read (``vf_transform360.c:466-481``) — kept for
    option-string compatibility only.
    """

    config: TransformConfig = dataclasses.field(default_factory=TransformConfig)
    w_expr: Optional[str] = None
    h_expr: Optional[str] = None
    size_str: Optional[str] = None
    cube_edge_length: int = 0
    max_cube_edge_length: int = 0
    max_output_w: int = 0  # parsed but unused, like the reference
    max_output_h: int = 0  # parsed but unused, like the reference


_FLOAT_OPTS = {
    "input_expand_coef",
    "expand_coef",
    "width_scale_factor",
    "height_scale_factor",
    "kernel_height_scale_factor",
    "min_kernel_half_height",
    "max_kernel_half_height",
    "kernel_adjust_factor",
    "cube_offcenter_x",
    "cube_offcenter_y",
    "cube_offcenter_z",
    "yaw",
    "pitch",
    "roll",
    "hfov",
    "vfov",
}

_INT_OPTS = {
    "vflip",
    "is_horizontal_offset",
    "enable_low_pass_filter",
    "enable_multi_threading",
    "num_vertical_segments",
    "num_horizontal_segments",
    "adjust_kernel",
    "cube_edge_length",
    "max_cube_edge_length",
    "max_output_w",
    "max_output_h",
}

# ffmpeg option name -> TransformConfig field name, where they differ
# (vf_transform360.c maps e.g. option "yaw" to field fixed_yaw,
#  generate_map at vf_transform360.c:111-139).
_RENAMED = {
    "yaw": "fixed_yaw",
    "pitch": "fixed_pitch",
    "roll": "fixed_roll",
    "hfov": "fixed_hfov",
    "vfov": "fixed_vfov",
    "cube_offcenter_x": "fixed_cube_offcenter_x",
    "cube_offcenter_y": "fixed_cube_offcenter_y",
    "cube_offcenter_z": "fixed_cube_offcenter_z",
}

_BOOL_NAMES = {"true": 1, "false": 0}


def parse_options(option_string: str) -> FilterOptions:
    """Parse an ffmpeg-style ``key=value:key=value`` option string.

    Accepts exactly the option names of the reference filter
    (``vf_transform360.c:407-987``), including upper/lowercase enum value
    names and the ``w``/``width``/``h``/``height``/``size``/``s`` aliases.
    """
    cfg_kw = {}
    opt_kw = {}
    if option_string:
        for item in option_string.split(":"):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"malformed option {item!r}")
            k, v = item.split("=", 1)
            k = k.strip()
            v = v.strip()
            if k in ("w", "width"):
                opt_kw["w_expr"] = v
            elif k in ("h", "height"):
                opt_kw["h_expr"] = v
            elif k in ("size", "s"):
                opt_kw["size_str"] = v
            elif k in ("input_layout", "output_layout"):
                cfg_kw[k] = _parse_layout(v)
            elif k in ("input_stereo_format", "output_stereo_format"):
                cfg_kw[k] = _parse_stereo(v)
            elif k == "interpolation_alg":
                cfg_kw[k] = _parse_interp(v)
            elif k == "vflip":
                cfg_kw[k] = _BOOL_NAMES.get(v.lower(), None)
                if cfg_kw[k] is None:
                    cfg_kw[k] = int(v)
            elif k in _FLOAT_OPTS:
                cfg_kw[_RENAMED.get(k, k)] = float(v)
            elif k in _INT_OPTS:
                if k in ("cube_edge_length", "max_cube_edge_length",
                         "max_output_w", "max_output_h"):
                    opt_kw[k] = int(v)
                else:
                    cfg_kw[k] = int(v)
            else:
                raise ValueError(f"unknown transform360 option {k!r}")

    # ffmpeg init_dict parity (vf_transform360.c:306-326): size and w/h
    # expressions are mutually exclusive; a lone w expression is treated as
    # a size string.
    if opt_kw.get("size_str") and (opt_kw.get("w_expr") or opt_kw.get("h_expr")):
        raise ValueError(
            "Size and width/height expressions cannot be set at the same time."
        )
    if opt_kw.get("w_expr") and not opt_kw.get("h_expr"):
        opt_kw["size_str"], opt_kw["w_expr"] = opt_kw.get("w_expr"), opt_kw.get("size_str")

    return FilterOptions(config=TransformConfig(**cfg_kw), **opt_kw)


def resolve_stereo_formats(
    opts_or_cfg, in_w: int, in_h: int
) -> Tuple[StereoFormat, StereoFormat]:
    """Resolve STEREO_FORMAT_GUESS from the input aspect ratio.

    Parity with ``vf_transform360.c:178-196``: integer aspect ratio 1 → TB,
    4 → LR, else MONO; output GUESS follows input (MONO stays MONO, else LR
    for the 2x3 offcenter cubemap, TB otherwise).
    """
    cfg = opts_or_cfg.config if isinstance(opts_or_cfg, FilterOptions) else opts_or_cfg
    in_fmt = cfg.input_stereo_format
    out_fmt = cfg.output_stereo_format
    if in_fmt == StereoFormat.GUESS:
        aspect_ratio = in_w // in_h
        if aspect_ratio == 1:
            in_fmt = StereoFormat.TB
        elif aspect_ratio == 4:
            in_fmt = StereoFormat.LR
        else:
            in_fmt = StereoFormat.MONO
    if out_fmt == StereoFormat.GUESS:
        if in_fmt == StereoFormat.MONO:
            out_fmt = StereoFormat.MONO
        else:
            out_fmt = (
                StereoFormat.LR
                if cfg.output_layout == Layout.CUBEMAP_23_OFFCENTER
                else StereoFormat.TB
            )
    return in_fmt, out_fmt


def negotiate_output_geometry(
    opts: FilterOptions, in_w: int, in_h: int
) -> Tuple[int, int, TransformConfig]:
    """Compute output dimensions and the resolved (GUESS-free) config.

    Parity with ``config_output`` (``vf_transform360.c:167-304``):

    * GUESS stereo resolution from aspect ratio;
    * ``max_cube_edge_length`` derives cube_edge_length from input width
      (in_w/8 for LR input, else in_w/4), clamped to the max;
    * cube edge rounded down to a multiple of 16 so that encoder
      macroblocks do not cross cube-face boundaries;
    * cube layouts: 3Lx2L (CUBEMAP_32) or 2Lx3L (23_OFFCENTER);
    * otherwise the ``w``/``h`` expression strings are evaluated (with
      ``out_w/ow/out_h/oh`` cross-references, height first, width twice);
    * TB output doubles height, LR output doubles width.
    """
    cfg = opts.config
    in_fmt, out_fmt = resolve_stereo_formats(opts, in_w, in_h)
    cfg = cfg.replace(input_stereo_format=in_fmt, output_stereo_format=out_fmt)

    cube_edge = opts.cube_edge_length
    if opts.max_cube_edge_length > 0:
        if in_fmt == StereoFormat.LR:
            cube_edge = in_w // 8
        else:
            cube_edge = in_w // 4
        cube_edge = min(cube_edge, opts.max_cube_edge_length)

    cube_edge = cube_edge - (cube_edge % 16)

    out_w = out_h = None
    if cube_edge > 0:
        if cfg.output_layout == Layout.CUBEMAP_32:
            out_w, out_h = cube_edge * 3, cube_edge * 2
        elif cfg.output_layout == Layout.CUBEMAP_23_OFFCENTER:
            out_w, out_h = cube_edge * 2, cube_edge * 3
        else:
            # vf_transform360.c:216-224: cube_edge_length set with a
            # non-cubemap layout leaves outlink dims at the ffmpeg default
            # (the input size) and never evaluates the w/h expressions.
            out_w, out_h = in_w, in_h
    if out_w is None:
        w_expr = opts.w_expr
        h_expr = opts.h_expr
        if opts.size_str and not (w_expr or h_expr):
            size = opts.size_str.lower().split("x")
            if len(size) != 2:
                raise ValueError(f"bad size string {opts.size_str!r}")
            w_expr, h_expr = size
        if not w_expr or not h_expr:
            raise ValueError(
                "output size unspecified: need cube_edge_length, size, or w/h"
            )
        # vf_transform360.c:228-287: evaluate w (may be NaN-dependent),
        # then h (may reference out_w), then w again (may reference out_h).
        w = eval_size_expr(w_expr, out_w=None, out_h=None)
        h = eval_size_expr(h_expr, out_w=w, out_h=None)
        w = eval_size_expr(w_expr, out_w=w, out_h=h)
        out_w, out_h = int(w), int(h)

    if out_fmt == StereoFormat.TB:
        out_h *= 2
    elif out_fmt == StereoFormat.LR:
        out_w *= 2

    return out_w, out_h, cfg


@dataclasses.dataclass(frozen=True)
class PixelFormat:
    """Planar pixel-format descriptor — the fields of FFmpeg's
    ``AVPixFmtDescriptor`` that the reference filter actually reads
    (``vf_transform360.c:87-97``: ``log2_chroma_w/h``; ``:368-372``:
    the plane count via the frame's data pointers), plus the per-sample
    bit depth.  The reference wraps every plane as CV_8U bytes
    (``VideoFrameTransform.cpp:1331-1335``) and would CORRUPT >8-bit
    planes; the deep formats here are an intentional capability beyond
    it: samples are little-endian 16-bit containers (ffmpeg ``*le``), which
    the port's kernels take as uint16 planes."""

    name: str
    n_planes: int
    log2_chroma_w: int
    log2_chroma_h: int
    depth: int = 8

    @property
    def dtype(self):
        import numpy as np

        return np.dtype(np.uint8 if self.depth <= 8 else "<u2")

    @property
    def maxval(self) -> int:
        return (1 << self.depth) - 1

    @property
    def neutral(self) -> int:
        """Neutral chroma / barrel UV fill (128 at 8 bit,
        VideoFrameTransform.cpp:743-762, scaled with depth)."""
        return 1 << (self.depth - 1)


PIXEL_FORMATS = {
    pf.name: pf
    for pf in (
        PixelFormat("yuv420p", 3, 1, 1),
        PixelFormat("yuvj420p", 3, 1, 1),
        PixelFormat("yuv422p", 3, 1, 0),
        PixelFormat("yuvj422p", 3, 1, 0),
        PixelFormat("yuv444p", 3, 0, 0),
        PixelFormat("yuvj444p", 3, 0, 0),
        PixelFormat("yuv411p", 3, 2, 0),
        PixelFormat("yuv410p", 3, 2, 2),
        PixelFormat("yuv440p", 3, 0, 1),
        PixelFormat("yuvj440p", 3, 0, 1),
        # Planar RGB: the reference filter declares no pix-fmt list, so
        # FFmpeg will feed it gbrp; every plane is full-res (shifts 0/0)
        # and planes 1/2 ride the "chroma" map like any other format
        # (vf_transform360.c:368-380). Barrel fill stays map-plane-keyed
        # (128 on map plane 1 — faithful to VideoFrameTransform.cpp:743-762
        # even though the planes hold B/R, not chroma).
        PixelFormat("gbrp", 3, 0, 0),
        PixelFormat("gray", 1, 0, 0),
        # High-bit-depth planar formats (beyond the reference — see the
        # class docstring): uint16 planes through the kernels' uint16
        # instantiations.
        PixelFormat("yuv420p10le", 3, 1, 1, depth=10),
        PixelFormat("yuv422p10le", 3, 1, 0, depth=10),
        PixelFormat("yuv444p10le", 3, 0, 0, depth=10),
        PixelFormat("yuv420p12le", 3, 1, 1, depth=12),
        PixelFormat("yuv422p12le", 3, 1, 0, depth=12),
        PixelFormat("yuv444p12le", 3, 0, 0, depth=12),
        PixelFormat("yuv420p16le", 3, 1, 1, depth=16),
        PixelFormat("yuv422p16le", 3, 1, 0, depth=16),
        PixelFormat("yuv444p16le", 3, 0, 0, depth=16),
        PixelFormat("gray10le", 1, 0, 0, depth=10),
        PixelFormat("gray12le", 1, 0, 0, depth=12),
        PixelFormat("gray16le", 1, 0, 0, depth=16),
        PixelFormat("gbrp10le", 3, 0, 0, depth=10),
        PixelFormat("gbrp12le", 3, 0, 0, depth=12),
        PixelFormat("gbrp16le", 3, 0, 0, depth=16),
    )
}
PIXEL_FORMATS["gray8"] = PIXEL_FORMATS["gray"]


def get_pixel_format(pf) -> PixelFormat:
    if isinstance(pf, PixelFormat):
        return pf
    try:
        return PIXEL_FORMATS[str(pf).lower()]
    except KeyError:
        raise ValueError(
            f"unsupported pix_fmt {pf!r} (supported: "
            f"{sorted(set(PIXEL_FORMATS))})"
        ) from None


def chroma_dims(w: int, h: int, pix_fmt="yuv420p") -> Tuple[int, int]:
    """Chroma plane dims via the format's log2 chroma shifts.

    Parity with ``update_plane_sizes`` (``vf_transform360.c:87-97``,
    ``FF_CEIL_RSHIFT(x, s) = -((-x) >> s)``); defaults to yuv420p.
    """
    pf = get_pixel_format(pix_fmt)
    return -((-w) >> pf.log2_chroma_w), -((-h) >> pf.log2_chroma_h)
