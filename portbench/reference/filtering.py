"""Adaptive low-pass prefilter, plan and plain version: the benchmark's
frozen copy of ``transform360_tpu_torch/filtering.py`` (the taps follow
the plane's dtype, so that the control can run it in a lower precision).

Adaptive low-pass prefilter: the plan and the plain version.

The reference antialiases before remap with a segment-wise separable
Gaussian: the frame is split into latitude bands (blur widens toward the
poles) and optionally horizontal tiles with view-direction-adjusted kernels,
each segment filtered by ``cv::sepFilter2D`` (``VideoFrameTransform.cpp:
173-204, 210-501, 579-704``).

The plan math (σ schedule, segment raster, kernel bank) is host-side numpy,
unchanged from ``transform360_tpu.filtering`` (:func:`build_blur_plan`).
:func:`blur_plain` is the plain PyTorch version of the prefilter kernel
(:mod:`transform360_tpu_torch.ops.blur`), a transcription of
``apply_blur``: per latitude band, a horizontal pass with per-column taps,
then a vertical pass, in float32.  Border taps read real neighbour pixels
across band, segment and eye seams and replicate only at true plane edges,
like ``cv::sepFilter2D`` on a non-isolated ROI
(``VideoFrameTransform.cpp:189-197``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Layout, StereoFormat, TransformConfig

_EPS = 1e-9
_K_FOV = 0.5333 * math.pi  # VideoFrameTransform.cpp:35
_K_SPHERE_AREA = 4 * math.pi  # :34

# output layout -> (hFov, vFov), VideoFrameTransform.cpp:405-446
_LAYOUT_FOV = {
    Layout.CUBEMAP_32: (270.0, 180.0),
    Layout.CUBEMAP_23_OFFCENTER: (180.0, 270.0),
    Layout.EQUIRECT: (360.0, 180.0),
    Layout.BARREL: (450.0, 90.0),
    Layout.BARREL_SPLIT: (450.0, 90.0),
    Layout.EAC_32: (270.0, 180.0),
}


def calculate_kernel(sigma: float) -> np.ndarray:
    """1-D Gaussian taps, half-length ``int(2*sigma)``, normalized
    (VideoFrameTransform.cpp:78-94).

    The half-length truncation happens in float32 like the reference's
    ``int boxHalfLength = sigma * 2`` (sigma is a C++ float) — this decides
    kernel length at exact-integer boundaries, so the type matters."""
    box_half = int(np.float32(sigma) * np.float32(2))
    u = np.arange(-box_half, box_half + 1, dtype=np.float64)
    sigma_component = 0.0 if abs(sigma) < _EPS else 0.5 / (sigma * sigma)
    ker = np.exp(-(u * u * sigma_component)).astype(np.float32)
    return ker / ker.sum()


def angular_distance(yaw1, pitch1, yaw2, pitch2) -> float:
    """Great-circle distance in radians (VideoFrameTransform.cpp:125-130)."""
    v = math.sin(pitch1) * math.sin(pitch2) + math.cos(pitch1) * math.cos(
        pitch2
    ) * math.cos(yaw1 - yaw2)
    return math.acos(max(-1.0, min(1.0, v)))


def _sampling_arc(offset, render_arc):
    return math.pi - 2 * math.atan2(
        math.cos(0.5 * render_arc) - offset, math.sin(0.5 * render_arc)
    )


def _spherical_area(angle):
    return (1 - math.cos(0.5 * angle)) * 2 * math.pi


def get_effective_ratio(angular_dist: float, offset: float, fov: float = _K_FOV):
    """Off-center sampling-density model (VideoFrameTransform.cpp:140-170)."""
    if angular_dist - _EPS > fov / 2:
        if angular_dist + fov / 2 > math.pi:
            edge1 = _sampling_arc(offset, (2 * math.pi - angular_dist - fov / 2) * 2) / 2
            edge2 = _sampling_arc(offset, (angular_dist - fov / 2) * 2) / 2
            major = (2 * math.pi - edge1 - edge2) / fov
        else:
            major = (
                _sampling_arc(offset, 2 * angular_dist + fov)
                - _sampling_arc(offset, 2 * angular_dist - fov)
            ) / 2 / fov
    else:
        major = (
            _sampling_arc(offset, 2 * angular_dist + fov)
            + _sampling_arc(offset, fov - 2 * angular_dist)
        ) / 2 / fov
    dist_to_covertex = angular_distance(angular_dist, 0.5 * fov, 0.0, 0.0)
    minor = _sampling_arc(offset, dist_to_covertex * 2) / (dist_to_covertex * 2)
    return min(major * minor * _spherical_area(fov) / _K_SPHERE_AREA, 1.0)


def compute_sigma_y(
    cfg: TransformConfig, in_w: int, in_h: int, out_w: int, out_h: int
) -> float:
    """Base vertical σ from resolution ratio + layout FoV
    (VideoFrameTransform.cpp:448-454).  Dims are per-eye.

    Evaluated in float32 like the reference's all-``float`` expression:
    at boundary configs (e.g. exact ratio 2.0) the f32 rounding decides the
    kernel half-length, so double-precision here would diverge."""
    if cfg.output_layout == Layout.FLAT_FIXED:
        h_fov, v_fov = cfg.fixed_hfov, cfg.fixed_vfov
    else:
        h_fov, v_fov = _LAYOUT_FOV[cfg.output_layout]
    f = np.float32
    ratio = (
        f(cfg.kernel_height_scale_factor)
        * min(f(in_w) / f(360.0), f(in_h) / f(180.0))
        / max(f(out_w) / f(h_fov), f(out_h) / f(v_fov))
    )
    return float(
        f(0.5)
        * min(f(cfg.max_kernel_half_height),
              max(f(cfg.min_kernel_half_height), ratio))
    )


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """One latitude band of the prefilter raster (plan-time, static).

    ``kx``/``ky`` hold the per-tile taps; ``kx_col``/``ky_col`` are the
    same taps expanded to one vector per output column (tile t's taps for
    the columns of tile t) — the form the shift-and-multiply executor
    consumes."""

    top: int
    height: int
    kx: np.ndarray  # [n_tiles, Lx] zero-padded per-tile x taps
    ky: np.ndarray  # [n_tiles, Ly] zero-padded per-tile y taps
    kx_col: np.ndarray  # [Lx, eye_w] per-column x taps
    ky_col: np.ndarray  # [Ly, eye_w] per-column y taps


@dataclasses.dataclass(frozen=True)
class BlurPlan:
    """Full prefilter plan for one (per-eye) plane class.

    ``eye_offsets`` replicates the reference's per-eye application of the
    shared segment configs (``filterPlane``, VideoFrameTransform.cpp:620-704).
    """

    bands: Tuple[BandSpec, ...]
    eye_w: int
    eye_h: int
    n_tiles: int
    tile_w: int
    stereo: StereoFormat  # input stereo format (drives eye offsets)


def _pad_center(kernels: List[np.ndarray]) -> np.ndarray:
    """Stack 1-D kernels of odd, varying length, zero-padded to the max,
    centers aligned.  Exact: taps are already normalized."""
    max_len = max(k.shape[0] for k in kernels)
    out = np.zeros((len(kernels), max_len), np.float32)
    for i, k in enumerate(kernels):
        off = (max_len - k.shape[0]) // 2
        out[i, off : off + k.shape[0]] = k
    return out


def _expand_cols(per_tile: np.ndarray, tile_w: int, width: int) -> np.ndarray:
    """Per-output-column tap vectors [L, width] from per-tile taps
    [n_tiles, L]: column c gets tile ``c // tile_w``'s taps."""
    cols = np.repeat(per_tile, tile_w, axis=0)[:width]
    return np.ascontiguousarray(cols.T)


def _band_kernels(
    cfg: TransformConfig,
    top: int,
    bottom: int,
    angle: float,
    sigma_y: float,
    kernel_y: np.ndarray,
    in_w: int,
    in_h: int,
    n_tiles: int,
    tile_w: int,
) -> BandSpec:
    """Per-band horizontal tiling + per-tile adjusted kernels
    (generateKernelAndFilteringConfig, VideoFrameTransform.cpp:210-297)."""
    sigma_x = min(0.5 * in_w, sigma_y / (math.cos(angle) + _EPS))
    kernel_x = calculate_kernel(sigma_x)
    base_er = get_effective_ratio(0.0, 0.0)
    kxs, kys = [], []
    for i in range(n_tiles):
        if i * tile_w >= in_w:
            break
        width = min(tile_w, in_w - i * tile_w)
        if cfg.adjust_kernel:
            avg_yaw = 2 * math.pi * ((i * tile_w + 0.5 * width) - 0.5 * in_w) / in_w
            avg_pitch = 0.5 * math.pi * (in_h - top - bottom) / in_h
            yaw = cfg.fixed_yaw * math.pi / 180.0
            pitch = cfg.fixed_pitch * math.pi / 180.0
            offset = abs(cfg.fixed_cube_offcenter_z)
            if (
                abs(yaw) < _EPS
                and abs(pitch) < _EPS
                and (
                    abs(cfg.fixed_cube_offcenter_x) > _EPS
                    or abs(cfg.fixed_cube_offcenter_y) > _EPS
                    or cfg.fixed_cube_offcenter_z > _EPS
                )
            ):
                offset = math.sqrt(
                    cfg.fixed_cube_offcenter_x**2
                    + cfg.fixed_cube_offcenter_y**2
                    + cfg.fixed_cube_offcenter_z**2
                )
                yaw = math.atan2(
                    -cfg.fixed_cube_offcenter_x / offset,
                    -cfg.fixed_cube_offcenter_z / offset,
                )
                pitch = math.asin(-cfg.fixed_cube_offcenter_y / offset)
            dist = angular_distance(yaw, pitch, avg_yaw, avg_pitch)
            scale = (
                cfg.kernel_adjust_factor * base_er / get_effective_ratio(dist, offset)
            )
            kxs.append(calculate_kernel(scale * sigma_x))
            kys.append(calculate_kernel(scale * sigma_y))
        else:
            kxs.append(kernel_x)
            kys.append(kernel_y)
    kx_p, ky_p = _pad_center(kxs), _pad_center(kys)
    return BandSpec(
        top=top,
        height=bottom - top + 1,
        kx=kx_p,
        ky=ky_p,
        kx_col=_expand_cols(kx_p, tile_w, in_w),
        ky_col=_expand_cols(ky_p, tile_w, in_w),
    )


def build_blur_plan(
    cfg: TransformConfig, in_w: int, in_h: int, out_w: int, out_h: int
) -> Optional[BlurPlan]:
    """Plan-time segment raster + kernel bank for one plane class.

    Transcribes calcualteFilteringConfig [sic] and
    generateKernelsAndFilteringConfigs (VideoFrameTransform.cpp:318-501):
    stereo dims are halved, latitude bands are laid out symmetrically about
    the equator (odd counts get a centered equator band), and per-band σ_X
    widens as 1/cos(latitude) up to half the width.  ``out_w/out_h`` must be
    the *scaled* (supersampled) output dims, as in the reference call site
    (:560-565).
    """
    if not cfg.enable_low_pass_filter:
        return None
    stereo = cfg.input_stereo_format
    eye_w, eye_h = in_w, in_h
    if stereo == StereoFormat.LR:
        eye_w = int(in_w * 0.5)
    elif stereo == StereoFormat.TB:
        eye_h = int(in_h * 0.5)
    if cfg.output_stereo_format == StereoFormat.LR:
        out_w = int(out_w * 0.5)
    elif cfg.output_stereo_format == StereoFormat.TB:
        out_h = int(out_h * 0.5)

    sigma_y = compute_sigma_y(cfg, eye_w, eye_h, out_w, out_h)
    kernel_y = calculate_kernel(sigma_y)
    base_h = math.ceil(1.0 * eye_h / cfg.num_vertical_segments)
    n_tiles = cfg.num_horizontal_segments if cfg.adjust_kernel else 1
    tile_w = math.ceil(1.0 * eye_w / n_tiles)
    # Tiles beyond the image (i*tile_w >= eye_w) are dropped by the
    # reference's loop guard (:235); mirror that in the effective count.
    n_tiles = min(n_tiles, (eye_w + tile_w - 1) // tile_w)

    bands: List[BandSpec] = []

    def mk(top, bottom, angle):
        bands.append(
            _band_kernels(
                cfg, top, bottom, angle, sigma_y, kernel_y, eye_w, eye_h,
                n_tiles, tile_w,
            )
        )

    def bands_from(start_top: int, start_bottom: int):
        bottom = start_bottom
        while bottom >= 0:  # top half (:329-344)
            top = max(bottom - base_h + 1, 0)
            mk(top, bottom, 0.5 * math.pi * (eye_h - top - bottom) / eye_h)
            bottom -= base_h
        top = start_top
        while top < eye_h:  # bottom half (:348-363)
            bottom = min(top + base_h - 1, eye_h - 1)
            mk(top, bottom, 0.5 * math.pi * (top + bottom - eye_h) / eye_h)
            top += base_h

    if cfg.num_vertical_segments % 2 == 0:
        bands_from(int(0.5 * eye_h), int(0.5 * eye_h) - 1)
    else:
        top = int(0.5 * (eye_h - base_h))
        bottom = top + base_h - 1
        mk(top, bottom, 0.0)  # equator band (:474-500)
        bands_from(bottom + 1, top - 1)

    bands.sort(key=lambda b: b.top)
    # The raster must tile the eye exactly for the concat-based executor.
    cover = 0
    for b in bands:
        assert b.top == cover, f"band raster gap at row {cover}"
        cover += b.height
    assert cover == eye_h, "band raster does not cover the plane"

    return BlurPlan(
        bands=tuple(bands),
        eye_w=eye_w,
        eye_h=eye_h,
        n_tiles=n_tiles,
        tile_w=tile_w,
        stereo=stereo,
    )


# ---------------------------------------------------------------------------
# Execution: the plain version of the prefilter kernel
# ---------------------------------------------------------------------------


def band_radii(band: BandSpec) -> Tuple[int, int]:
    """(rx, ry) kernel radii of a band's (padded) tap bank."""
    return (band.kx.shape[1] - 1) // 2, (band.ky.shape[1] - 1) // 2


def plan_radii(plan: BlurPlan) -> Tuple[int, int]:
    """(rx_max, ry_max) over all bands."""
    rs = [band_radii(b) for b in plan.bands]
    return max(r[0] for r in rs), max(r[1] for r in rs)


def _blur_eye_from(
    plan: BlurPlan, padded: torch.Tensor, roff: int, coff: int,
    rx_max: int, ry_max: int,
) -> torch.Tensor:
    """Blur one eye view, reading from the edge-padded FULL plane.

    ``padded`` is the full source plane padded by (ry_max, rx_max) with
    edge replication; the eye occupies rows ``roff:roff+eye_h`` and cols
    ``coff:coff+eye_w`` of the unpadded plane.  Returns [B, eye_h, eye_w]
    float32."""
    W = plan.eye_w
    outs = []
    for band in plan.bands:
        rx, ry = band_radii(band)
        kx_col = torch.from_numpy(np.ascontiguousarray(band.kx_col)).to(padded.device, padded.dtype)
        ky_col = torch.from_numpy(np.ascontiguousarray(band.ky_col)).to(padded.device, padded.dtype)
        # rows the vertical pass reads, in padded coordinates
        r0 = roff + band.top + ry_max - ry
        rows = padded[:, r0 : r0 + band.height + 2 * ry]
        # horizontal pass: weighted shifts with per-column taps
        c0 = coff + rx_max - rx
        acc = None
        for u in range(2 * rx + 1):
            term = kx_col[u][None, None, :] * rows[:, :, c0 + u : c0 + u + W]
            acc = term if acc is None else acc + term
        rowf = acc
        # vertical pass
        acc = None
        for v in range(2 * ry + 1):
            term = ky_col[v][None, None, :] * rowf[:, v : v + band.height]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def blur_plain(plan: Optional[BlurPlan], plane: torch.Tensor) -> torch.Tensor:
    """Apply the prefilter to a float32 plane [B, H, W] on its device.

    Stereo eyes are processed with the shared per-eye plan, mirroring
    filterPlane's offset application (VideoFrameTransform.cpp:630-691);
    reads cross eye boundaries like the reference's non-isolated ROIs.
    """
    if plan is None:
        return plane
    _, H, W = plane.shape
    rx_max, ry_max = plan_radii(plan)
    dev = plane.device
    rows = torch.clamp(torch.arange(-ry_max, H + ry_max, device=dev), 0, H - 1)
    cols = torch.clamp(torch.arange(-rx_max, W + rx_max, device=dev), 0, W - 1)
    padded = plane[:, rows][:, :, cols]

    def eye(roff, coff):
        return _blur_eye_from(plan, padded, roff, coff, rx_max, ry_max)

    # For odd stereo dims the reference's zero-initialized blurred plane
    # leaves the uncovered final row/column as zeros (filterPlane zeroes the
    # whole destination, VideoFrameTransform.cpp:625); preserved here.
    if plan.stereo == StereoFormat.LR:
        half = plan.eye_w
        rest = torch.zeros_like(plane[:, :, 2 * half :])
        parts = [eye(0, 0), eye(0, half)] + ([rest] if rest.shape[2] else [])
        return torch.cat(parts, dim=2)
    if plan.stereo == StereoFormat.TB:
        half = plan.eye_h
        rest = torch.zeros_like(plane[:, 2 * half :])
        parts = [eye(0, 0), eye(half, 0)] + ([rest] if rest.shape[1] else [])
        return torch.cat(parts, dim=1)
    return eye(0, 0)
