"""Transform plans: the cached per-config artifact.

Per map plane (0 = luma, 1 = chroma; U and V share the chroma plane,
``vf_transform360.c:372``) a :class:`PlanePlan` holds the quantized sample
spec and the prefilter plan.  Plans are built on the CPU once per
(config, size) and memoized; :meth:`PlanePlan.tables` moves their arrays
to a device once and caches them per device.  The remap's tile plan
(:mod:`.ops.window`) is built lazily, on the first batch, by
:meth:`PlanePlan.window_tables`.

:func:`plan_from_jax` converts a ``transform360_tpu`` plan into this
package's, reading its attributes only (no import of jax or of the JAX
package), so both packages can run on the identical plan.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import geometry
from .config import (
    Interpolation,
    Layout,
    StereoFormat,
    TransformConfig,
    chroma_dims,
    get_pixel_format,
)
from .filtering import BandSpec, BlurPlan, build_blur_plan
from .ops.blur import BlurTables
from .ops.window import WindowPlan, WindowTables, build_window_plan
from .sampling import DeviceSpec, SampleSpec, make_sample_spec


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """A plane plan's arrays on one device, in the kernels' form."""

    remap: DeviceSpec
    blur: Optional[BlurTables]


class _DeviceCache:
    """Per-device :class:`DeviceTables` of one plane plan, built once, and
    its window tile plan, built on first use and moved once per device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_device: Dict[str, DeviceTables] = {}
        self._window_plan: Optional[WindowPlan] = None
        self._window_by_device: Dict[str, WindowTables] = {}

    def get(self, pp: "PlanePlan", device: torch.device) -> DeviceTables:
        key = str(device)
        with self._lock:
            hit = self._by_device.get(key)
            if hit is None:
                hit = DeviceTables(
                    remap=DeviceSpec.from_spec(pp.spec, pp.fill, device),
                    blur=None
                    if pp.blur is None
                    else BlurTables.from_plan(pp.blur, pp.in_h, pp.in_w, device),
                )
                self._by_device[key] = hit
            return hit

    def window(self, pp: "PlanePlan", device: torch.device) -> WindowTables:
        key = str(device)
        with self._lock:
            hit = self._window_by_device.get(key)
            if hit is None:
                if self._window_plan is None:
                    self._window_plan = build_window_plan(pp.spec, pp.fill)
                hit = WindowTables.from_plan(self._window_plan, device)
                self._window_by_device[key] = hit
            return hit


@dataclasses.dataclass(frozen=True)
class PlanePlan:
    """Everything needed to transform one plane class (luma or chroma)."""

    key: str
    spec: SampleSpec
    blur: Optional[BlurPlan]
    in_w: int
    in_h: int
    out_w: int
    out_h: int
    fill: int  # transparent-border fill: 0 luma, 128 chroma
    _cache: _DeviceCache = dataclasses.field(
        default_factory=_DeviceCache, compare=False, repr=False
    )

    def tables(self, device) -> DeviceTables:
        """This plan's arrays on ``device`` (moved once, then cached)."""
        return self._cache.get(self, torch.device(device))

    def window_tables(self, device) -> WindowTables:
        """The remap's tile plan on ``device`` (built on the CPU at
        the first call, moved once per device, then cached)."""
        return self._cache.window(self, torch.device(device))


@dataclasses.dataclass(frozen=True)
class TransformPlan:
    cfg: TransformConfig
    in_w: int
    in_h: int
    out_w: int
    out_h: int
    luma: PlanePlan
    chroma: Optional[PlanePlan]  # None for single-plane formats (gray)
    pix_fmt: str = "yuv420p"
    n_planes: int = 3


def _build_plane_plan(
    cfg: TransformConfig,
    in_w: int,
    in_h: int,
    out_w: int,
    out_h: int,
    map_plane_index: int,
) -> PlanePlan:
    """Build one plane-class plan (generateMapForPlane analog,
    VideoFrameTransform.cpp:504-576)."""
    cfg.validate()
    if geometry.scaled_output_dims(cfg, out_w, out_h) != (out_w, out_h):
        raise NotImplementedError(
            "scale factors other than 1 (supersampling + INTER_AREA) are not "
            "ported yet: ROADMAP A6b"
        )
    warp = geometry.build_warp_map(cfg, in_w, in_h, out_w, out_h).numpy()
    is_barrel = cfg.output_layout in (Layout.BARREL, Layout.BARREL_SPLIT)
    spec = make_sample_spec(warp, in_w, in_h, cfg.interpolation_alg, wrap=not is_barrel)
    return PlanePlan(
        key=f"{cfg.cache_key()}:{in_w}x{in_h}:{out_w}x{out_h}:p{map_plane_index}",
        spec=spec,
        blur=build_blur_plan(cfg, in_w, in_h, out_w, out_h),
        in_w=in_w,
        in_h=in_h,
        out_w=out_w,
        out_h=out_h,
        # barrel UV fill 128 (VideoFrameTransform.cpp:743-762)
        fill=128 if map_plane_index else 0,
    )


_PLAN_CACHE: Dict[Tuple, TransformPlan] = {}
_PLAN_LOCK = threading.Lock()


def build_plan(
    cfg: TransformConfig,
    in_w: int,
    in_h: int,
    out_w: int,
    out_h: int,
    pix_fmt="yuv420p",
) -> TransformPlan:
    """Build (or fetch the memoized) full-frame plan.

    Stereo GUESS must already be resolved (see
    :func:`transform360_tpu_torch.config.negotiate_output_geometry`).
    Two map planes serve all image planes: chroma dims come from the pixel
    format's log2 chroma shifts (``vf_transform360.c:87-97,147-162``).
    The cache is locked, so concurrent engines build a plan once.
    """
    if StereoFormat.GUESS in (cfg.input_stereo_format, cfg.output_stereo_format):
        raise ValueError("resolve GUESS stereo formats before building a plan")
    pf = get_pixel_format(pix_fmt)
    if pf.depth > 8:
        raise NotImplementedError(
            f"{pf.name}: deep formats are not ported yet (the kernels are "
            "uint8-only): ROADMAP A10"
        )
    key = (cfg.cache_key(), in_w, in_h, out_w, out_h, pf.name)
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
        chroma = None
        if pf.n_planes > 1:
            c_in_w, c_in_h = chroma_dims(in_w, in_h, pf)
            c_out_w, c_out_h = chroma_dims(out_w, out_h, pf)
            chroma = _build_plane_plan(cfg, c_in_w, c_in_h, c_out_w, c_out_h, 1)
        plan = TransformPlan(
            cfg=cfg,
            in_w=in_w,
            in_h=in_h,
            out_w=out_w,
            out_h=out_h,
            luma=_build_plane_plan(cfg, in_w, in_h, out_w, out_h, 0),
            chroma=chroma,
            pix_fmt=pf.name,
            n_planes=pf.n_planes,
        )
        _PLAN_CACHE[key] = plan
        return plan


def clear_plan_cache() -> None:
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


# ---------------------------------------------------------------------------
# The JAX package's plan, carried across
# ---------------------------------------------------------------------------

_ENUM_FIELDS = {
    "input_layout": Layout,
    "output_layout": Layout,
    "input_stereo_format": StereoFormat,
    "output_stereo_format": StereoFormat,
    "interpolation_alg": Interpolation,
}


def config_from_jax(cfg) -> TransformConfig:
    """This package's config from a ``transform360_tpu`` one (field by field)."""
    kw = {}
    for f in dataclasses.fields(TransformConfig):
        v = getattr(cfg, f.name)
        kw[f.name] = _ENUM_FIELDS[f.name](int(v)) if f.name in _ENUM_FIELDS else v
    return TransformConfig(**kw)


def _plane_from(pp) -> Optional[PlanePlan]:
    if pp is None:
        return None
    if pp.area_row is not None:
        raise NotImplementedError(
            "plans with INTER_AREA supersampling are not ported yet: ROADMAP A6b"
        )
    if pp.depth > 8:
        raise NotImplementedError("deep formats are not ported yet: ROADMAP A10")
    s = pp.spec
    spec = SampleSpec(
        base_y=np.asarray(s.base_y, np.int32),
        base_x=np.asarray(s.base_x, np.int32),
        frac_y=np.asarray(s.frac_y, np.float32),
        frac_x=np.asarray(s.frac_x, np.float32),
        valid=None if s.valid is None else np.asarray(s.valid, bool),
        in_w=int(s.in_w),
        in_h=int(s.in_h),
        interp=Interpolation(int(s.interp)),
        wrap=bool(s.wrap),
    )
    blur = None
    if pp.blur is not None:
        b = pp.blur
        blur = BlurPlan(
            bands=tuple(
                BandSpec(
                    top=int(band.top),
                    height=int(band.height),
                    kx=np.asarray(band.kx, np.float32),
                    ky=np.asarray(band.ky, np.float32),
                    kx_col=np.asarray(band.kx_col, np.float32),
                    ky_col=np.asarray(band.ky_col, np.float32),
                )
                for band in b.bands
            ),
            eye_w=int(b.eye_w),
            eye_h=int(b.eye_h),
            n_tiles=int(b.n_tiles),
            tile_w=int(b.tile_w),
            stereo=StereoFormat(int(b.stereo)),
        )
    return PlanePlan(
        key=str(pp.key),
        spec=spec,
        blur=blur,
        in_w=int(pp.in_w),
        in_h=int(pp.in_h),
        out_w=int(pp.out_w),
        out_h=int(pp.out_h),
        fill=int(pp.fill),
    )


def plan_from_jax(jax_plan) -> TransformPlan:
    """This package's plan from a ``transform360_tpu`` ``TransformPlan``:
    the sample-spec arrays, the blur bands, fill and dims (8-bit only).
    The input is read by attribute only, so jax is never imported here."""
    return TransformPlan(
        cfg=config_from_jax(jax_plan.cfg),
        in_w=int(jax_plan.in_w),
        in_h=int(jax_plan.in_h),
        out_w=int(jax_plan.out_w),
        out_h=int(jax_plan.out_h),
        luma=_plane_from(jax_plan.luma),
        chroma=_plane_from(jax_plan.chroma),
        pix_fmt=str(jax_plan.pix_fmt),
        n_planes=int(jax_plan.n_planes),
    )
