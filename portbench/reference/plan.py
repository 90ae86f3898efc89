"""The reference's plan and its plane pipeline.

:func:`open_plan` does what the filter shell does before the first frame
(``open_filter`` then ``generate_map``): parse the options, negotiate the
output geometry, resolve a guessed stereo format, and build one plan per
map plane (luma, and the chroma plane that U and V share).
:func:`transform` runs frames through it: prefilter, half-up round,
remap, half-up round, and, for a supersampled plan, INTER_AREA and a
third round, in blocks of frames so that a large batch fits beside the
program's state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import geometry
from .config import (
    Layout,
    StereoFormat,
    TransformConfig,
    chroma_dims,
    get_pixel_format,
    negotiate_output_geometry,
    parse_options,
)
from .filtering import BlurPlan, blur_plain, build_blur_plan
from .sampling import (
    AreaTables,
    DeviceArea,
    DeviceSpec,
    SampleSpec,
    area_resize,
    make_sample_spec,
    remap_plain,
    round_px,
    sample_dtype,
)


@dataclasses.dataclass(frozen=True)
class PlanePlan:
    """One map plane: its sample spec at the scaled size, its prefilter
    plan, its INTER_AREA tables (a supersampled plan), fill and depth."""

    spec: SampleSpec
    blur: Optional[BlurPlan]
    in_w: int
    in_h: int
    out_w: int
    out_h: int
    scaled_w: int
    scaled_h: int
    fill: int
    area: Optional[AreaTables]
    depth: int

    @property
    def maxval(self) -> int:
        return (1 << self.depth) - 1

    @property
    def dtype(self) -> torch.dtype:
        return sample_dtype(self.depth)


@dataclasses.dataclass(frozen=True)
class Plan:
    cfg: TransformConfig
    in_w: int
    in_h: int
    out_w: int
    out_h: int
    luma: PlanePlan
    chroma: Optional[PlanePlan]
    pix_fmt: str
    n_planes: int

    def plane_plans(self) -> Tuple[PlanePlan, ...]:
        """The map plane of each image plane, in order (U and V share
        the chroma plane)."""
        return (self.luma,) + (self.chroma,) * (self.n_planes - 1)


def _plane_plan(cfg: TransformConfig, in_w: int, in_h: int, out_w: int, out_h: int,
                map_plane: int, depth: int) -> PlanePlan:
    warp = geometry.build_warp_map(cfg, in_w, in_h, out_w, out_h).numpy()
    scaled_h, scaled_w = warp.shape[:2]
    barrel = cfg.output_layout in (Layout.BARREL, Layout.BARREL_SPLIT)
    resize = (scaled_w, scaled_h) != (out_w, out_h)
    return PlanePlan(
        spec=make_sample_spec(warp, in_w, in_h, cfg.interpolation_alg, wrap=not barrel),
        # the prefilter is planned for the scaled size, as the filter calls it
        blur=build_blur_plan(cfg, in_w, in_h, scaled_w, scaled_h),
        in_w=in_w, in_h=in_h, out_w=out_w, out_h=out_h,
        scaled_w=scaled_w, scaled_h=scaled_h,
        # barrel UV fill 128, scaled to the format's neutral value
        fill=(128 << (depth - 8)) if map_plane else 0,
        area=AreaTables.build(scaled_w, scaled_h, out_w, out_h) if resize else None,
        depth=depth,
    )


def open_plan(options: str, in_w: int, in_h: int, pix_fmt: str = "yuv420p") -> Plan:
    """The plan of the filter opened with ``options`` on ``in_w`` x
    ``in_h`` frames of ``pix_fmt``."""
    out_w, out_h, cfg = negotiate_output_geometry(parse_options(options), in_w, in_h)
    cfg.validate()
    if StereoFormat.GUESS in (cfg.input_stereo_format, cfg.output_stereo_format):
        raise ValueError("the output geometry left a guessed stereo format")
    pf = get_pixel_format(pix_fmt)
    chroma = None
    if pf.n_planes > 1:
        (ciw, cih), (cow, coh) = chroma_dims(in_w, in_h, pf), chroma_dims(out_w, out_h, pf)
        chroma = _plane_plan(cfg, ciw, cih, cow, coh, 1, pf.depth)
    return Plan(cfg=cfg, in_w=in_w, in_h=in_h, out_w=out_w, out_h=out_h,
                luma=_plane_plan(cfg, in_w, in_h, out_w, out_h, 0, pf.depth),
                chroma=chroma, pix_fmt=pf.name, n_planes=pf.n_planes)


class Tables:
    """A plan's arrays on one device, moved once per map plane."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._remap: Dict[int, DeviceSpec] = {}
        self._area: Dict[int, DeviceArea] = {}

    def remap(self, pp: PlanePlan) -> DeviceSpec:
        if id(pp) not in self._remap:
            self._remap[id(pp)] = DeviceSpec.from_spec(pp.spec, pp.fill, self.device)
        return self._remap[id(pp)]

    def area(self, pp: PlanePlan) -> DeviceArea:
        if id(pp) not in self._area:
            self._area[id(pp)] = DeviceArea.from_tables(pp.area, self.device)
        return self._area[id(pp)]


def transform_plane(pp: PlanePlan, x: torch.Tensor, tables: Tables,
                    dt: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, in_h, in_w]`` samples → ``[B, out_h, out_w]`` samples of the
    plane's dtype, every stage computed in ``dt`` and rounded half up."""
    if pp.blur is not None:
        x = round_px(blur_plain(pp.blur, x.to(dt)), pp.maxval, pp.dtype)
    out = round_px(remap_plain(tables.remap(pp), x, dt), pp.maxval, pp.dtype)
    if pp.area is not None:
        out = round_px(area_resize(tables.area(pp), out, dt), pp.maxval, pp.dtype)
    return out


def transform(plan: Plan, planes: Sequence[torch.Tensor], tables: Tables,
              dt: torch.dtype = torch.float32, block: int = 8) -> Tuple[torch.Tensor, ...]:
    """``[B, H, W]`` image planes (each on ``tables.device``) → output
    planes, ``block`` frames at a time."""
    if len(planes) != plan.n_planes:
        raise ValueError(f"expected {plan.n_planes} planes, got {len(planes)}")
    outs = []
    for pp, x in zip(plan.plane_plans(), planes):
        if tuple(x.shape[1:]) != (pp.in_h, pp.in_w) or x.dtype != pp.dtype:
            raise ValueError(f"plane {tuple(x.shape)} {x.dtype} does not fit the plan")
        outs.append(torch.cat([transform_plane(pp, x[i:i + block], tables, dt)
                               for i in range(0, x.shape[0], block)]))
    return tuple(outs)
