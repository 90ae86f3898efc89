"""Transform plans: the cached per-config artifact.

Per map plane (0 = luma, 1 = chroma; U and V share the chroma plane,
``vf_transform360.c:372``) a :class:`PlanePlan` holds the quantized sample
spec, the prefilter plan, the INTER_AREA band tables of a supersampled
config, and the sample depth.  Plans are built on the CPU once per
(config, size, pixel format) and memoized; :meth:`PlanePlan.tables` moves
their arrays to a device once and caches them per device.  The remap's
tile plan (:mod:`.ops.window`) is built lazily, on the first batch, by
:meth:`PlanePlan.window_tables`.

:func:`plan_from_jax` converts a ``transform360_tpu`` plan into this
package's, reading its attributes only (no import of jax or of the JAX
package), so both packages can run on the identical plan.
:func:`save_plan`/:func:`load_plan` read and write the JAX package's
``.npz`` plan files, so a plan written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
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
from .filtering import BandSpec, BlurPlan, _expand_cols, build_blur_plan
from .ops.blur import BlurTables
from .ops.window import WindowPlan, WindowTables, build_window_plan
from .sampling import (
    AreaTables,
    DeviceArea,
    SampleSpec,
    make_sample_spec,
    sample_dtype,
)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """K1's and K4's tables of a plane plan on one device (K3's:
    :meth:`PlanePlan.window_tables`)."""

    blur: Optional[BlurTables]
    area: Optional[DeviceArea]


class _DeviceCache:
    """Per-device :class:`DeviceTables` of one plane plan, built once, its
    window tile plan (for the plan's sample size), built on first use and
    moved once per device, and the hash of its content."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_device: Dict[str, DeviceTables] = {}
        self._window_plan: Optional[WindowPlan] = None
        self._window_by_device: Dict[str, WindowTables] = {}
        self._digest: Optional[str] = None

    def digest(self, pp: "PlanePlan") -> str:
        with self._lock:
            if self._digest is None:
                h = hashlib.blake2b(digest_size=16)
                _feed(h, pp)
                self._digest = h.hexdigest()
            return self._digest

    def get(self, pp: "PlanePlan", device: torch.device) -> DeviceTables:
        key = str(device)
        with self._lock:
            hit = self._by_device.get(key)
            if hit is None:
                hit = DeviceTables(
                    blur=None
                    if pp.blur is None
                    else BlurTables.from_plan(pp.blur, pp.in_h, pp.in_w, device,
                                              pp.sample_bytes),
                    area=None if pp.area is None else DeviceArea.from_tables(pp.area, device),
                )
                self._by_device[key] = hit
            return hit

    def _host_window_plan(self, pp: "PlanePlan") -> WindowPlan:
        if self._window_plan is None:  # the caller holds the lock
            self._window_plan = build_window_plan(pp.spec, pp.fill, pp.sample_bytes)
        return self._window_plan

    def window_plan(self, pp: "PlanePlan") -> WindowPlan:
        with self._lock:
            return self._host_window_plan(pp)

    def window(self, pp: "PlanePlan", device: torch.device) -> WindowTables:
        key = str(device)
        with self._lock:
            hit = self._window_by_device.get(key)
            if hit is None:
                hit = WindowTables.from_plan(self._host_window_plan(pp), device)
                self._window_by_device[key] = hit
            return hit


def _feed(h, v) -> None:
    """Hash ``v``'s content: a dataclass by its compared fields, arrays by
    dtype, shape and bytes, sequences item by item, anything else by repr."""
    if dataclasses.is_dataclass(v):
        h.update(type(v).__name__.encode())
        for f in dataclasses.fields(v):
            if f.compare:
                h.update(f.name.encode())
                _feed(h, getattr(v, f.name))
    elif isinstance(v, np.ndarray):
        h.update(f"{v.dtype}{v.shape}".encode())
        h.update(np.ascontiguousarray(v).reshape(-1).view(np.uint8))
    elif isinstance(v, (tuple, list)):
        h.update(f"[{len(v)}".encode())
        for x in v:
            _feed(h, x)
    else:
        h.update(repr(v).encode())


@dataclasses.dataclass(frozen=True)
class PlanePlan:
    """Everything needed to transform one plane class (luma or chroma)."""

    key: str
    spec: SampleSpec  # at the scaled (warp-map) size
    blur: Optional[BlurPlan]
    in_w: int
    in_h: int
    out_w: int  # final output dims (after INTER_AREA if scaled)
    out_h: int
    scaled_w: int  # warp-map dims (== out dims unless supersampling)
    scaled_h: int
    fill: int  # transparent-border fill: 0 luma, neutral chroma (128 << depth - 8)
    area: Optional[AreaTables]  # INTER_AREA from scaled to out dims, or None
    depth: int  # sample bit depth: uint8 planes up to 8, else uint16
    # built anew for every plan, also by dataclasses.replace
    _cache: _DeviceCache = dataclasses.field(
        default_factory=_DeviceCache, init=False, compare=False, repr=False
    )

    @property
    def sample_bytes(self) -> int:
        return 1 if self.depth <= 8 else 2

    @property
    def maxval(self) -> int:
        return (1 << self.depth) - 1

    @property
    def dtype(self) -> torch.dtype:
        return sample_dtype(self.depth)

    def tables(self, device) -> DeviceTables:
        """This plan's arrays on ``device`` (moved once, then cached)."""
        return self._cache.get(self, torch.device(device))

    def window_tables(self, device) -> WindowTables:
        """The remap's tile plan on ``device`` for this plan's samples
        (built on the CPU at the first call, moved once per device, then
        cached)."""
        return self._cache.window(self, torch.device(device))

    def window_plan(self) -> WindowPlan:
        """The remap's host (numpy) tile plan for this plan's samples,
        built once and shared with :meth:`window_tables`."""
        return self._cache.window_plan(self)

    def digest(self) -> str:
        """A hash of the plan's content (every field but its device
        cache), computed once: plans with one ``key`` may still differ
        (a plan built here and the JAX package's, through
        :func:`plan_from_jax`, can part in a rounding tie)."""
        return self._cache.digest(self)


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
    depth: int = 8,
) -> PlanePlan:
    """Build one plane-class plan (generateMapForPlane analog,
    VideoFrameTransform.cpp:504-576)."""
    cfg.validate()
    warp = geometry.build_warp_map(cfg, in_w, in_h, out_w, out_h).numpy()
    scaled_h, scaled_w = warp.shape[:2]
    is_barrel = cfg.output_layout in (Layout.BARREL, Layout.BARREL_SPLIT)
    spec = make_sample_spec(warp, in_w, in_h, cfg.interpolation_alg, wrap=not is_barrel)
    key = f"{cfg.cache_key()}:{in_w}x{in_h}:{out_w}x{out_h}:p{map_plane_index}"
    if depth != 8:
        key += f":d{depth}"
    resize = (scaled_w, scaled_h) != (out_w, out_h)
    return PlanePlan(
        key=key,
        spec=spec,
        # the prefilter is planned for the scaled size, as the reference
        # calls it (VideoFrameTransform.cpp:560-565)
        blur=build_blur_plan(cfg, in_w, in_h, scaled_w, scaled_h),
        in_w=in_w,
        in_h=in_h,
        out_w=out_w,
        out_h=out_h,
        scaled_w=scaled_w,
        scaled_h=scaled_h,
        # barrel UV fill 128 (VideoFrameTransform.cpp:743-762), scaled to
        # the format's neutral value at higher bit depths
        fill=(128 << (depth - 8)) if map_plane_index else 0,
        area=AreaTables.build(scaled_w, scaled_h, out_w, out_h) if resize else None,
        depth=depth,
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
    key = (cfg.cache_key(), in_w, in_h, out_w, out_h, pf.name)
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
        if hit is not None:
            return hit
        chroma = None
        if pf.n_planes > 1:
            c_in_w, c_in_h = chroma_dims(in_w, in_h, pf)
            c_out_w, c_out_h = chroma_dims(out_w, out_h, pf)
            chroma = _build_plane_plan(cfg, c_in_w, c_in_h, c_out_w, c_out_h, 1, pf.depth)
        plan = TransformPlan(
            cfg=cfg,
            in_w=in_w,
            in_h=in_h,
            out_w=out_w,
            out_h=out_h,
            luma=_build_plane_plan(cfg, in_w, in_h, out_w, out_h, 0, pf.depth),
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


def _spec_from(s) -> SampleSpec:
    """A :class:`SampleSpec` from anything with its array attributes."""
    return SampleSpec(
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


def _plane_from(pp) -> Optional[PlanePlan]:
    if pp is None:
        return None
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
        spec=_spec_from(pp.spec),
        blur=blur,
        in_w=int(pp.in_w),
        in_h=int(pp.in_h),
        out_w=int(pp.out_w),
        out_h=int(pp.out_h),
        scaled_w=int(pp.scaled_w),
        scaled_h=int(pp.scaled_h),
        fill=int(pp.fill),
        area=None
        if pp.area_row is None
        else AreaTables.from_matrices(np.asarray(pp.area_row), np.asarray(pp.area_col)),
        depth=int(pp.depth),
    )


def plan_from_jax(jax_plan) -> TransformPlan:
    """This package's plan from a ``transform360_tpu`` ``TransformPlan``:
    the sample-spec arrays, the blur bands, the INTER_AREA matrices (as
    band tables), fill, depth and dims.  The input is read by attribute
    only, so jax is never imported here."""
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


# ---------------------------------------------------------------------------
# Plan files: the JAX package's versioned .npz (numpy arrays and a JSON
# header; transform360_tpu/plan.py:205-622), so a restarted transcoder
# skips map generation and a plan moves between the two packages.  No
# pickle anywhere (allow_pickle=False), so an untrusted file cannot run
# code on load; unknown formats and versions are rejected.
#   v1: sample spec, blur bands, INTER_AREA matrices;
#   v2: + the TPU lane-kernel plans ("kernel_plans" and the *.lane.* and
#       *.blur_lane.* arrays), which are TPU artifacts: read past here;
#   v3: arrays stored exactly in fewer bytes (integers in the smallest
#       dtype that holds their range, floats with few distinct values as
#       a value table and codes).  Written here with no kernel plans.
# ---------------------------------------------------------------------------

PLAN_FORMAT = "transform360_tpu-plan"
PLAN_FORMAT_VERSION = 3
_INT_DTYPES = (np.uint8, np.int16, np.uint16, np.int32)


def _encode_arrays(arrays: Dict[str, np.ndarray]):
    """The v3 codec: ``(packed, enc)``, where ``enc`` records how each
    array that shrank was stored: ``{"c": "int", "dtype": d}`` (an integer
    array in a smaller dtype; cast back to ``d``) or ``{"c": "dict",
    "dtype": d}`` (codes in ``name``, values in ``name.enc_uniq``).  An
    integer array is downcast only to a dtype that holds its whole range
    (the JAX package's encoder downcasts to int32 even when none does,
    ``transform360_tpu/plan.py:253``, and truncates such data)."""
    packed: Dict[str, np.ndarray] = {}
    enc: Dict[str, dict] = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.kind in "iu" and a.size and a.itemsize > 1:
            lo, hi = int(a.min()), int(a.max())
            dt = next((d for d in _INT_DTYPES
                       if np.iinfo(d).min <= lo and hi <= np.iinfo(d).max), None)
            if dt is not None and np.dtype(dt).itemsize < a.itemsize:
                packed[k] = a.astype(dt)
                enc[k] = {"c": "int", "dtype": a.dtype.name}
                continue
        elif a.dtype.kind == "f" and a.size > 4096:
            uniq, codes = np.unique(a, return_inverse=True)
            if uniq.size <= np.iinfo(np.uint16).max + 1:
                ct = np.uint8 if uniq.size <= 256 else np.uint16
                packed[k] = codes.astype(ct).reshape(a.shape)
                packed[f"{k}.enc_uniq"] = uniq
                enc[k] = {"c": "dict", "dtype": a.dtype.name}
                continue
        packed[k] = a
    return packed, enc


class _Decoded:
    """A plan file's arrays with the v3 encoding undone (v1 and v2 files
    have no ``enc`` record, so their arrays read as stored)."""

    def __init__(self, data, enc: Dict[str, dict]):
        self._data = data
        self._enc = enc

    def __contains__(self, k: str) -> bool:
        return k in self._data.files

    def __getitem__(self, k: str) -> np.ndarray:
        a = self._data[k]
        e = self._enc.get(k)
        if e is None:
            return a
        if e.get("c") == "int":
            return a.astype(np.dtype(e["dtype"]))
        if e.get("c") == "dict":
            return self._data[f"{k}.enc_uniq"].astype(np.dtype(e["dtype"]))[a]
        raise ValueError(f"unknown encoding {e!r} of plan array {k!r}")


def _plane_arrays(prefix: str, pp: PlanePlan) -> Dict[str, np.ndarray]:
    arrs = {
        f"{prefix}.base_y": pp.spec.base_y,
        f"{prefix}.base_x": pp.spec.base_x,
        f"{prefix}.frac_y": pp.spec.frac_y,
        f"{prefix}.frac_x": pp.spec.frac_x,
    }
    if pp.spec.valid is not None:
        arrs[f"{prefix}.valid"] = pp.spec.valid
    if pp.blur is not None:
        for k, band in enumerate(pp.blur.bands):
            arrs[f"{prefix}.band{k}.kx"] = band.kx
            arrs[f"{prefix}.band{k}.ky"] = band.ky
    if pp.area is not None:  # the dense matrices, as the JAX package keeps them
        arrs[f"{prefix}.area_row"] = pp.area.row.matrix()
        arrs[f"{prefix}.area_col"] = pp.area.col.matrix()
    return arrs


def _plane_meta(pp: PlanePlan) -> dict:
    meta = {
        "key": pp.key,
        "in_w": pp.in_w,
        "in_h": pp.in_h,
        "out_w": pp.out_w,
        "out_h": pp.out_h,
        "scaled_w": pp.scaled_w,
        "scaled_h": pp.scaled_h,
        "fill": pp.fill,
        "depth": pp.depth,
        "wrap": pp.spec.wrap,
        "interp": int(pp.spec.interp),
        "blur": None,
    }
    if pp.blur is not None:
        meta["blur"] = {
            "eye_w": pp.blur.eye_w,
            "eye_h": pp.blur.eye_h,
            "n_tiles": pp.blur.n_tiles,
            "tile_w": pp.blur.tile_w,
            "stereo": int(pp.blur.stereo),
            "bands": [{"top": b.top, "height": b.height} for b in pp.blur.bands],
        }
    return meta


def _plane_from_file(prefix: str, meta: dict, data: _Decoded) -> PlanePlan:
    spec = SampleSpec(
        base_y=np.asarray(data[f"{prefix}.base_y"], np.int32),
        base_x=np.asarray(data[f"{prefix}.base_x"], np.int32),
        frac_y=np.asarray(data[f"{prefix}.frac_y"], np.float32),
        frac_x=np.asarray(data[f"{prefix}.frac_x"], np.float32),
        valid=np.asarray(data[f"{prefix}.valid"], bool) if f"{prefix}.valid" in data else None,
        in_w=int(meta["in_w"]),
        in_h=int(meta["in_h"]),
        interp=Interpolation(int(meta["interp"])),
        wrap=bool(meta["wrap"]),
    )
    blur = None
    bm = meta["blur"]
    if bm is not None:

        def band(k, b):
            kx = np.asarray(data[f"{prefix}.band{k}.kx"], np.float32)
            ky = np.asarray(data[f"{prefix}.band{k}.ky"], np.float32)
            # the column-expanded taps are derived, not stored
            return BandSpec(
                top=int(b["top"]),
                height=int(b["height"]),
                kx=kx,
                ky=ky,
                kx_col=_expand_cols(kx, bm["tile_w"], bm["eye_w"]),
                ky_col=_expand_cols(ky, bm["tile_w"], bm["eye_w"]),
            )

        blur = BlurPlan(
            bands=tuple(band(k, b) for k, b in enumerate(bm["bands"])),
            eye_w=int(bm["eye_w"]),
            eye_h=int(bm["eye_h"]),
            n_tiles=int(bm["n_tiles"]),
            tile_w=int(bm["tile_w"]),
            stereo=StereoFormat(int(bm["stereo"])),
        )
    area = None
    if f"{prefix}.area_row" in data:
        area = AreaTables.from_matrices(data[f"{prefix}.area_row"], data[f"{prefix}.area_col"])
    return PlanePlan(
        key=str(meta["key"]),
        spec=spec,
        blur=blur,
        in_w=int(meta["in_w"]),
        in_h=int(meta["in_h"]),
        out_w=int(meta["out_w"]),
        out_h=int(meta["out_h"]),
        scaled_w=int(meta["scaled_w"]),
        scaled_h=int(meta["scaled_h"]),
        fill=int(meta["fill"]),
        area=area,
        depth=int(meta.get("depth", 8)),
    )


def save_plan(plan: TransformPlan, path: str) -> None:
    """Write ``plan`` as a v3 plan file that this package's and the JAX
    package's :func:`load_plan` both read (with no kernel plans: each
    package builds its own kernels' plans from the spec)."""
    payload = _plane_arrays("luma", plan.luma)
    if plan.chroma is not None:
        payload.update(_plane_arrays("chroma", plan.chroma))
    packed, enc = _encode_arrays(payload)
    header = {
        "format": PLAN_FORMAT,
        "version": PLAN_FORMAT_VERSION,
        "cfg": {
            k: (int(v) if isinstance(v, (Layout, StereoFormat, Interpolation)) else v)
            for k, v in dataclasses.asdict(plan.cfg).items()
        },
        "in_w": plan.in_w,
        "in_h": plan.in_h,
        "out_w": plan.out_w,
        "out_h": plan.out_h,
        "pix_fmt": plan.pix_fmt,
        "n_planes": plan.n_planes,
        "luma": _plane_meta(plan.luma),
        "chroma": None if plan.chroma is None else _plane_meta(plan.chroma),
        "kernel_plans": {},
        "enc": enc,
    }
    header_bytes = np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, header=header_bytes, **packed)


def load_plan(path: str) -> TransformPlan:
    """A plan from a file of either package (versions 1, 2 and 3).  The
    JAX package's TPU kernel plans in it are not read."""
    with np.load(path, allow_pickle=False) as raw:
        if "header" not in raw.files:
            raise ValueError(f"{path} is not a transform360_tpu plan file")
        try:
            header = json.loads(bytes(raw["header"]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path} has an unreadable plan header") from e
        if not isinstance(header, dict) or header.get("format") != PLAN_FORMAT:
            raise ValueError(f"{path} is not a transform360_tpu plan file")
        if header.get("version") not in (1, 2, PLAN_FORMAT_VERSION):
            raise ValueError(
                f"unsupported plan version {header.get('version')!r} "
                f"(supported: 1, 2, {PLAN_FORMAT_VERSION})"
            )
        data = _Decoded(raw, header.get("enc") or {})
        cfg = {f.name: header["cfg"][f.name] for f in dataclasses.fields(TransformConfig)}
        for k, enum_t in _ENUM_FIELDS.items():
            cfg[k] = enum_t(cfg[k])
        return TransformPlan(
            cfg=TransformConfig(**cfg),
            in_w=int(header["in_w"]),
            in_h=int(header["in_h"]),
            out_w=int(header["out_w"]),
            out_h=int(header["out_h"]),
            luma=_plane_from_file("luma", header["luma"], data),
            chroma=None
            if header["chroma"] is None
            else _plane_from_file("chroma", header["chroma"], data),
            pix_fmt=str(header.get("pix_fmt", "yuv420p")),
            n_planes=int(header.get("n_planes", 3)),
        )
