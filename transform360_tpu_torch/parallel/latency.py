"""Single-frame latency sharding: output row-bands across devices.

The port of ``transform360_tpu.parallel.latency``.  The batch mesh
(:mod:`.mesh`) scales throughput; it does nothing for the latency of one
frame.  So the OUTPUT rows of one frame are split into bands, one per
device.  Every plan array (first taps, fractions, masks, INTER_AREA rows)
is indexed by output pixel, so a row slice of a plane plan is itself a
plane plan (:func:`band_plans`).  Each band runs the plan's frame path,
K1 and then K3 (:func:`..pipeline.transform_frame_planes`), on its device
against the input planes there: no collective, the planes copied to a
device once (none where they already lie on it) and small band outputs
back.  Its plane plans have executors of their own per device and shape
(the JAX package's ``_band_executor``): a banded frame replays one
captured CUDA graph per band and plane, each reading the frame's planes
where they lie on the card, so a banded frame makes no copy of the frame
there.

Trade-off (the JAX package's): the prefilter works on the input plane, so
every band blurs the whole input plane: duplicated work that bounds the
speedup at ``(blur + remap / N) / (blur + remap)``.  Bands dealt to one
device run one after another on its current stream, so on one GPU a
banded frame is slower than the unbanded one.

Composition:

- **bands x frames grid** (:func:`transform_frame_banded_async`): every
  band is dispatched before any is gathered, so the CLI can keep one
  frame per device group in flight;
- **multi-process band groups** (``bands_slice``): each process runs a
  contiguous group of the global bands (:func:`local_band_range`) and
  holds that row slice of the output;
- **input broadcast model** (:func:`broadcast_ms`): the per-frame cost of
  copying the input to every band's device.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import chroma_dims
from ..ops import window
from ..pipeline import as_plane, drop_executors, transform_frame_planes
from ..plan import PlanePlan, TransformPlan
from ..sampling import AreaAxis, AreaTables
from . import distributed
from .mesh import default_devices, make_mesh


def _slice_area_rows(axis: AreaAxis, y0: int, y1: int) -> Tuple[AreaAxis, int, int]:
    """Output rows ``[y0, y1)`` of an INTER_AREA row axis over the
    contiguous support ``[s0, s1)`` of scaled rows they read: ``first``
    shifted by ``-s0`` and ``n_in = s1 - s0``, so that
    :meth:`~..sampling.AreaAxis.indices` clamps the zero-weight padding
    into the band (``from_matrix`` clamped it into the whole scaled
    height, which lies outside the band's remap output)."""
    first = axis.first[y0:y1].astype(np.int64)
    w = axis.weights[y0:y1]
    last = first + (w.shape[1] - 1 - (w != 0)[:, ::-1].argmax(axis=1))
    s0, s1 = int(first.min()), int(last.max()) + 1
    band = AreaAxis(first=(first - s0).astype(np.int32), weights=np.ascontiguousarray(w),
                    n_in=s1 - s0)
    return band, s0, s1


def _slice_plane(pp: PlanePlan, y0: int, y1: int) -> PlanePlan:
    """Row band ``[y0, y1)`` of a plane plan's OUTPUT (final, after any
    INTER_AREA resize), with its own key and (as every plan made by
    ``dataclasses.replace``) device cache: its tables and the remap's tile
    plan are built for the band's rows."""
    area = pp.area
    if area is not None:
        row, s0, s1 = _slice_area_rows(area.row, y0, y1)
        area = AreaTables(row=row, col=area.col)
    else:
        s0, s1 = y0, y1
    spec = pp.spec
    spec = dataclasses.replace(
        spec,
        base_y=spec.base_y[s0:s1],
        base_x=spec.base_x[s0:s1],
        frac_y=spec.frac_y[s0:s1],
        frac_x=spec.frac_x[s0:s1],
        valid=None if spec.valid is None else spec.valid[s0:s1],
    )
    return dataclasses.replace(
        pp,
        key=f"{pp.key}|band{y0}-{y1}",
        spec=spec,
        out_h=y1 - y0,
        scaled_h=s1 - s0,
        area=area,
    )


def _plane_row_costs(pp: PlanePlan) -> np.ndarray:
    """[out_h] modelled K3 cost of each output row of one plane
    (:func:`..ops.window.row_costs`); the rows of a supersampled plan's
    scaled size fold onto the output rows they are resized into."""
    scaled = window.row_costs(pp.window_plan())
    if scaled.size == pp.out_h:
        return scaled
    return np.bincount(np.arange(scaled.size) * pp.out_h // scaled.size, weights=scaled,
                       minlength=pp.out_h)


def plan_row_costs(plan: TransformPlan) -> np.ndarray:
    """Model-based [luma out_h] per-row cost of the banded path's remap.

    A MODEL, not a measurement: it counts K3's own tiles per output row,
    each weighted by its class's staged window bytes (:func:`_plane_row_costs`),
    with the chroma rows mapped through the subsampling ratio and counted
    twice (U and V run the chroma plan), so that :func:`band_plans` can
    place cost-balanced edges without a measurement pass.  It leaves out
    K1, which every band runs over the whole input plane.  Builds the
    remap's tile plans on the host if they are not built yet (memoized
    on the plan).
    """
    rows = _plane_row_costs(plan.luma)
    if plan.chroma is not None:
        r = max(1, plan.luma.out_h // plan.chroma.out_h)
        c = 2.0 * np.repeat(_plane_row_costs(plan.chroma) / r, r)[: rows.size]
        rows[: c.size] += c
    return rows


def _cost_edges(units: int, r: int, n: int, row_costs) -> List[int]:
    """Band edges (in luma rows, multiples of ``r``) at equal-cost
    quantiles of ``row_costs``; every band keeps at least one unit."""
    unit_cost = np.asarray(row_costs, np.float64)[: units * r]
    unit_cost = unit_cost.reshape(units, r).sum(axis=1)
    cum = np.concatenate([[0.0], np.cumsum(unit_cost)])
    targets = cum[-1] * np.arange(1, n) / n
    cuts = np.searchsorted(cum, targets)
    edges = [0]
    for c in cuts:
        edges.append(int(min(max(c, edges[-1] + 1), units - (n - len(edges)))))
    edges.append(units)
    return [e * r for e in edges]


# (id(plan), n, row-cost key) -> (plan, its bands); the plan is held so
# that its id is not reused while the entry lives
_BAND_CACHE: Dict[Tuple, Tuple[TransformPlan, Tuple[TransformPlan, ...]]] = {}
_BAND_LOCK = threading.Lock()


def band_plans(plan: TransformPlan, n: int, row_costs=None) -> Tuple[TransformPlan, ...]:
    """Split a frame plan into ``n`` output row-band plans.

    Luma band edges align to the chroma subsampling ratio so each band
    carries exact chroma rows.  ``n`` is clamped to the number of
    alignable rows.  ``row_costs`` (optional: ``[out_h]`` relative per-row
    costs, or ``"auto"`` for :func:`plan_row_costs`) places the edges at
    equal-cost quantiles instead of equal heights: frame latency is
    max(band), so balancing the costs lowers it toward sum/n.

    Memoized per (plan, n, row_costs): a band's tables and tile plans are
    built once per device, on its first frame (a 4K tile plan takes a
    large part of a second on the host), and reused for every later one.
    """
    if isinstance(row_costs, str) and row_costs != "auto":
        raise ValueError(f"row_costs: array or 'auto', got {row_costs!r}")
    ck = row_costs if row_costs is None or isinstance(row_costs, str) else tuple(
        np.asarray(row_costs, np.float64).tolist())
    key = (id(plan), n, ck)
    with _BAND_LOCK:
        hit = _BAND_CACHE.get(key)
        if hit is not None:
            return hit[1]
        if isinstance(row_costs, str):
            row_costs = plan_row_costs(plan)
        r = 1
        if plan.chroma is not None:
            r = max(1, plan.luma.out_h // plan.chroma.out_h)
        units = plan.luma.out_h // r
        n = max(1, min(n, units))
        if row_costs is not None:
            edges = _cost_edges(units, r, n, row_costs)
        else:
            edges = [int(e) * r for e in np.linspace(0, units, n + 1)]
        edges[-1] = plan.luma.out_h
        bands = []
        for y0, y1 in zip(edges[:-1], edges[1:]):
            chroma = None
            if plan.chroma is not None:
                chroma = _slice_plane(plan.chroma, y0 // r, y1 // r)
            bands.append(dataclasses.replace(
                plan, out_h=y1 - y0, luma=_slice_plane(plan.luma, y0, y1), chroma=chroma))
        out = tuple(bands)
        _BAND_CACHE[key] = (plan, out)
        return out


def clear_band_caches() -> None:
    """Drop the memoized band plans and their executors."""
    with _BAND_LOCK:
        for _, bands in _BAND_CACHE.values():
            for band in bands:
                drop_executors(band)
        _BAND_CACHE.clear()


class BandedFrame:
    """An in-flight banded frame: every band dispatched, nothing gathered.

    ``gather()`` copies each band to the host (waiting for its device) and
    stitches the output planes in row order; until then the host is free
    to dispatch other frames (the bands x frames grid in the CLI)."""

    def __init__(self, parts: List[List[torch.Tensor]]):
        self._parts = parts

    def gather(self) -> Tuple[np.ndarray, ...]:
        return tuple(np.concatenate([o[0].cpu().numpy() for o in outs], axis=0)
                     for outs in self._parts)


def local_band_range(
    n_bands: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """Contiguous global-band group ``[b0, b1)`` owned by a process
    (default: this one, by its ``torch.distributed`` rank).

    Process ``p`` of ``P`` runs bands ``[p*n/P, (p+1)*n/P)`` on its own
    devices and holds those output rows.  Remainder bands go to the
    leading processes (sizes differ by at most one).
    """
    p = distributed.process_index() if process_index is None else process_index
    P = distributed.process_count() if process_count is None else process_count
    if not 0 <= p < P:
        raise ValueError(f"process {p} outside [0, {P})")
    base, rem = divmod(n_bands, P)
    b0 = p * base + min(p, rem)
    return b0, b0 + base + (1 if p < rem else 0)


def transform_frame_banded_async(
    plan: TransformPlan,
    planes: Sequence,
    devices: Optional[Sequence] = None,
    n: Optional[int] = None,
    row_costs=None,
    bands_slice: Optional[Tuple[int, int]] = None,
) -> BandedFrame:
    """Dispatch ONE frame's output row-bands across devices; no waiting.

    ``planes``: ``[H, W]`` planes (numpy or tensors; ``plan.n_planes`` of
    them, as :func:`..pipeline.transform_frame_planes` takes).  Each is
    copied once to each device that runs a band; band ``i`` runs on
    ``devices[i % len(devices)]`` (default: every visible CUDA device).

    ``row_costs``: per-row relative costs for cost-balanced band edges
    (see :func:`band_plans`); ``"auto"`` uses :func:`plan_row_costs`.

    ``bands_slice``: run only global bands ``[b0, b1)``: the
    multi-process mode, where each process owns a contiguous band group
    (:func:`local_band_range`) and its ``gather()`` returns that row
    slice of the frame.
    """
    if isinstance(row_costs, str) and row_costs != "auto":
        raise ValueError(f"row_costs: array or 'auto', got {row_costs!r}")
    devices = list(default_devices() if devices is None else make_mesh(devices).devices)
    if n is None:
        n = len(devices)
    if len(planes) != plan.n_planes:
        raise ValueError(
            f"expected {plan.n_planes} plane(s) for {plan.pix_fmt}, got {len(planes)}"
        )
    bands = band_plans(plan, n, row_costs=row_costs)
    if bands_slice is not None:
        b0, b1 = bands_slice
        if not 0 <= b0 < b1 <= len(bands):
            raise ValueError(f"bands_slice {bands_slice} outside [0, {len(bands)}]")
        bands = bands[b0:b1]
    on: Dict[torch.device, List[torch.Tensor]] = {}  # the planes copied to each device
    parts: List[List[torch.Tensor]] = [[] for _ in planes]
    for i, band in enumerate(bands):
        dev = devices[i % len(devices)]
        xs = on.get(dev)
        if xs is None:
            xs = on[dev] = [as_plane(p, dev).to(dev)[None] for p in planes]
        for j, o in enumerate(transform_frame_planes(band, xs)):
            parts[j].append(o)
    return BandedFrame(parts)


def transform_frame_banded(
    plan: TransformPlan,
    planes: Sequence,
    devices: Optional[Sequence] = None,
    n: Optional[int] = None,
    row_costs=None,
    bands_slice: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, ...]:
    """Transform ONE frame with its output rows sharded over devices.

    Blocking form of :func:`transform_frame_banded_async`: returns
    ``[oh, ow]`` numpy planes of the plan's dtype, byte-identical to the
    unsharded transform (the band group's row slice when ``bands_slice``
    is given).  Every band is dispatched before any is gathered.
    """
    return transform_frame_banded_async(
        plan, planes, devices, n, row_costs, bands_slice
    ).gather()


# The host term's default: the pinned host-to-device copy rate of one 4K
# yuv420p frame's planes (12,441,600 B) that chip_smoke.py phase 15
# measured on an H100 80GB HBM3 at a 700 W power limit: 40.64, 48.58 and
# 42.16 GB/s on three machines (pageable planes 7.06, 11.22 and 8.27);
# the lowest is the default.  Measure it again on another host or card.
HOST_H2D_GBPS = 40.64


def broadcast_ms(
    plan: TransformPlan,
    in_w: int,
    in_h: int,
    n_devices: int,
    host_gbps: float = HOST_H2D_GBPS,
    peer_gbps: Optional[float] = None,
) -> float:
    """Modelled per-frame milliseconds to copy the input planes to
    ``n_devices`` band devices.

    One host copies the planes to a first device once (``bytes /
    host_gbps``); with more devices the copy fans out device to device,
    which pipelines, so the added wall time is about ``bytes /
    peer_gbps`` whatever ``n``.  ``peer_gbps`` has no default: the
    device-to-device rate cannot be measured on a one-GPU host, so
    ``n_devices > 1`` without it raises.  Deep formats move two bytes
    per sample.  Multi-process ingest (every process decodes its own
    copy) skips both terms.
    """
    cw, ch = chroma_dims(in_w, in_h, plan.pix_fmt)
    nbytes = (in_w * in_h + (plan.n_planes - 1) * cw * ch) * plan.luma.sample_bytes
    ms = nbytes / (host_gbps * 1e6)
    if n_devices > 1:
        if peer_gbps is None:
            raise ValueError(
                "broadcast_ms to several devices needs peer_gbps, the device-to-device "
                "rate: it is not measured on a one-GPU host, so it has no default"
            )
        ms += nbytes / (peer_gbps * 1e6)
    return ms
