"""Batched frame pipeline: prefilter → round → remap → round (→ INTER_AREA
→ round).

Planes are batch-major ``[B, H, W]`` tensors end to end, uint8 for 8-bit
formats and uint16 for the deep ones (10, 12, 16 bits).  Each plane runs
K1 (the prefilter, with its half-up round, when the plan has one) and
then K3, the window-gather remap with its half-up round
(:mod:`.ops.window`), at every batch size, both saturated at the
format's largest sample.  A supersampled plan remaps at the scaled size
and then resizes to the output size with INTER_AREA and rounds again, as
the JAX package's ``pipeline.py:304-311``, in one launch of K4 per plane
batch (:mod:`.ops.area`).  The wrappers in :mod:`.ops`
launch the CUDA kernels for CUDA tensors and run the plain versions for
CPU tensors.  The JAX package routes between five TPU kernels by batch
size (``pipeline.py:144-284`` there); its lane-batched variants B2-B4
exist for TPU lane occupancy.  K3 computes their function too, and on
the H100 a batch remap in their style lost to K3 at every batch size
(PERF.md), so nothing here routes by batch size.

Rounding parity: the reference filters into a uint8 plane and remaps it
with fixed-point arithmetic; every stage rounds with ``floor(x + 0.5)``
and saturation (``VideoFrameTransform.cpp:620-777``): inside the kernels,
and through :func:`.sampling.round_px` in their plain versions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .ops.area import area_px
from .ops.blur import blur_px
from .ops.window import remap_window_px
from .plan import PlanePlan, TransformPlan


def device_of(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device without a card
    raises (nothing falls back to the CPU)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    return d


def as_plane(p, device) -> torch.Tensor:
    """A tensor stays on its own device; anything else (a numpy array) is
    copied to ``device``."""
    if isinstance(p, torch.Tensor):
        return p
    return torch.from_numpy(np.require(p, requirements=("C", "W"))).to(device_of(device))


def device_put_plan(plan: TransformPlan, device="cuda") -> TransformPlan:
    """Build the plan's tables and the remap's tile plans on ``device``
    now, not on the first frame; returns the plan (as the JAX package's
    ``device_put_plan``)."""
    d = device_of(device)
    for pp in (plan.luma, plan.chroma):
        if pp is not None:
            pp.tables(d)
            pp.window_tables(d)
    return plan


def _plane_program(pp: PlanePlan, x: torch.Tensor) -> torch.Tensor:
    """[B, in_h, in_w] → [B, out_h, out_w] samples of the plan's dtype on
    ``x``'s device."""
    t = pp.tables(x.device)
    if t.blur is not None:
        x = blur_px(t.blur, x, pp.maxval)
    out = remap_window_px(pp.window_tables(x.device), x, pp.maxval)
    if t.area is not None:
        out = area_px(t.area, out, pp.maxval)
    return out


def _check_plane(x, pp: PlanePlan, what: str) -> None:
    h, w = pp.in_h, pp.in_w
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != pp.dtype:
        raise TypeError(f"{what}: expected {pp.dtype} samples (depth {pp.depth}), got {x.dtype}")
    if x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(f"{what}: expected [B, {h}, {w}], got {tuple(x.shape)}")


def transform_frame_planes(
    plan: TransformPlan, planes: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """[B, H, W] planes in (uint8, or uint16 for deep formats), same
    layout and dtype out.

    Plane 0 uses the luma map; every other plane shares the chroma map
    (``vf_transform360.c:372``).  The chroma planes are stacked on the
    batch axis into one launch of each kernel.
    """
    if len(planes) != plan.n_planes:
        raise ValueError(
            f"expected {plan.n_planes} plane(s) for {plan.pix_fmt}, got {len(planes)}"
        )
    _check_plane(planes[0], plan.luma, "plane 0")
    outs = [_plane_program(plan.luma, planes[0].contiguous())]
    rest = planes[1:]
    if rest:
        for i, p in enumerate(rest, 1):
            _check_plane(p, plan.chroma, f"plane {i}")
        stacked = _plane_program(plan.chroma, torch.cat(rest, dim=0))
        outs.extend(torch.split(stacked, [p.shape[0] for p in rest], dim=0))
    return tuple(outs)


def transform_batch(plan: TransformPlan, y, u=None, v=None, device="cuda"):
    """Transform a batch of planar frames.

    ``y``: [B, H, W] (or [H, W] for one frame), uint8 or, for deep
    formats, uint16; ``u``/``v``: the chroma planes (omit for single-plane
    formats).  Tensors are transformed on their own device; numpy planes
    are copied to ``device`` first.  Returns planes of the same dtype at
    the negotiated output size on the planes' device (a bare tensor for
    single-plane formats).
    """
    planes = [as_plane(p, device) for p in (y, u, v) if p is not None]
    squeeze = planes[0].dim() == 2
    if squeeze:
        planes = [p[None] for p in planes]
    outs = transform_frame_planes(plan, planes)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs if len(outs) > 1 else outs[0]


def transform_frame(plan: TransformPlan, y, u, v, device="cuda"):
    """One frame's planes ([H, W]); :func:`transform_batch` under the JAX
    package's name."""
    return transform_batch(plan, y, u, v, device=device)


def transform_plane(plan: TransformPlan, plane, map_plane_index: int, device="cuda"):
    """Single-plane entry, mirroring the C ABI's
    ``VideoFrameTransform_transformFramePlane``
    (``VideoFrameTransformHandler.h:36-47``): the caller picks the map
    plane (0 = luma, 1 = chroma) for the given image plane (a tensor, or
    a numpy array copied to ``device``)."""
    pp = plan.luma if map_plane_index == 0 else plan.chroma
    if pp is None:
        raise ValueError(f"plan has no map plane {map_plane_index} ({plan.pix_fmt})")
    plane = as_plane(plane, device)
    squeeze = plane.dim() == 2
    if squeeze:
        plane = plane[None]
    _check_plane(plane, pp, "plane")
    out = _plane_program(pp, plane.contiguous())
    return out[0] if squeeze else out
