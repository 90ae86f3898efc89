"""Seeded, video-like input frames, made on the device.

The generator of the port's own chip checks (``chip_smoke.py``'s
``video_like_planes`` and ``batch_of``: smooth luma with sensor noise,
chroma waves, each frame the base frame rolled sideways), moved onto the
device and driven by ``--seed``: the seed draws the waves' phases and the
noise, on a ``torch.Generator`` of the device, so one seed gives the same
frames on every run and every seed gives frames of the same sizes.  The
kernels' work does not depend on the pixels, so seeds change the content
and never the work.

Unlike that generator's, both chroma planes vary along both axes and carry
noise of their own, so a frame's U and V differ from every other frame's,
as its Y does: an output plane taken from the wrong frame, or left from an
earlier call, differs from the reference.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .reference.config import chroma_dims, get_pixel_format


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def base_frame(seed: int, in_w: int, in_h: int, pix_fmt: str, device) -> Tuple[torch.Tensor, ...]:
    """One frame's planes ``[H, W]`` of ``pix_fmt`` samples on ``device``."""
    device = torch.device(device)
    pf = get_pixel_format(pix_fmt)
    g = _generator(seed, device)
    ph = torch.rand(7, generator=g, device=device) * (2 * np.pi)
    yy = torch.arange(in_h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(in_w, device=device, dtype=torch.float32)[None, :]
    noise = torch.randn((in_h, in_w), generator=g, device=device) * 6
    y = (128 + 70 * torch.sin(xx / 17.0 + ph[0]) * torch.cos(yy / 11.0 + ph[1])
         + 40 * torch.sin((xx + 2 * yy) / 5.0 + ph[2]) + noise)
    planes = [y]
    if pf.n_planes > 1:
        cw, ch = chroma_dims(in_w, in_h, pf)
        cy = torch.arange(ch, device=device, dtype=torch.float32)[:, None]
        cx = torch.arange(cw, device=device, dtype=torch.float32)[None, :]
        noise = torch.randn((2, ch, cw), generator=g, device=device) * 4
        u = 128 + 50 * torch.sin(cx / 9.0 + ph[3]) * torch.cos(cy / 13.0 + ph[5]) + noise[0]
        v = 128 + 50 * torch.cos(cy / 7.0 + ph[4]) * torch.sin(cx / 11.0 + ph[6]) + noise[1]
        planes += [u, v] if pf.n_planes == 3 else [u]
    out = []
    for p in planes:
        p = torch.clamp(p, 0, 255).to(torch.uint8)  # truncated, as numpy's astype
        if pf.depth > 8:  # the same picture at the deeper format's range
            p = (p.int() * pf.maxval // 255).to(torch.uint16)
        out.append(p.contiguous())
    return tuple(out)


def input_sets(seed: int, in_w: int, in_h: int, pix_fmt: str, batch: int, pool: int,
               roll_px: int, device) -> List[Tuple[torch.Tensor, ...]]:
    """``pool`` distinct input sets of ``batch`` frames each: set ``j``'s
    frame ``k`` is the base frame rolled by ``roll_px * (j * batch + k)``
    columns.  A set's planes are ``[batch, H, W]``, or ``[H, W]`` where
    ``batch`` is 1 (one frame, as a live caller hands it over)."""
    base = base_frame(seed, in_w, in_h, pix_fmt, device)
    sets = []
    for j in range(pool):
        shifts = [roll_px * (j * batch + k) for k in range(batch)]
        planes = tuple(torch.stack([torch.roll(p, s, dims=1) for s in shifts]).contiguous()
                       for p in base)
        sets.append(tuple(p[0].contiguous() for p in planes) if batch == 1 else planes)
    return sets


def on_host(sets: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[np.ndarray, ...]]:
    """The same sets as numpy arrays in host memory (a software decoder's
    output)."""
    return [tuple(np.ascontiguousarray(p.cpu().numpy()) for p in s) for s in sets]


def frames_of(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` for a list of frame indices, as slices joined by
    ``torch.cat`` (CUDA has no indexing kernel for uint16)."""
    return torch.cat([x[i:i + 1] for i in idx])
