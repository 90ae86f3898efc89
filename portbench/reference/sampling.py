"""Sample spec, plain remap and INTER_AREA: the benchmark's frozen copy
of ``transform360_tpu_torch/sampling.py``, without the kernels' tile
plans, and with a compute dtype for the control.

Warp resampling: the plan-side sample spec and the plain remap.

Plan time (host numpy, unchanged from ``transform360_tpu.sampling``): the
float32 warp map is quantized to OpenCV's 1/32-pixel grid (``INTER_BITS ==
5``; cv::convertMaps rounds ``map*32``), split into first-tap indices and
fractions, and the border rule is resolved (:func:`make_sample_spec`).

Run time: :class:`DeviceSpec` holds a spec on one device (first-tap
indices, 1/32 fraction indices, a combined ``wy*wx`` weight table), and
:func:`remap_plain` is the plain PyTorch version of the remap, a
transcription of ``remap_const``; the CUDA kernel K3
(:mod:`.ops.window`) is held against it.  Summation
order is ty-major, tx-minor with the float64 product ``wy*wx`` cast to
float32, as ``tap_arrays`` builds it, so the result is byte-identical to
the reference's XLA path run op by op.  Planes are uint8, or uint16 for
the deep formats; :func:`round_px` rounds half up and saturates at the
depth's largest sample.

Supersampling: :func:`area_matrix` (a copy of the reference's) gives
INTER_AREA as a matrix per axis; :class:`AreaTables` keeps each row's
nonzero band, and :func:`area_resize` sums it in torch: the plain version
of the CUDA kernel K4 (:mod:`.ops.area`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Interpolation

INTER_BITS = 5  # OpenCV fixed-point fraction bits for remap
INTER_TAB_SIZE = 1 << INTER_BITS

_TAPS = {
    Interpolation.NEAREST: 1,
    Interpolation.LINEAR: 2,
    Interpolation.CUBIC: 4,
    Interpolation.LANCZOS4: 8,
}

# Tap offset of the first tap relative to floor(coord):
_FIRST_TAP = {
    Interpolation.NEAREST: 0,
    Interpolation.LINEAR: 0,
    Interpolation.CUBIC: -1,
    Interpolation.LANCZOS4: -3,
}

# Border rules of the remap (the ``mode`` argument of the kernel).
BORDER_WRAP = 0  # BORDER_WRAP: every layout but the barrels
BORDER_FILL = 1  # transparent: linear/cubic taps outside the source read the fill
BORDER_REFLECT = 2  # transparent lanczos4: outside taps read BORDER_REFLECT_101


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """Plan-time resampling arrays for one plane class.

    ``base_y``/``base_x`` are the first-tap indices; ``frac_*`` are the
    1/32-quantized fractional positions in [0, 1).  ``valid`` is None for
    wrapping layouts, else the transparent-border mask.
    """

    base_y: np.ndarray  # int32 [H', W']
    base_x: np.ndarray  # int32 [H', W']
    frac_y: np.ndarray  # float32 [H', W']
    frac_x: np.ndarray  # float32 [H', W']
    valid: Optional[np.ndarray]  # bool [H', W'] or None
    in_w: int
    in_h: int
    interp: Interpolation
    wrap: bool  # True: BORDER_WRAP; False: clamp taps + transparent fill


def make_sample_spec(
    warp: np.ndarray,
    in_w: int,
    in_h: int,
    interp: Interpolation,
    wrap: bool,
) -> SampleSpec:
    """Build the spec from a float32 warp map [H', W', 2] (x, y channels).

    Quantization parity with cv::convertMaps: coordinates are rounded to
    1/32 px (``rint(map * 32)``); NEAREST rounds to the integer grid
    directly.
    """
    map_x = np.asarray(warp[..., 0], np.float64)
    map_y = np.asarray(warp[..., 1], np.float64)

    valid = None
    if not wrap:
        # Unmapped barrel pixels carry the outside marker outX=-1 →
        # map_x == -in_w - 0.5 (VideoFrameTransform.cpp:1304-1307, :544).
        valid = map_x > -1.0

    if interp == Interpolation.NEAREST:
        base_x = np.rint(map_x).astype(np.int64)
        base_y = np.rint(map_y).astype(np.int64)
        frac_x = np.zeros(map_x.shape, np.float32)
        frac_y = np.zeros(map_y.shape, np.float32)
    else:
        sx = np.rint(map_x * INTER_TAB_SIZE).astype(np.int64)
        sy = np.rint(map_y * INTER_TAB_SIZE).astype(np.int64)
        base_x = sx >> INTER_BITS
        base_y = sy >> INTER_BITS
        frac_x = ((sx & (INTER_TAB_SIZE - 1)) / INTER_TAB_SIZE).astype(np.float32)
        frac_y = ((sy & (INTER_TAB_SIZE - 1)) / INTER_TAB_SIZE).astype(np.float32)

    if not wrap:
        # BORDER_TRANSPARENT skip parity (measured against cv::remap; see
        # docs/parity.md): the destination pixel keeps its pre-fill unless
        # the anchor is in range — nearest: rounded coord in [0, n-1];
        # linear/cubic: floor in [-1, n-1] (any footprint overlap);
        # lanczos4: floor in [0, n-1].  base_* here is the anchor.
        lo = -1 if interp in (Interpolation.LINEAR, Interpolation.CUBIC) else 0
        valid = (
            valid
            & (base_x >= lo)
            & (base_x <= in_w - 1)
            & (base_y >= lo)
            & (base_y <= in_h - 1)
        )

    first = _FIRST_TAP[interp]
    base_x = base_x + first
    base_y = base_y + first

    if wrap:
        base_x = np.mod(base_x, in_w)
        base_y = np.mod(base_y, in_h)
    else:
        # clamp so that all taps stay addressable; invalid pixels are
        # masked to the fill value at the end.
        base_x = np.clip(base_x, -(_TAPS[interp] - 1), in_w - 1)
        base_y = np.clip(base_y, -(_TAPS[interp] - 1), in_h - 1)

    return SampleSpec(
        base_y=base_y.astype(np.int32),
        base_x=base_x.astype(np.int32),
        frac_y=frac_y,
        frac_x=frac_x,
        valid=valid,
        in_w=in_w,
        in_h=in_h,
        interp=interp,
        wrap=wrap,
    )


def reflect101(idx, n: int, xp=np):
    """OpenCV ``borderInterpolate(..., BORDER_REFLECT_101)``: -1 -> 1,
    n -> n-2, in closed form (period ``2n-2``), valid for taps arbitrarily
    far out of range.  ``xp`` is numpy or torch."""
    if n == 1:
        return xp.zeros_like(idx)
    period = 2 * n - 2
    r = xp.abs(idx) % period
    return xp.where(r >= n, period - r, r)


# ---------------------------------------------------------------------------
# Interpolation weights (plan-time numpy; all match OpenCV)
# ---------------------------------------------------------------------------


def _weights_linear(f, xp):
    return [1.0 - f, f]


def _weights_cubic(f, xp):
    """OpenCV interpolateCubic, A = -0.75."""
    A = -0.75
    w0 = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A
    w1 = ((A + 2) * f - (A + 3)) * f * f + 1
    g = 1.0 - f
    w2 = ((A + 2) * g - (A + 3)) * g * g + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = (
    (1, 0),
    (-_S45, -_S45),
    (0, 1),
    (_S45, -_S45),
    (-1, 0),
    (_S45, _S45),
    (0, -1),
    (-_S45, _S45),
)


def _weights_lanczos4(f, xp):
    """OpenCV interpolateLanczos4: 8 taps via the sin/cos phase trick,
    normalized to sum 1; degenerate f≈0 falls back to the center tap."""
    y0 = -(f + 3.0) * (math.pi * 0.25)
    s0 = xp.sin(y0)
    c0 = xp.cos(y0)
    ws = []
    for k in range(8):
        y = -(f + 3.0 - k) * (math.pi * 0.25)
        denom = y * y
        denom = xp.where(denom == 0.0, 1.0, denom)  # masked below at f≈0
        ws.append((_LANCZOS_CS[k][0] * s0 + _LANCZOS_CS[k][1] * c0) / denom)
    total = sum(ws[1:], ws[0])
    ws = [w / total for w in ws]
    # f == 0 exactly → y for k=3 is 0 → NaN; OpenCV special-cases it.
    exact = f < 1e-7
    return [xp.where(exact, 1.0 if k == 3 else 0.0, ws[k]) for k in range(8)]


def _tap_weights(interp: Interpolation, f, xp=np):
    if interp == Interpolation.NEAREST:
        return [xp.ones_like(f)]
    if interp == Interpolation.LINEAR:
        return _weights_linear(f, xp)
    if interp == Interpolation.CUBIC:
        return _weights_cubic(f, xp)
    if interp == Interpolation.LANCZOS4:
        return _weights_lanczos4(f, xp)
    raise ValueError(interp)


def weight_table(interp: Interpolation) -> np.ndarray:
    """Combined tap weights float32 ``[32*32, T*T]``: row ``fy*32 + fx``,
    column ``ty*T + tx`` holds ``float32(wy[ty] * wx[tx])`` with both
    factors in float64 at fractions ``fy/32`` and ``fx/32`` — the very
    values ``tap_arrays`` computes per pixel."""
    T = _TAPS[interp]
    fr = np.arange(INTER_TAB_SIZE, dtype=np.float64) / INTER_TAB_SIZE
    w = np.stack(_tap_weights(interp, fr, np), axis=1)  # [32, T] float64
    comb = w[:, None, :, None] * w[None, :, None, :]  # [fy, fx, ty, tx]
    return comb.astype(np.float32).reshape(INTER_TAB_SIZE**2, T * T)


def frac_index(frac: np.ndarray) -> np.ndarray:
    """uint8 1/32 index of a quantized fraction (``rint(frac * 32)``)."""
    return np.rint(np.asarray(frac, np.float64) * INTER_TAB_SIZE).astype(np.uint8)


def border_mode(spec: SampleSpec) -> int:
    if spec.wrap:
        return BORDER_WRAP
    if spec.interp == Interpolation.LANCZOS4:
        return BORDER_REFLECT
    return BORDER_FILL


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One plane class's remap arrays on one device."""

    base_y: torch.Tensor  # int32 [out_h, out_w] first-tap row
    base_x: torch.Tensor  # int32 [out_h, out_w] first-tap column
    fy: torch.Tensor  # uint8 [out_h, out_w] 1/32 fraction index
    fx: torch.Tensor  # uint8 [out_h, out_w]
    valid: Optional[torch.Tensor]  # uint8 [out_h, out_w] or None
    wtab: torch.Tensor  # float32 [1024, T*T] (see weight_table)
    in_h: int
    in_w: int
    taps: int
    mode: int  # BORDER_WRAP / BORDER_FILL / BORDER_REFLECT
    fill: float

    @property
    def out_shape(self):
        return tuple(self.base_y.shape)

    @classmethod
    def from_spec(cls, spec: SampleSpec, fill: float, device) -> "DeviceSpec":
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            base_y=put(spec.base_y.astype(np.int32)),
            base_x=put(spec.base_x.astype(np.int32)),
            fy=put(frac_index(spec.frac_y)),
            fx=put(frac_index(spec.frac_x)),
            valid=None if spec.valid is None else put(spec.valid.astype(np.uint8)),
            wtab=put(weight_table(spec.interp)),
            in_h=spec.in_h,
            in_w=spec.in_w,
            taps=_TAPS[spec.interp],
            mode=border_mode(spec),
            fill=float(fill),
        )


def sample_dtype(depth: int) -> torch.dtype:
    """The plane dtype of a bit depth: uint8 up to 8 bits, else uint16."""
    return torch.uint8 if depth <= 8 else torch.uint16


def round_px(x: torch.Tensor, maxval: float, dtype: torch.dtype) -> torch.Tensor:
    """OpenCV-style half-up rounding saturated to the sample maximum (255
    at 8 bit; 1023/4095/65535 for the deep formats), as the JAX package's
    ``pipeline._round_px``.  (torch.round rounds half to even, so it is
    not used.)"""
    return torch.clamp(torch.floor(x + 0.5), 0.0, float(maxval)).to(dtype)


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """:func:`round_px` at 8 bits."""
    return round_px(x, 255.0, torch.uint8)


def as_gatherable(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself for uint8 samples, else int32: torch's uint16 lacks
    some gathers (``torch.take`` on the CPU), so the plain versions gather
    deep samples from int32 copies."""
    return x if x.dtype == torch.uint8 else x.to(torch.int32)


def _resolve(idx: torch.Tensor, n: int, mode: int) -> torch.Tensor:
    if mode == BORDER_WRAP:
        return torch.remainder(idx, n)
    if mode == BORDER_REFLECT:
        return reflect101(idx, n, torch)
    return torch.clamp(idx, 0, n - 1)


def remap_plain(ds: DeviceSpec, x: torch.Tensor, dt: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain remap: uint8 or uint16 ``[B, in_h, in_w]`` → ``dt`` (float32;
    a lower precision for the benchmark's control) ``[B, out_h, out_w]``
    (before rounding), on ``x``'s device.
    Transcribes ``remap_const`` over ``tap_arrays``: one gather per tap,
    ty-major and tx-minor, the transparent-fill term added last, then the
    ``valid`` mask."""
    B = x.shape[0]
    H, W, T = ds.in_h, ds.in_w, ds.taps
    flat = as_gatherable(x).reshape(B, H * W)
    by = ds.base_y.reshape(-1).long()
    bx = ds.base_x.reshape(-1).long()
    w2 = ds.wtab.to(dt)[ds.fy.reshape(-1).long() * INTER_TAB_SIZE + ds.fx.reshape(-1).long()]
    acc = None
    fill_w = None
    for ty in range(T):
        yy = by + ty
        row = _resolve(yy, H, ds.mode) * W
        for tx in range(T):
            xx = bx + tx
            g = flat[:, row + _resolve(xx, W, ds.mode)].to(dt)
            if T == 1:
                term = g
            else:
                w = w2[:, ty * T + tx]
                if ds.mode == BORDER_FILL:
                    outside = (yy < 0) | (yy >= H) | (xx < 0) | (xx >= W)
                    ow = torch.where(outside, w, 0.0)
                    fill_w = ow if fill_w is None else fill_w + ow
                    w = torch.where(outside, 0.0, w)
                term = w[None, :] * g
            acc = term if acc is None else acc + term
    if fill_w is not None:
        acc = acc + (fill_w * ds.fill)[None, :]
    if ds.valid is not None:
        acc = torch.where(ds.valid.reshape(1, -1).bool(), acc, ds.fill)
    return acc.reshape((B,) + ds.out_shape)


# ---------------------------------------------------------------------------
# INTER_AREA resize: the supersampling epilogue
# (VideoFrameTransform.cpp:735-777)
# ---------------------------------------------------------------------------


def area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Row matrix M [n_out, n_in] such that ``out = M @ in`` equals
    cv::resize INTER_AREA along one axis (a copy of the JAX package's
    ``sampling.area_matrix``).

    Downscale (n_in >= n_out): box integral with fractional edge weights.
    Upscale: OpenCV falls back to bilinear for INTER_AREA enlargement; we
    build the matching bilinear matrix.
    """
    M = np.zeros((n_out, n_in), np.float32)
    if n_in >= n_out:
        scale = n_in / n_out
        for i in range(n_out):
            lo = i * scale
            hi = (i + 1) * scale
            j0 = int(math.floor(lo))
            j1 = int(math.ceil(hi))
            for j in range(j0, min(j1, n_in)):
                w = min(hi, j + 1) - max(lo, j)
                M[i, j] = w / scale
    else:
        # Enlargement: OpenCV's INTER_AREA upscale branch computes its own
        # (non-centered) linear coefficients:
        #   sx = floor(dx*scale); fx = (dx+1) - (sx+1)*inv_scale;
        #   fx = fx <= 0 ? 0 : fx - floor(fx)
        scale = n_in / n_out
        inv_scale = n_out / n_in
        for i in range(n_out):
            j0 = int(math.floor(i * scale))
            f = (i + 1) - (j0 + 1) * inv_scale
            f = 0.0 if f <= 0 else f - math.floor(f)
            if j0 >= n_in - 1:
                M[i, n_in - 1] = 1.0
            else:
                M[i, j0] = 1.0 - f
                M[i, j0 + 1] = f
    return M


@dataclasses.dataclass(frozen=True)
class AreaAxis:
    """One axis of an INTER_AREA resize as a band: output ``i`` sums
    ``weights[i, k] * in[first[i] + k]`` for ascending ``k``.  The band of
    each output spans its matrix row's nonzeros; shorter bands are padded
    with zero weights (their index clamped into the input)."""

    first: np.ndarray  # int32 [n_out]
    weights: np.ndarray  # float32 [n_out, K]
    n_in: int

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "AreaAxis":
        m = np.asarray(m, np.float32)
        nz = m != 0
        if not nz.any(axis=1).all():
            raise ValueError("an INTER_AREA matrix row has no weight")
        n_out, n_in = m.shape
        first = nz.argmax(axis=1)
        last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
        k = np.arange(int((last - first).max()) + 1)
        idx = first[:, None] + k[None, :]
        inside = idx <= last[:, None]
        w = np.where(inside, m[np.arange(n_out)[:, None], np.minimum(idx, n_in - 1)], 0.0)
        return cls(first=first.astype(np.int32), weights=w.astype(np.float32), n_in=n_in)

    def indices(self) -> np.ndarray:
        """int64 [n_out, K]: each weight's input index (padding clamped)."""
        k = np.arange(self.weights.shape[1])
        return np.minimum(self.first[:, None].astype(np.int64) + k, self.n_in - 1)

    def matrix(self) -> np.ndarray:
        """The dense matrix this band came from, exactly."""
        m = np.zeros((self.weights.shape[0], self.n_in), np.float32)
        rows, ks = np.nonzero(self.weights)
        m[rows, self.first[rows] + ks] = self.weights[rows, ks]
        return m


@dataclasses.dataclass(frozen=True)
class AreaTables:
    """The two axes of a plane's INTER_AREA resize, from the scaled
    (supersampled) size to the output size."""

    row: AreaAxis  # [out_h] over scaled_h
    col: AreaAxis  # [out_w] over scaled_w

    @classmethod
    def from_matrices(cls, row_m: np.ndarray, col_m: np.ndarray) -> "AreaTables":
        return cls(row=AreaAxis.from_matrix(row_m), col=AreaAxis.from_matrix(col_m))

    @classmethod
    def build(cls, scaled_w: int, scaled_h: int, out_w: int, out_h: int) -> "AreaTables":
        return cls.from_matrices(area_matrix(scaled_h, out_h), area_matrix(scaled_w, out_w))


@dataclasses.dataclass(frozen=True)
class DeviceArea:
    """:class:`AreaTables` on one device: each axis's int64 tap indices and
    float32 weights."""

    row_idx: torch.Tensor  # int64 [out_h, Kr]
    row_w: torch.Tensor  # float32 [out_h, Kr]
    col_idx: torch.Tensor  # int64 [out_w, Kc]
    col_w: torch.Tensor  # float32 [out_w, Kc]

    @classmethod
    def from_tables(cls, at: AreaTables, device) -> "DeviceArea":
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(row_idx=put(at.row.indices()), row_w=put(at.row.weights),
                   col_idx=put(at.col.indices()), col_w=put(at.col.weights))

    @property
    def out_shape(self):
        return (self.row_w.shape[0], self.col_w.shape[0])


def area_resize(da: DeviceArea, x: torch.Tensor, dt: torch.dtype = torch.float32) -> torch.Tensor:
    """INTER_AREA as two banded weighted sums: samples ``[B, H', W']``
    (uint8 or uint16) → ``dt`` (float32; lower for the control) ``[B,
    out_h, out_w]`` (before rounding), on ``x``'s device.  Rows first, then columns, each sum in ascending input
    index with every product and every sum rounded on its own in float32,
    so the CPU and the GPU give the same bytes.  The JAX package runs the
    same resize as two dense matrix products (``apply_area_resize``); the
    band does the nonzero part of their arithmetic, and no matrix product
    runs, so no TF32 switch can change the result."""
    x = as_gatherable(x)
    h = None
    for k in range(da.row_idx.shape[1]):
        term = x.index_select(1, da.row_idx[:, k]).to(dt) * da.row_w[:, k, None].to(dt)
        h = term if h is None else h + term
    out = None
    for k in range(da.col_idx.shape[1]):
        term = h.index_select(2, da.col_idx[:, k]) * da.col_w[:, k].to(dt)
        out = term if out is None else out + term
    return out
