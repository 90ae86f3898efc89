"""Warp-map generation: the benchmark's frozen copy of
``transform360_tpu_torch/geometry.py``.

Warp-map generation in float32 torch, run on the CPU at plan time.

Transcribes ``transform360_tpu.geometry``: the reference's per-pixel
``transformPos`` (``VideoFrameTransform.cpp:893-1316``) as one vectorized
expression over a pixel-center meshgrid.  It runs once per
(config, size); the map is consumed by plan-side numpy
(:func:`transform360_tpu_torch.sampling.make_sample_spec`), so it is built
on the CPU whatever device the engine uses.

All math is float32, like the reference's ``float`` pipeline.  atan2/asin
in torch and in XLA may differ in the last ulp, which can move a map
coordinate across a 1/32 quantization step (ROADMAP C).
"""

from __future__ import annotations

import math

import torch

from .config import Layout, StereoFormat, TransformConfig

_EPS = 1e-9
K_SIDE = 0.5  # kCubemapSideDistance (VideoFrameTransform.cpp:30)

# Cube corner / axis tables (VideoFrameTransform.cpp:38-49)
_P0 = (-0.5, -0.5, -0.5)
_P1 = (0.5, -0.5, -0.5)
_P3 = (0.5, 0.5, -0.5)
_P4 = (-0.5, -0.5, 0.5)
_P5 = (0.5, -0.5, 0.5)
_P6 = (-0.5, 0.5, 0.5)
_PX = (1.0, 0.0, 0.0)
_PY = (0.0, 1.0, 0.0)
_PZ = (0.0, 0.0, 1.0)
_NX = (-1.0, 0.0, 0.0)
_NZ = (0.0, 0.0, -1.0)

# Per-face (p, vx, vy) rows indexed by TransformFaceType
# (standard: VideoFrameTransform.cpp:1153-1184; offcenter: :1120-1151).
_BASIS_STD = (
    (_P5, _NZ, _PY),  # RIGHT
    (_P0, _PZ, _PY),  # LEFT
    (_P6, _PX, _NZ),  # TOP
    (_P0, _PX, _PZ),  # BOTTOM
    (_P4, _PX, _PY),  # FRONT
    (_P1, _NX, _PY),  # BACK
)
_BASIS_OFF = (
    (_P4, _PY, _NZ),  # RIGHT
    (_P3, _NX, _PZ),  # LEFT
    (_P5, _PY, _NX),  # TOP
    (_P1, _NX, _PY),  # BOTTOM
    (_P1, _PY, _PZ),  # FRONT
    (_P5, _NX, _NZ),  # BACK
)

_FACE_TOP = 2
_FACE_BOTTOM = 3


def _intersect_sphere_offset(x, y, z, ox, oy, oz):
    """Vectorized ray/unit-sphere intersection (VideoFrameTransform.cpp:53-75)."""
    loc = x * -ox + y * -oy + z * -oz
    odot = ox * ox + oy * oy + oz * oz
    root2 = loc * loc - odot + 1.0
    root = torch.sqrt(torch.clamp(root2, min=0.0))
    dist = root - loc
    return torch.where((root2 <= 0.0) | (root < loc), torch.zeros_like(dist), dist)


def _normalize_equirectangular(x, y):
    """Vectorized pole/seam wrap (VideoFrameTransform.cpp:101-123)."""
    over = y >= 1.0
    under = y < 0.0
    x = torch.where(over | under, x + 0.5, x)
    y = torch.where(over, 2.0 - y, torch.where(under, -y, y))
    x = torch.where(
        x >= 1.0,
        x - torch.trunc(x),
        torch.where(x < 0.0, x + (torch.trunc(-x) + 1.0), x),
    )
    return x, y


def _transform_cube_face_pos(cfg: TransformConfig, tx, ty, tz):
    """Unit direction -> CUBEMAP_32-packed coords (VideoFrameTransform.cpp:796-861).

    The reference checks the six faces in order and takes the first match;
    here a reverse-order select chain, so earlier faces win.  Unmatched
    points get the outside marker (-1, 0).
    """
    c = torch.tensor(cfg.input_expand_coef, dtype=torch.float32)

    def face_candidate(num_a, num_b, den, fx, fy):
        x = num_a / den
        y = num_b / den
        ok = (x >= -1.0) & (x <= 1.0) & (y >= -1.0) & (y <= 1.0)
        return ok, fx(x / c), fy(y / c)

    cands = [
        (tz <= -K_SIDE, *face_candidate(
            tx, ty, tz, lambda x: (5.0 + x) / 6.0, lambda y: (3.0 + y) / 4.0)),
        (tz >= K_SIDE, *face_candidate(
            tx, ty, tz, lambda x: (3.0 + x) / 6.0, lambda y: (3.0 - y) / 4.0)),
        (tx <= -K_SIDE, *face_candidate(
            tz, ty, tx, lambda x: (3.0 - x) / 6.0, lambda y: (1.0 + y) / 4.0)),
        (tx >= K_SIDE, *face_candidate(
            tz, ty, tx, lambda x: (1.0 - x) / 6.0, lambda y: (1.0 - y) / 4.0)),
        (ty <= -K_SIDE, *face_candidate(
            tx, tz, ty, lambda x: (1.0 - x) / 6.0, lambda y: (3.0 + y) / 4.0)),
        (ty >= K_SIDE, *face_candidate(
            tx, tz, ty, lambda x: (5.0 + x) / 6.0, lambda y: (1.0 + y) / 4.0)),
    ]
    out_x = torch.full_like(tx, -1.0)
    out_y = torch.zeros_like(tx)
    for gate, ok, fx, fy in reversed(cands):
        hit = gate & ok
        out_x = torch.where(hit, fx, out_x)
        out_y = torch.where(hit, fy, out_y)
    return out_x, out_y


def _transform_input_pos(cfg: TransformConfig, tx, ty, tz, input_pixel_width):
    """3D direction -> normalized input coords (VideoFrameTransform.cpp:863-891)."""
    d = torch.sqrt(tx * tx + ty * ty + tz * tz)
    if cfg.input_layout == Layout.CUBEMAP_32:
        return _transform_cube_face_pos(cfg, tx / d, ty / d, tz / d)
    out_x = -torch.atan2(-tx / d, tz / d) / (2.0 * math.pi) + 0.5
    if cfg.output_layout in (Layout.BARREL, Layout.BARREL_SPLIT):
        # Clamp right-edge pixels (ffmpeg padding guard, :884-885)
        half = float(torch.tensor(input_pixel_width * 0.5, dtype=torch.float32))
        out_x = torch.clamp(out_x, half, 1.0 - half)
    out_y = torch.asin(torch.clamp(-ty / d, -1.0, 1.0)) / math.pi + 0.5
    return out_x, out_y


def transform_pos(cfg: TransformConfig, x, y, input_pixel_width: float):
    """Vectorized transformPos (VideoFrameTransform.cpp:893-1316).

    ``x``/``y`` are float32 tensors of normalized output coordinates in
    [0, 1).  Returns (out_x, out_y, has_mapping): normalized input
    coordinates and a validity mask (False only for barrel-corner pixels,
    which carry the reference's outside markers (-1, 0)).
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)

    # --- output stereo eye split (:903-931), skipped for MONO input ---
    is_right = torch.zeros_like(x, dtype=torch.bool)
    if cfg.input_stereo_format != StereoFormat.MONO:
        if cfg.output_stereo_format == StereoFormat.LR:
            is_right = x > 0.5
            x = torch.where(is_right, (x - 0.5) / 0.5, x / 0.5)
        elif cfg.output_stereo_format == StereoFormat.TB:
            is_right = y > 0.5
            y2 = (y - 0.5) / 0.5
            if cfg.vflip:
                y2 = 1.0 - y2
            y = torch.where(is_right, y2, y / 0.5)

    if cfg.output_layout != Layout.FLAT_FIXED:
        y = 1.0 - y  # vertical flip (:936-938)

    lay = cfg.output_layout
    coef = torch.tensor(cfg.expand_coef, dtype=torch.float32)
    has_mapping = torch.ones_like(x, dtype=torch.bool)

    if lay == Layout.FLAT_FIXED:
        # Direct rectilinear path (:1265-1271); no rotation, no flip.
        out_x = ((x - 0.5) * cfg.fixed_hfov + cfg.fixed_yaw) / 360.0 + 0.5
        out_y = ((y - 0.5) * cfg.fixed_vfov - cfg.fixed_pitch) / 180.0 + 0.5
        out_x, out_y = _normalize_equirectangular(out_x, out_y)
        return _repack_input_stereo(cfg, out_x, out_y, is_right, has_mapping)

    # --- per-layout decode to (face, x, y) or (yaw, pitch) (:942-1083) ---
    zeros = torch.zeros_like(x)
    yaw = zeros
    pitch = zeros
    face = torch.zeros_like(x, dtype=torch.int64)
    use_angles = torch.zeros_like(x, dtype=torch.bool)  # face < 0 paths

    if lay in (Layout.CUBEMAP_32, Layout.EAC_32):
        v_face = torch.clamp((y * 2).to(torch.int32), 0, 1)
        h_face = torch.clamp((x * 3).to(torch.int32), 0, 2)
        x = x * 3.0 - h_face
        y = y * 2.0 - v_face
        if lay == Layout.EAC_32:
            # per-face equal-angle warp (:1069-1077)
            x = torch.tan((x - 0.5) * (math.pi * 0.5)) * 0.5 + 0.5
            y = torch.tan((y - 0.5) * (math.pi * 0.5)) * 0.5 + 0.5
        face = (h_face + (1 - v_face) * 3).long()
    elif lay == Layout.CUBEMAP_23_OFFCENTER:
        v_face = torch.clamp((y * 3).to(torch.int32), 0, 2)
        h_face = torch.clamp((x * 2).to(torch.int32), 0, 1)
        x = x * 2.0 - h_face
        y = y * 3.0 - v_face
        face = (h_face + (2 - v_face) * 2).long()
    elif lay == Layout.EQUIRECT:
        yaw = (2.0 * x - 1.0) * math.pi
        pitch = (y - 0.5) * math.pi
        use_angles = torch.ones_like(x, dtype=torch.bool)
    elif lay == Layout.BARREL:
        # 80% equirect mid-band + two polar circles (:970-981)
        mid = x <= 0.8
        yaw = torch.where(mid, (2.5 * x - 1.0) * coef * math.pi, zeros)
        pitch = torch.where(mid, (y * 0.5 - 0.25) * coef * math.pi, zeros)
        v_face = torch.clamp((y * 2).to(torch.int32), 0, 1)
        face = torch.where(v_face == 1, _FACE_TOP, _FACE_BOTTOM).long()
        x = torch.where(mid, x, x * 5.0 - 4.0)
        y = torch.where(mid, y, y * 2.0 - v_face)
        use_angles = mid
    elif lay == Layout.BARREL_SPLIT:
        # Front/back half circles (ASCII spec at :983-1068)
        mid = 3.0 * x <= 2.0
        v_face = torch.clamp((y * 2).to(torch.int32), 0, 1)
        yaw = torch.where(
            mid, ((1.5 * x - 0.5) * coef - v_face + 1.0) * math.pi, zeros
        )
        pitch = torch.where(mid, (y - 0.25 - 0.5 * v_face) * coef * math.pi, zeros)
        half_v = torch.clamp((y * 4).to(torch.int32), 0, 3)
        face = torch.where(
            (half_v == 1) | (half_v == 3), _FACE_TOP, _FACE_BOTTOM
        ).long()
        cx = x * 3.0 - 2.0
        # per-halfVFace y remap (:1044-1065)
        y0 = (0.5 - (y * 2.0)) * coef
        y1 = 1.0 - coef * ((y * 2.0) - 0.5)
        y2_ = 1.0 - coef * (1.0 - (y * 2.0 - 0.5))
        y3 = (y * 2.0 - 1.5) * coef
        cy = torch.where(
            half_v == 0, y0, torch.where(half_v == 1, y1, torch.where(half_v == 2, y2_, y3))
        )
        cx = torch.where((half_v == 0) | (half_v == 1), 1.0 - cx, cx)
        x = torch.where(mid, x, cx)
        y = torch.where(mid, y, cy)
        use_angles = mid
    else:  # pragma: no cover
        raise ValueError(f"unsupported output layout {lay}")

    # --- direction from yaw/pitch (:1095-1101) ---
    q_ang = (
        torch.sin(yaw) * torch.cos(pitch),
        torch.sin(pitch),
        torch.cos(yaw) * torch.cos(pitch),
    )

    # --- direction from cube-face basis (:1104-1189) ---
    if lay in (Layout.BARREL, Layout.BARREL_SPLIT):
        radius = (x - 0.5) ** 2 + (y - 0.5) ** 2
        inside = radius <= 0.25 * coef * coef
        has_mapping = use_angles | inside  # circle mask (:1106-1113)
    xe = (x - 0.5) * coef + 0.5
    ye = (y - 0.5) * coef + 0.5
    basis = _BASIS_OFF if lay == Layout.CUBEMAP_23_OFFCENTER else _BASIS_STD
    tbl = torch.tensor(basis, dtype=torch.float32)  # [6, 3(p,vx,vy), 3(xyz)]
    p = tbl[:, 0, :][face]  # [..., 3]
    vx = tbl[:, 1, :][face]
    vy = tbl[:, 2, :][face]
    q_face = tuple(p[..., k] + vx[..., k] * xe + vy[..., k] * ye for k in range(3))

    qx = torch.where(use_angles, q_ang[0], q_face[0])
    qy = torch.where(use_angles, q_ang[1], q_face[1])
    qz = torch.where(use_angles, q_ang[2], q_face[2])

    # --- off-center sphere re-intersection (:1192-1230) ---
    ox, oy, oz = (
        cfg.fixed_cube_offcenter_x,
        cfg.fixed_cube_offcenter_y,
        cfg.fixed_cube_offcenter_z,
    )
    if abs(ox) > _EPS or abs(oy) > _EPS or abs(oz) > _EPS:
        d = torch.sqrt(qx * qx + qy * qy + qz * qz)
        qx, qy, qz = qx / d, qy / d, qz / d
        if cfg.is_horizontal_offset:
            # parity quirk: qy is divided by the *horizontal* norm too
            # (:1201-1204)
            d = torch.sqrt(qx * qx + qz * qz)
            qx, qy, qz = qx / d, qy / d, qz / d
            dist = _intersect_sphere_offset(qx, torch.zeros_like(qy), qz, ox, 0.0, oz)
            hit = dist > 0.0
            qx = torch.where(hit, qx * dist - ox, qx)
            qz = torch.where(hit, qz * dist - oz, qz)
        else:
            dist = _intersect_sphere_offset(qx, qy, qz, ox, oy, oz)
            hit = dist > 0.0
            qx = torch.where(hit, qx * dist - ox, qx)
            qy = torch.where(hit, qy * dist - oy, qy)
            qz = torch.where(hit, qz * dist - oz, qz)

    # --- yaw/pitch/roll rotation (:1232-1246) ---
    s1 = math.sin(cfg.fixed_yaw * math.pi / 180.0)
    s2 = math.sin(cfg.fixed_pitch * math.pi / 180.0)
    s3 = math.sin(cfg.fixed_roll * math.pi / 180.0)
    c1 = math.cos(cfg.fixed_yaw * math.pi / 180.0)
    c2 = math.cos(cfg.fixed_pitch * math.pi / 180.0)
    c3 = math.cos(cfg.fixed_roll * math.pi / 180.0)
    tx = (
        qx * (c1 * c3 + s1 * s2 * s3)
        - qy * (c3 * s1 * s2 - c1 * s3)
        + qz * (c2 * s1)
    )
    ty = qx * (c2 * s3) - qy * (c2 * c3) + qz * (-s2)
    tz = (
        qx * (c1 * s2 * s3 - c3 * s1)
        - qy * (c1 * c3 * s2 + s1 * s3)
        + qz * (c1 * c2)
    )
    ty = -ty  # (:1246)

    out_x, out_y = _transform_input_pos(cfg, tx, ty, tz, input_pixel_width)
    return _repack_input_stereo(cfg, out_x, out_y, is_right, has_mapping)


def _repack_input_stereo(cfg: TransformConfig, out_x, out_y, is_right, has_mapping):
    """Input stereo eye re-pack + outside markers (:1279-1307)."""
    if cfg.input_stereo_format == StereoFormat.TB:
        out_y = out_y * 0.5 + torch.where(is_right, 0.5, 0.0)
    elif cfg.input_stereo_format == StereoFormat.LR:
        out_x = out_x * 0.5 + torch.where(is_right, 0.5, 0.0)
    out_x = torch.where(has_mapping, out_x, -1.0)
    out_y = torch.where(has_mapping, out_y, 0.0)
    return out_x, out_y, has_mapping


def scaled_output_dims(cfg: TransformConfig, out_w: int, out_h: int):
    """Supersampled map dims (VideoFrameTransform.cpp:524-526)."""
    return (
        int(cfg.width_scale_factor * out_w + 0.5),
        int(cfg.height_scale_factor * out_h + 0.5),
    )


def build_warp_map(
    cfg: TransformConfig, in_w: int, in_h: int, out_w: int, out_h: int
) -> torch.Tensor:
    """float32 [H', W', 2] CPU tensor of input pixel coords (x, y channels).

    Parity with generateMapForPlane (VideoFrameTransform.cpp:504-556):
    output sampled at pixel centers (+0.5)/dim, map stores
    ``out*in_dim - 0.5`` for the OpenCV pixel-center convention, at the
    scale-factor-scaled output size.
    """
    scaled_w, scaled_h = scaled_output_dims(cfg, out_w, out_h)
    input_pixel_width = 1.0 / in_w
    if cfg.input_stereo_format == StereoFormat.LR:
        input_pixel_width *= 2
    with torch.no_grad():
        jj = (torch.arange(scaled_w, dtype=torch.float32) + 0.5) / scaled_w
        ii = (torch.arange(scaled_h, dtype=torch.float32) + 0.5) / scaled_h
        x, y = torch.meshgrid(jj, ii, indexing="xy")  # [H', W']
        out_x, out_y, _ = transform_pos(cfg, x, y, input_pixel_width)
        return torch.stack([out_x * in_w - 0.5, out_y * in_h - 0.5], dim=-1)
