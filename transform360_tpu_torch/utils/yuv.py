"""Raw planar YUV file IO (a copy of ``transform360_tpu.utils.yuv``).

The reference runs inside FFmpeg and receives decoded planes; this package
runs standalone, so the CLI works on raw planar streams (the format
``ffmpeg -pix_fmt yuv420p -f rawvideo`` produces).  Decode/encode of
compressed video stays on the host CPU; the GPU kernels only ever see raw
planes.
"""

from __future__ import annotations

import contextlib
import io
import sys
from typing import Iterator, Tuple

import numpy as np

from ..config import chroma_dims


def _open_stream(path, mode: str):
    """Open a raw-stream path; "-" is stdin/stdout; an already-open binary
    file object (e.g. a decode subprocess's pipe) is used as-is.  Neither
    is closed on exit."""
    if not isinstance(path, str):
        return contextlib.nullcontext(path)
    if path == "-":
        f = sys.stdin.buffer if "r" in mode else sys.stdout.buffer
        return contextlib.nullcontext(f)
    return open(path, mode)


def _read_exact(f, n: int) -> bytes:
    """Read exactly n bytes (short of EOF) — pipes return partial reads."""
    buf = f.read(n)
    if buf is None or len(buf) in (0, n):
        return buf or b""
    chunks = [buf]
    got = len(buf)
    while got < n:
        more = f.read(n - got)
        if not more:
            break
        chunks.append(more)
        got += len(more)
    return b"".join(chunks)


def frame_size_bytes(w: int, h: int, pix_fmt="yuv420p") -> int:
    from ..config import get_pixel_format

    pf = get_pixel_format(pix_fmt)
    if pf.n_planes == 1:
        return w * h * pf.dtype.itemsize
    cw, ch = chroma_dims(w, h, pf)
    return (w * h + (pf.n_planes - 1) * cw * ch) * pf.dtype.itemsize


def read_planar_frames(
    path, w: int, h: int, max_frames: int = 0, pix_fmt="yuv420p"
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield per-frame uint8 plane tuples from a raw planar stream
    (a path, "-" for stdin, or an open binary file object).

    Plane dims derive from the format's log2 chroma shifts, like the
    reference's ``update_plane_sizes`` (``vf_transform360.c:87-97``)."""
    from ..config import get_pixel_format

    pf = get_pixel_format(pix_fmt)
    cw, ch = chroma_dims(w, h, pf)
    sizes = [(h, w)] + [(ch, cw)] * (pf.n_planes - 1)
    dt = pf.dtype  # uint8, or little-endian uint16 for deep formats
    total = sum(a * b for a, b in sizes) * dt.itemsize
    n = 0
    with _open_stream(path, "rb") as f:
        while True:
            buf = _read_exact(f, total)
            if len(buf) < total:
                return
            planes, off = [], 0
            for ph, pw in sizes:
                planes.append(
                    np.frombuffer(buf, dt, ph * pw, off).reshape(ph, pw)
                )
                off += ph * pw * dt.itemsize
            yield tuple(planes)
            n += 1
            if max_frames and n >= max_frames:
                return


def read_yuv420_frames(
    path: str, w: int, h: int, max_frames: int = 0
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (Y, U, V) uint8 planes from a raw I420 file."""
    return read_planar_frames(path, w, h, max_frames, "yuv420p")


def read_yuv420_batch(
    path: str, w: int, h: int, max_frames: int = 0, pix_fmt="yuv420p"
) -> Tuple[np.ndarray, ...]:
    """Read a whole raw planar file into stacked [B, ...] plane arrays."""
    cols = None
    for planes in read_planar_frames(path, w, h, max_frames, pix_fmt):
        if cols is None:
            cols = [[] for _ in planes]
        for c, p in zip(cols, planes):
            c.append(p)
    if cols is None:
        raise ValueError(f"no complete {w}x{h} frames in {path}")
    return tuple(np.stack(c) for c in cols)


def write_yuv420_frames(path_or_file, planes_iter) -> int:
    """Write planar frames (tuples of planes) as a raw stream."""
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        if path_or_file == "-":
            f = sys.stdout.buffer
        else:
            f = open(path_or_file, "wb")
            close = True
    n = 0
    try:
        for planes in planes_iter:
            for p in planes:
                p = np.ascontiguousarray(p)
                if p.dtype == np.uint16:
                    p = p.astype("<u2")  # deep formats: explicit LE layout
                else:
                    p = p.astype(np.uint8, copy=False)
                f.write(p.tobytes())
            n += 1
        if not close:
            f.flush()
    finally:
        if close:
            f.close()
    return n


def write_yuv420_batch(path: str, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> int:
    if y.ndim == 2:
        return write_yuv420_frames(path, [(y, u, v)])
    return write_yuv420_frames(path, zip(y, u, v))
