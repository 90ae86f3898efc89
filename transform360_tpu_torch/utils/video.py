"""Video-container IO shim — the drop-in analog of running the reference
filter inside an FFmpeg graph (``README.md:84-95``); a copy of
``transform360_tpu.utils.video``.

The GPU pipeline consumes raw planar YUV; real users have .mp4/.mkv/.avi
files.  This module bridges with a backend chain (OpenCV is imported only
when the fallback is used, so hosts without it run the ffmpeg backend):

* **ffmpeg subprocess** (preferred when an ``ffmpeg`` binary is on PATH):
  decode/encode through rawvideo pipes in yuv420p — bit-exact planes,
  any container/codec ffmpeg knows.
* **OpenCV VideoCapture/VideoWriter** fallback: BGR frames converted
  with ``cv2.cvtColor`` I420 round-trips.  Codec support depends on the
  cv2 build (MJPG/avi and mp4v/mp4 are typical).

Decode/encode stay on the host CPU — the GPU kernels only ever see the
raw planes.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def _probe_ffmpeg(path: str) -> Tuple[int, int, float, str]:
    out = subprocess.run(
        [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=width,height,r_frame_rate,pix_fmt",
            "-of", "csv=p=0", path,
        ],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    parts = out.split(",")
    w, h, rate = parts[:3]
    pix_fmt = parts[3] if len(parts) > 3 else "yuv420p"
    return int(w), int(h), parse_frame_rate(rate), pix_fmt


def parse_frame_rate(rate: str, default: float = 30.0) -> float:
    """Parse an ffprobe ``r_frame_rate`` fraction ("30000/1001", "25/1").

    ffprobe reports "0/0" for some streams (attached pictures, odd mkv):
    fall back to ``default`` rather than dividing by zero.
    """
    num, _, den = rate.partition("/")
    try:
        fps = float(num) / float(den or 1)
    except (ValueError, ZeroDivisionError):
        return default
    return fps if fps > 0 and np.isfinite(fps) else default


def _split_i420(buf: np.ndarray, w: int, h: int):
    """Split a flat packed I420/yuv420p frame buffer into (y, u, v).

    Operates on the flat byte stream (not a [h*3/2, w] view) so
    odd-width/-height streams — whose chroma rows are ceil(w/2) bytes and
    whose total byte count is not a multiple of ``w`` — split correctly.
    """
    cw, ch = (w + 1) // 2, (h + 1) // 2
    buf = buf.reshape(-1)
    y = buf[: w * h].reshape(h, w)
    u = buf[w * h : w * h + cw * ch].reshape(ch, cw)
    v = buf[w * h + cw * ch : w * h + 2 * cw * ch].reshape(ch, cw)
    return y, u, v


class VideoReader:
    """Iterate (y, u, v) uint8 planes from a video container."""

    def __init__(self, path: str, max_frames: int = 0):
        self.path = path
        self.max_frames = max_frames
        self._backend = "ffmpeg" if have_ffmpeg() else "cv2"
        if self._backend == "ffmpeg":
            self.width, self.height, self.fps, _ = _probe_ffmpeg(path)
        else:
            import cv2

            cap = cv2.VideoCapture(path)
            if not cap.isOpened():
                raise IOError(f"cannot open video {path!r}")
            self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            self.fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
            cap.release()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.width, self.height
        n = 0
        if self._backend == "ffmpeg":
            frame_bytes = w * h + 2 * (((w + 1) // 2) * ((h + 1) // 2))
            proc = subprocess.Popen(
                [
                    "ffmpeg", "-v", "error", "-i", self.path,
                    "-f", "rawvideo", "-pix_fmt", "yuv420p", "-",
                ],
                stdout=subprocess.PIPE,
            )
            try:
                while not self.max_frames or n < self.max_frames:
                    raw = proc.stdout.read(frame_bytes)
                    if len(raw) < frame_bytes:
                        break
                    yield _split_i420(np.frombuffer(raw, np.uint8), w, h)
                    n += 1
            finally:
                proc.stdout.close()
                proc.terminate()
                proc.wait()
        else:
            import cv2

            # open per iteration so the reader is re-iterable, matching
            # the ffmpeg backend (which re-spawns the decoder)
            cap = cv2.VideoCapture(self.path)
            if not cap.isOpened():
                raise IOError(f"cannot open video {self.path!r}")
            try:
                while not self.max_frames or n < self.max_frames:
                    ok, bgr = cap.read()
                    if not ok:
                        break
                    i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
                    yield _split_i420(i420, w, h)
                    n += 1
            finally:
                cap.release()


class VideoWriter:
    """Write (y, u, v) uint8 planes to a video container."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        self.path, self.width, self.height = path, width, height
        self.fps = fps or 30.0
        self._backend = "ffmpeg" if have_ffmpeg() else "cv2"
        if self._backend == "ffmpeg":
            self._proc = subprocess.Popen(
                [
                    "ffmpeg", "-v", "error", "-y",
                    "-f", "rawvideo", "-pix_fmt", "yuv420p",
                    "-s", f"{width}x{height}", "-r", f"{self.fps}",
                    "-i", "-", "-pix_fmt", "yuv420p", path,
                ],
                stdin=subprocess.PIPE,
            )
        else:
            import cv2

            if width % 2 or height % 2:
                raise IOError(
                    "the cv2 encode fallback needs even dimensions "
                    f"(I420 color conversion); got {width}x{height} — "
                    "install ffmpeg for odd-dimension output"
                )
            ext = path.rsplit(".", 1)[-1].lower()
            fourcc = {"mp4": "mp4v", "m4v": "mp4v", "mov": "mp4v"}.get(
                ext, "MJPG"
            )
            self._w = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*fourcc), self.fps,
                (width, height),
            )
            if not self._w.isOpened():
                raise IOError(
                    f"cv2 VideoWriter cannot open {path!r} (codec {fourcc})"
                )

    def write(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        if self._backend == "ffmpeg":
            self._proc.stdin.write(np.ascontiguousarray(y).tobytes())
            self._proc.stdin.write(np.ascontiguousarray(u).tobytes())
            self._proc.stdin.write(np.ascontiguousarray(v).tobytes())
        else:
            import cv2

            i420 = np.concatenate(
                [
                    np.asarray(y).reshape(-1, self.width),
                    np.concatenate(
                        [np.asarray(u).reshape(-1), np.asarray(v).reshape(-1)]
                    ).reshape(-1, self.width),
                ]
            )
            self._w.write(cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420))

    def close(self) -> None:
        if self._backend == "ffmpeg":
            self._proc.stdin.close()
            rc = self._proc.wait()
            if rc:
                raise IOError(f"ffmpeg encode failed with rc={rc}")
        else:
            self._w.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def is_raw_path(path: str) -> bool:
    """Raw planar streams by extension; "-" is a raw stdin/stdout pipe
    (the ffmpeg `-f rawvideo -` idiom)."""
    if path == "-":
        return True
    return path.rsplit(".", 1)[-1].lower() in ("yuv", "raw", "i420")
