"""Command-line interface — the FFmpeg filter-shell analog, on the GPU.

The port of ``transform360_tpu.cli``: it accepts the reference filter's
ffmpeg-style ``key=value:key=value`` option string verbatim
(``vf_transform360.c:407-987``) and applies the transform, batching frames
onto the card::

    python -m transform360_tpu_torch.cli \\
        --vf "cube_edge_length=512:interpolation_alg=cubic" \\
        -i in.mp4 -o out.mp4 --batch 8 --device cuda

Video containers (.mp4/.mkv/.avi/...) are decoded/encoded through the
:mod:`.utils.video` shim (ffmpeg subprocess when available, OpenCV
otherwise).  Decode runs on its own thread and device batches are queued
without waiting (``--prefetch`` batches in flight), so host IO overlaps
the card's work.  Raw planar streams (.yuv/.raw/.i420) are read/written
directly and need ``--input-size``; ``-`` pipes raw planes through
stdin/stdout (the ffmpeg rawvideo idiom)::

    ffmpeg -i in.mp4 -f rawvideo -pix_fmt yuv420p - \\
      | python -m transform360_tpu_torch.cli --vf "cube_edge_length=512" \\
          --input-size 3840x2160 -i - -o out.yuv

``--batch 1`` is the live-stream setting (one frame per step); larger
batches trade latency for frames/s.  ``--pix-fmt`` takes the deep formats
(``yuv420p10le`` ...) for raw streams, read and written as 16-bit
little-endian samples.  ``--save-plan`` writes the plan after the run and
``--load-plan`` reuses one instead of generating the maps (plan files of
this package or of the JAX package).

Several devices: ``--devices N`` shards each batch over N GPUs;
``--latency-bands N`` bands each frame's output rows over devices instead
of batching frames (for a live stream); ``--distributed HOST:PORT,P,p``
(or ``env``) runs P processes that each take their own run of every batch
or their own group of bands (``parallel/``).  ``--backend native`` runs
the dependency-free C++ engine on the host's CPU instead (8-bit formats;
no device flags, plan files or multi-process runs).
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from . import pipeline
from .api import open_filter
from .config import get_pixel_format
from .pipeline import device_of
from .utils.profiling import StageStats
from .utils.video import VideoReader, VideoWriter, is_raw_path
from .utils.yuv import read_planar_frames, write_yuv420_frames


def _parse_size(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"bad size {s!r}, expected WxH") from e


def start_reader(frames_in, batch: int):
    """Decode on a separate thread so demux/decode overlaps the device
    step and the encode of earlier batches.  The consumer must set
    ``stop`` on ANY exit (normal or error) so the reader never stays
    blocked on the bounded queue.

    Returns ``(queue, stop_event)``; the queue carries per-frame plane
    tuples, then ``None`` at end of stream (exceptions are forwarded as
    queue items and re-raised by the consumer).
    """
    inq: queue.Queue = queue.Queue(maxsize=max(2 * batch, 8))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                inq.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def read_loop():
        try:
            for planes in frames_in:
                if not _put(planes):
                    return
            _put(None)
        except BaseException as e:  # surfaced in the consumer
            _put(e)
        finally:
            close = getattr(frames_in, "close", None)
            if close is not None:
                close()

    threading.Thread(target=read_loop, daemon=True).start()
    return inq, stop


def tail_frames(n: int, batch: int, device, backend: str = "auto", shards: int = 1) -> int:
    """The frames a short tail batch of ``n`` real frames is submitted as
    (its last frame repeated).  It is padded to ``batch`` where the steady
    batch replays a captured CUDA graph (a CUDA device, the auto backend,
    at most ``pipeline.GRAPH_MAX_BATCH`` frames a shard), as the JAX
    package's CLI pads to reuse its compiled shape: a second shape would
    be captured for one call.  Otherwise it runs eagerly, padded only to a
    multiple of the mesh's ``shards``."""
    if (backend != "native" and torch.device(device).type == "cuda"
            and batch // shards <= pipeline.GRAPH_MAX_BATCH):
        return batch
    return -(-n // shards) * shards


def batched_outputs(transform_async, inq, n_planes, batch, prefetch, stats, pad):
    """Yield per-frame output plane tuples (numpy) from a reader queue,
    submitting ``batch``-frame device steps without waiting (up to
    ``prefetch`` batches in flight) and retiring them in submission order.

    ``pad(n)``: the frames a short tail batch of ``n`` is submitted as, its
    last frame repeated (:func:`tail_frames`).  The padded frames are
    never yielded."""
    batches = [[] for _ in range(n_planes)]
    pending: deque = deque()  # (frames, device outputs) not yet retired

    def submit():
        n = len(batches[0])
        if not n:
            return
        stacked = [np.stack(b) for b in batches]
        m = pad(n)
        if m > n:
            stacked = [np.concatenate([s, np.repeat(s[-1:], m - n, 0)]) for s in stacked]
        pending.append((n, transform_async(*stacked)))
        for b in batches:
            b.clear()

    def retire():
        n, outs = pending.popleft()
        if not isinstance(outs, tuple):
            outs = (outs,)
        tb = time.perf_counter()
        host = [o.cpu().numpy() for o in outs]  # waits for the device
        # "seconds" counts time BLOCKED on device results; with
        # prefetch > 0 compute hidden behind host IO is excluded
        # (wall_seconds is the end-to-end number).
        stats.record(n, time.perf_counter() - tb)
        for k in range(n):
            yield tuple(h[k] for h in host)

    while True:
        item = inq.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        for b, p in zip(batches, item):
            b.append(p)
        if len(batches[0]) >= batch:
            submit()
            while len(pending) > max(prefetch, 0):
                yield from retire()
    submit()
    while pending:
        yield from retire()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="transform360_tpu_torch",
        description="360 video re-projection on an NVIDIA GPU (Transform360 parity).",
    )
    p.add_argument(
        "--vf", default="",
        help="ffmpeg-style transform360 option string (key=value:key=value)",
    )
    p.add_argument(
        "--input-size", type=_parse_size, default=None, metavar="WxH",
        help="input frame size (required for raw .yuv input), e.g. 3840x2160",
    )
    p.add_argument(
        "-i", "--input", required=True,
        help="input video file, or raw planar stream (.yuv/.raw/.i420, "
             "or '-' for stdin)",
    )
    p.add_argument(
        "-o", "--output", required=True,
        help="output video file, or raw planar stream (.yuv/.raw/.i420, "
             "or '-' for stdout)",
    )
    p.add_argument(
        "--fps", type=float, default=None,
        help="output frame rate (default: input rate, or 30 for raw input)",
    )
    p.add_argument(
        "--pix-fmt", default="yuv420p",
        help="planar pixel format of raw streams (yuv420p/yuv422p/"
             "yuv444p/yuv411p/yuv410p/gray, and the deep formats such as "
             "yuv420p10le/gray16le); video containers are yuv420p",
    )
    p.add_argument("--batch", type=int, default=8, help="frames per device step")
    p.add_argument(
        "--device", default="cuda",
        help="torch device that transforms the frames ('cuda' runs the "
             "hand-written kernels; 'cpu' their plain PyTorch versions)",
    )
    p.add_argument(
        "--devices", type=int, default=None,
        help="batch mode: shard each batch over this many GPUs (0 = all "
             "visible; --batch must be a multiple; default 1). With "
             "--latency-bands N: the local devices of the bands x frames "
             "grid: every N of them serve one frame's bands, so D devices "
             "keep D//N frames in flight (default: all visible). With "
             "--device cpu the CPU is named that many times",
    )
    p.add_argument(
        "--latency-bands", type=int, default=0, metavar="N",
        help="single-frame latency mode: band each frame's output rows "
             "over N devices (0 = off; -1 = one band per device) instead "
             "of batching frames. With --distributed, N is the global "
             "band count: each process runs a contiguous band group and "
             "writes its row slice of every frame",
    )
    p.add_argument(
        "--prefetch", type=int, default=1,
        help="batches in flight on the device while the host decodes/"
             "encodes neighboring batches (0 = fully synchronous)",
    )
    p.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    p.add_argument(
        "--save-plan", default=None, help="serialize the built plan to this path"
    )
    p.add_argument(
        "--load-plan", default=None, help="reuse a previously saved plan"
    )
    p.add_argument("--stats", action="store_true", help="print a JSON stats line")
    p.add_argument(
        "--backend", choices=("auto", "native"), default="auto",
        help="'auto' = the PyTorch/CUDA pipeline; 'native' = the "
             "dependency-free C++ engine (the host's CPU, the reference's "
             "threading model; built with the host's C++ compiler at first use)",
    )
    p.add_argument(
        "--distributed", default=None, metavar="SPEC",
        help="join a multi-process run on torch.distributed's gloo backend "
             "(a rendezvous only): 'env' (MASTER_ADDR, MASTER_PORT, "
             "WORLD_SIZE, RANK) or 'HOST:PORT,NPROC,PID'. Every process "
             "reads the whole input; in batch mode process p of P "
             "transforms and writes frames [p*B/P, (p+1)*B/P) of every "
             "batch of B (--batch), so stitch the outputs batch by batch "
             "in process order",
    )
    return p


def _native_refusal(args):
    """The message for a flag the native backend cannot serve, or None."""
    if args.latency_bands:
        return "--latency-bands requires the auto backend"
    if args.devices not in (None, 1):
        return "--devices requires the auto backend"
    if args.save_plan or args.load_plan:
        return "plan files apply to the auto backend only"
    if args.distributed:
        return "--distributed requires the auto backend"
    return None


class _Usage(Exception):
    """A command-line error: printed, exit code 2."""


def _device_list(device, n, cpu_default: int = 1):
    """``n`` devices of the kind ``device`` names: CUDA devices 0 .. n-1
    (``None``: every visible one), or the CPU named ``n`` times
    (``None``: ``cpu_default`` times)."""
    d = device_of(device)
    if d.type != "cuda":
        return [d] * (n or cpu_default)
    avail = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n is None:
        return avail
    if n > len(avail):
        raise _Usage(f"--devices {n} but only {len(avail)} available")
    return avail[:n]


def _own_frames(frames_in, batch: int, rank: int, world: int):
    """This process's frames of a multi-process batch run: frames
    ``[rank * k, (rank + 1) * k)`` of every ``batch`` frames, k = batch /
    world (of a short final batch, those that exist)."""
    k = batch // world
    try:
        for i, planes in enumerate(frames_in):
            if rank * k <= i % batch < (rank + 1) * k:
                yield planes
    finally:
        close = getattr(frames_in, "close", None)
        if close is not None:
            close()


def banded_outputs(plan, inq, devices, n_bands: int, bands_slice, stats):
    """Yield per-frame output plane tuples (numpy) in latency mode: each
    frame's output rows banded over ``devices`` (:mod:`.parallel.latency`,
    uniform band edges).  With more devices than bands, device group g
    serves frame k % G, up to G frames in flight, each at banded
    latency.  With ``bands_slice`` (a multi-process run) only that group
    of the ``n_bands`` global bands runs and each frame's row slice is
    yielded."""
    from .parallel.latency import transform_frame_banded_async

    nb = n_bands if bands_slice is None else bands_slice[1] - bands_slice[0]
    n_use = min(max(nb, 1), len(devices))
    n_groups = max(1, len(devices) // n_use)
    pending: deque = deque()

    def retire():
        tb0, bf = pending.popleft()
        outs = bf.gather()
        stats.record(1, time.perf_counter() - tb0)
        return outs

    g = 0
    while True:
        item = inq.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        group = devices[(g % n_groups) * n_use:][:n_use]
        g += 1
        pending.append((time.perf_counter(), transform_frame_banded_async(
            plan, item, devices=group, n=n_bands, bands_slice=bands_slice)))
        if len(pending) >= n_groups:
            yield retire()
    while pending:
        yield retire()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend == "native":
        refusal = _native_refusal(args)
        if refusal:
            print(f"error: {refusal}", file=sys.stderr)
            return 2

    pf = get_pixel_format(args.pix_fmt)
    if is_raw_path(args.input):
        if args.input_size is None:
            print("error: --input-size is required for raw YUV input", file=sys.stderr)
            return 2
        in_w, in_h = args.input_size
        fps = args.fps or 30.0
        frames_in = read_planar_frames(args.input, in_w, in_h, args.frames, pf)
    else:
        if pf.name != "yuv420p":
            print("error: video containers decode as yuv420p; --pix-fmt "
                  "applies to raw streams only", file=sys.stderr)
            return 2
        reader = VideoReader(args.input, args.frames)
        in_w, in_h = reader.width, reader.height
        if args.input_size and args.input_size != (in_w, in_h):
            print(
                f"error: --input-size {args.input_size[0]}x{args.input_size[1]}"
                f" does not match the stream ({in_w}x{in_h})",
                file=sys.stderr,
            )
            return 2
        fps = args.fps or reader.fps
        frames_in = iter(reader)

    if not is_raw_path(args.output) and pf.name != "yuv420p":
        # validate before the reader thread starts (see read_loop)
        print("error: video-container output requires yuv420p", file=sys.stderr)
        return 2

    if args.latency_bands and args.distributed and not is_raw_path(args.output):
        # each process emits its ROW SLICE of every frame; only raw
        # streams can carry partial frames (stitch slices by vertical
        # concatenation in process order)
        print("error: --latency-bands with --distributed writes per-"
              "process row slices; use raw output (.yuv/.raw/-)", file=sys.stderr)
        return 2

    rank, world = 0, 1
    if args.distributed:
        from .parallel import distributed as dist

        if args.distributed == "env":
            dist.initialize()
        else:
            try:
                coord, nproc, pid = args.distributed.split(",")
                nproc, pid = int(nproc), int(pid)
            except ValueError:
                print("error: --distributed expects 'env' or "
                      "'HOST:PORT,NPROC,PID'", file=sys.stderr)
                return 2
            dist.initialize(coord, nproc, pid)
        rank, world = dist.process_index(), dist.process_count()

    mesh = None
    batch = args.batch
    bands_slice = None
    try:
        if args.latency_bands:
            devices = _device_list(args.device, args.devices or None,
                                   cpu_default=max(args.latency_bands, 1))
            n_bands = len(devices) * world if args.latency_bands < 0 else args.latency_bands
            if args.distributed:
                from .parallel.latency import local_band_range

                bands_slice = local_band_range(n_bands, rank, world)
                if bands_slice[0] == bands_slice[1]:
                    raise _Usage(f"--latency-bands {n_bands} leaves process {rank} of "
                                 f"{world} no band")
            else:
                n_bands = min(n_bands, len(devices))
        else:
            devices = None
            if args.devices not in (None, 1):
                devices = _device_list(args.device, args.devices or None)
            n_dev = 1 if devices is None else len(devices)
            if args.batch % (world * n_dev):
                raise _Usage(
                    f"--batch {args.batch} is not a multiple of --devices {n_dev}"
                    + (f" x {world} processes" if world > 1 else "")
                )
            batch = args.batch // world
            if devices is not None:
                from .parallel import make_mesh

                mesh = make_mesh(devices)
            if world > 1:
                frames_in = _own_frames(frames_in, args.batch, rank, world)
    except _Usage as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    t = open_filter(args.vf, in_w, in_h, eager=args.load_plan is None, pix_fmt=pf,
                    mesh=mesh, device=args.device, backend=args.backend)
    if args.load_plan:
        t.load_plan(args.load_plan)

    # with stdout as the output stream, diagnostics must not corrupt it
    stats = StageStats(stream=sys.stderr if args.output == "-" else sys.stdout)
    t0 = time.perf_counter()
    inq, stop = start_reader(frames_in, batch)
    if args.latency_bands:
        out_iter = banded_outputs(t.plan, inq, devices, n_bands, bands_slice, stats)
    else:
        shards = 1 if mesh is None else mesh.size
        out_iter = batched_outputs(
            t.transform_async, inq, pf.n_planes, batch, args.prefetch, stats,
            lambda n: tail_frames(n, batch, t.device, args.backend, shards))
    try:
        if is_raw_path(args.output):
            write_yuv420_frames(args.output, out_iter)
        else:
            out_w, out_h = t.output_dims()
            with VideoWriter(args.output, out_w, out_h, fps) as w:
                for oy, ou, ov in out_iter:
                    w.write(oy, ou, ov)
    finally:
        stop.set()  # release a reader blocked on the full queue
    dt = time.perf_counter() - t0
    if args.save_plan:
        t.save_plan(args.save_plan)

    out_w, out_h = t.output_dims()
    if args.stats:
        stats.emit(
            in_size=f"{in_w}x{in_h}",
            out_size=f"{out_w}x{out_h}",
            wall_seconds=round(dt, 3),
            device=str(t.device),
        )
    else:
        print(
            f"{stats.frames} frames {in_w}x{in_h} -> {out_w}x{out_h} in {dt:.2f}s "
            f"on {t.device}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
