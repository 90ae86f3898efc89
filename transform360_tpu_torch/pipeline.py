"""Batched frame pipeline: prefilter → round → remap → round (→ INTER_AREA
→ round), run by cached plane executors.

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

Executors (the JAX package's ``_StagedExecutor`` and ``plane_executor``,
``pipeline.py:317-366`` there): :func:`plane_executor` gives one
:class:`PlaneExecutor` per plane plan (by key and content) and device.  On a
CUDA device, the first call of a batch of at most ``GRAPH_MAX_BATCH``
frames of a kind (:func:`graph_key`) runs the program eagerly (its result
is that call's) and captures it in a ``torch.cuda.CUDAGraph``; every later
call of that kind replays the graph on the caller's own planes, as the
JAX package's executor hands the caller's array to its jitted program.
Before each replay the graph's kernel nodes that touch the caller's
memory are re-pointed (:mod:`.ops.nodes`): the first kernel's (K1, or K3
without a prefilter) at the planes where they lie, K1's tensor maps
encoded anew, and the last kernel's (K3, or K4 in a supersampled plan) at
a fresh output, allocated by the caching allocator on the current stream
outside the graph's pool, so that no returned tensor aliases a later
call's.  Nothing is copied into the graph or cloned out of it; only a
plane that is not on the card (numpy, a CPU tensor) is copied, once,
into a buffer that its graph keeps (the span ``t360.executor.stage``).  The
intermediates (K1's blurred plane, K3's scaled plane before K4) stay in
the graph's pool.  The key holds each plane's frames, and the frame
stride and 16-byte alignment of any plane that is not a packed, aligned
card plane, so that a graph never replays in a copy mode, a vector path
or a grid it was not captured for; the kernels check each update as they
check a launch.  The caller's planes must outlive the replay on the
current stream, as they must outlive an eager launch.  The executors of
one device share a graph memory pool; every call runs on the device's
current stream, and calls that overlap on two streams are not supported.
Larger batches, the CPU, and a call made while the current stream is
being captured by the caller (its graph then takes the kernels) run the
program eagerly.  A capture or a node update that fails raises (as does
a torch without ``CUDAGraph(keep_graph=True)`` and its raw graph
handles); nothing runs eagerly in its place.  A replay adds the launches
its graph holds to the kernels' launch counters
(:data:`.utils.profiling.COUNTERS`).  Each call is traced in spans while
a torch profiler records (:func:`.utils.profiling.span`).

Sources: the program hands a plane batch to K1 (or to K3, for a plan
without a prefilter) as the planes it was given, one or two sources
(:mod:`.ops.sources`) read where they lie: the chroma planes U and V are
never stacked by a copy on the card (the JAX package concatenates them
for one TPU launch, ``pipeline.py:412`` there).  A plane whose rows are
not packed is the one input that is copied, by ``.contiguous()``: input
normalization, counted in ``pipeline.plane_copies``.  On the CPU the plain
versions take the sources stacked (a cat on the host).

Rounding parity: the reference filters into a uint8 plane and remaps it
with fixed-point arithmetic; every stage rounds with ``floor(x + 0.5)``
and saturation (``VideoFrameTransform.cpp:620-777``): inside the kernels,
and through :func:`.sampling.round_px` in their plain versions.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import nodes, sources
from .ops.area import area_px
from .ops.blur import blur_px
from .ops.sources import Planes
from .ops.window import remap_window_px
from .plan import PlanePlan, TransformPlan
from .utils.profiling import COUNTERS, count, span

# Plane batches of at most this many frames replay a captured CUDA graph;
# larger ones run eagerly.  The largest batch of chip_smoke.py phase 19's
# ladder (1, 2, 4, 8, 16, 32 frames, two batches in turn so that every
# replay re-points its nodes) at which the executor was no slower than the
# eager program both by CUDA events and behind a busy card, in two runs on
# an H100 80GB HBM3 at a 700 W power limit (PERF.md §6); eager / executor,
# ms:
#   frames   run 1: events, behind      run 2: events, behind
#      8     0.4633 / 0.4596,           0.4577 / 0.4444,
#            0.3667 / 0.3652            0.3656 / 0.3633
#     16     0.6913 / 0.6750,           0.7509 / 0.7526 (slower),
#            0.6173 / 0.6158            0.6151 / 0.6110
#     32     1.1464 / 1.1375,           1.1708 / 1.1557,
#            1.0635 / 1.0597            1.0588 / 1.0613 (slower)
# A replay reads the caller's planes where they lie and writes a fresh
# output, so from 16 frames on the two differ by noise on the card.
GRAPH_MAX_BATCH = 8


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
    return _host(p).to(device_of(device))


def _host(p) -> torch.Tensor:
    """A numpy plane as a CPU tensor over its memory (copied only if it is
    not C-contiguous and writeable)."""
    return torch.from_numpy(np.require(p, requirements=("C", "W")))


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index (where ``torch.empty``
    puts it); any other device as it is."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _placed(p, device) -> Tuple[torch.Tensor, torch.device]:
    """(plane, the device it is transformed on): a tensor on its own
    device; a numpy plane as a host tensor, bound for ``device``."""
    if isinstance(p, torch.Tensor):
        return p, p.device
    return _host(p), _indexed(device_of(device))


def _plane_put(pp: PlanePlan, device) -> None:
    pp.tables(device)
    pp.window_tables(device)


def device_put_plan(plan: TransformPlan, device="cuda") -> TransformPlan:
    """Build the plan's tables and the remap's tile plans on ``device``
    now, not on the first frame; returns the plan (as the JAX package's
    ``device_put_plan``)."""
    d = device_of(device)
    for pp in (plan.luma, plan.chroma):
        if pp is not None:
            _plane_put(pp, d)
    return plan


def _plane_program(pp: PlanePlan, planes: Planes) -> torch.Tensor:
    """[B, in_h, in_w] planes, or one or two sources (U and V) read where
    they lie → [B, out_h, out_w] samples of the plan's dtype (the sources'
    frames stacked) on their device."""
    xs = sources.as_sources(planes)
    dev = xs[0].device
    x = xs[0] if len(xs) == 1 else xs
    t = pp.tables(dev)
    if t.blur is not None:
        x = blur_px(t.blur, x, pp.maxval)
    out = remap_window_px(pp.window_tables(dev), x, pp.maxval)
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


def _packed(p: torch.Tensor) -> torch.Tensor:
    """A plane as a kernel source: as it is where its rows are packed,
    else copied by ``.contiguous()`` (input normalization, counted in
    ``pipeline.plane_copies``: 0 on every main path)."""
    if not sources.rows_packed(p):
        count("pipeline.plane_copies")
        p = p.contiguous()
    return p


def _stage(buf: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p``, a plane that is not on ``buf``'s device, copied into the
    buffer its graph reads it from."""
    with span("executor.stage"):
        return buf.copy_(p)


def graph_key(dtype: torch.dtype, device: torch.device, H: int, W: int,
              frames: Sequence[int], described: Sequence[Optional[sources.Source]]) -> Tuple:
    """The key of the graph that replays planes of ``frames`` frames each
    (``[b, H, W]``, ``dtype`` samples) on ``device``, ``described`` per
    plane by its :class:`.ops.sources.Source` where it lies on the device,
    or ``None`` for a plane copied in from the host: (stacked shape,
    dtype, device, each plane's frames), and after it, for each plane that
    is not a packed, 16-byte aligned card plane, its index with ``"host"``
    or with its frame stride and alignment.  The alignment decides K1's
    copy mode and K3's vector path; no launch choice reads the stride
    itself (K1's tensor maps are encoded anew from it at each update), so
    planes that differ only in an aligned stride get graphs of their own
    that replay the same launches."""
    key = ((sum(frames), H, W), dtype, str(device), tuple(frames))
    return key + tuple(
        (i, "host") if s is None else (i, s.stride, s.aligned)
        for i, (b, s) in enumerate(zip(frames, described))
        if s is None or not s.aligned or (b > 1 and s.stride != H * W))


# per CUDA device: the graph memory pool its executors share, and the
# stream their graphs are captured on.  Dropping executors starts a new
# pool: the allocator frees a pool once its last graph is gone, and a
# freed pool's handle must not be captured into again.
_GRAPH_STATE: Dict[torch.device, tuple] = {}


def _graph_state(device: torch.device) -> tuple:
    st = _GRAPH_STATE.get(device)
    if st is None:
        with torch.cuda.device(device):
            st = _GRAPH_STATE[device] = (torch.cuda.graph_pool_handle(),
                                         torch.cuda.Stream(device))
    return st


@dataclasses.dataclass(frozen=True)
class _Graph:
    """One captured program: the graph (kept, and its instantiation
    ``exec_``), the nodes that touch the caller's memory, per plane the
    device buffer a plane from the host is copied into (``None``: a card
    plane, read where it lies) and its description, the output's shape,
    dtype and device, and the kernel launches that one replay makes
    (counter, count)."""

    graph: torch.cuda.CUDAGraph
    exec_: int
    program: nodes.Program
    staged: Tuple[Optional[torch.Tensor], ...]
    staged_src: Tuple[Optional[sources.Source], ...]
    out_shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    launches: Tuple[Tuple[str, int], ...]

    def __call__(self, planes: Sequence[torch.Tensor],
                 described: Sequence[Optional[sources.Source]]) -> torch.Tensor:
        """Replay on ``planes`` (their descriptions, ``None`` for a plane
        from the host) into a fresh output."""
        src = []
        for p, d, buf, bd in zip(planes, described, self.staged, self.staged_src):
            if buf is not None:
                _stage(buf, p)
                d = bd
            src.append(d)
        out = torch.empty(self.out_shape, dtype=self.dtype, device=self.device)
        self.program.repoint(self.exec_, tuple(src), out.data_ptr())
        with span("executor.replay"):
            self.graph.replay()
        for name, n in self.launches:  # a dict increment on every replay
            COUNTERS[name] += n
        return out


def _capture(pp: PlanePlan, planes: Sequence[torch.Tensor], device: torch.device
             ) -> Tuple[_Graph, torch.Tensor]:
    """(the graph of ``pp``'s program on ``planes``, its output on them).
    A plane that is not on ``device`` is copied into a buffer the graph
    keeps.  The tables are built and the program runs once eagerly (its
    output is returned; its launches count) before the capture of the
    same program, which only records: its launches are taken off the
    counters and added back at each replay, and its output is dropped
    (every replay re-points the last kernel at a fresh one)."""
    _plane_put(pp, device)
    staged = tuple(None if p.device == device
                   else torch.empty(tuple(p.shape), dtype=pp.dtype, device=device) for p in planes)
    xs = [p if buf is None else _stage(buf, p) for p, buf in zip(planes, staged)]
    out = _plane_program(pp, xs)
    src = sources.describe(xs)
    pool, stream = _graph_state(device)
    before = dict(COUNTERS)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool)
            try:
                with nodes.recording() as recorded:
                    static = _plane_program(pp, xs)
            finally:
                graph.capture_end()
        program = nodes.Program(recorded, src, static.data_ptr())
        out_shape = tuple(static.shape)
        del static
        graph.instantiate()
        exec_ = graph.raw_cuda_graph_exec()
    except Exception as e:
        _GRAPH_STATE.pop(device, None)  # the next capture starts on a fresh stream and pool
        raise RuntimeError(
            f"capturing the plane program of {pp.key} at {[tuple(p.shape) for p in planes]} "
            f"in a CUDA graph failed; nothing ran in its place") from e
    finally:
        launched = tuple((k, n - before.get(k, 0)) for k, n in COUNTERS.items()
                         if n != before.get(k, 0))
        for k, n in launched:
            count(k, -n)
    staged_src = tuple(None if buf is None else s for buf, s in zip(staged, src))
    return _Graph(graph, exec_, program, staged, staged_src, out_shape, pp.dtype, device,
                  launched), out


class PlaneExecutor:
    """One plane plan's program on one device, by input kind (the JAX
    package's ``_StagedExecutor``).

    ``ex(*planes)``: one or two ``[b, in_h, in_w]`` planes (on the
    executor's device, read where they lie as the kernels' sources, or
    host tensors, copied in) → ``[sum b, out_h, out_w]`` on the device,
    their frames stacked in order, in a tensor of its own.  ``_by_shape``
    maps each kind of call (:func:`graph_key`; for an eager call its first
    four entries: stacked shape, dtype, device, each plane's frames) to
    the captured :class:`_Graph`, or to ``None`` for a shape that runs
    eagerly (the CPU, or more than ``GRAPH_MAX_BATCH`` frames).  The
    planes must outlive the work queued on the current stream."""

    def __init__(self, pp: PlanePlan, device: torch.device):
        self.pp = pp
        self.device = device
        self._by_shape: Dict[Tuple, Optional[_Graph]] = {}
        self._lock = threading.Lock()

    def __call__(self, *planes: torch.Tensor) -> torch.Tensor:
        with span("executor"):
            dev = self.device
            # switching to the executor's card costs microseconds a call: only
            # where it is not the current one
            if dev.type != "cuda" or dev.index == torch.cuda.current_device():
                return self._run(planes)
            with torch.cuda.device(dev):
                return self._run(planes)

    def _run(self, planes: Sequence[torch.Tensor]) -> torch.Tensor:
        pp, dev = self.pp, self.device
        with span("executor.key"):
            for i, p in enumerate(planes):  # a host plane's copy would convert any dtype
                _check_plane(p, pp, f"plane plan {pp.key}, input {i}")
            frames = tuple(p.shape[0] for p in planes)
            small = dev.type == "cuda" and frames[0] <= GRAPH_MAX_BATCH
            # inside the caller's own capture, its graph takes the launches
            graphed = small and not torch.cuda.is_current_stream_capturing()
            if graphed:
                on = [p.device == dev for p in planes]
                xs = [_packed(p) if o else p for p, o in zip(planes, on)]
                described = tuple(d if o else None for d, o in zip(sources.describe(xs), on))
                key = graph_key(pp.dtype, dev, pp.in_h, pp.in_w, frames, described)
                g = self._by_shape.get(key)
            elif not small:
                self._by_shape.setdefault(
                    ((sum(frames), pp.in_h, pp.in_w), pp.dtype, str(dev), frames), None)
        if not graphed:
            return _plane_program(pp, [_packed(p.to(dev)) for p in planes])
        with self._lock:
            if g is None:
                g = self._by_shape.get(key)  # another thread may have captured it
            if g is None:
                with span("executor.capture"):
                    g, out = _capture(pp, xs, dev)
                self._by_shape[key] = g
                return out
            return g(xs, described)


# (plane plan's key, device) -> its executor, as the JAX package keys its
# _EXEC_CACHE by ``pp.key``: equal plans share one executor (the first
# plan's, whose tables it holds), so the cache holds one executor per
# distinct plan and device however many engines open and drop that plan.
# A plan whose key is taken by a plan of other content replaces it.
_EXEC_CACHE: Dict[Tuple[str, str], PlaneExecutor] = {}
_EXEC_LOCK = threading.Lock()


def plane_executor(pp: PlanePlan, device="cuda") -> PlaneExecutor:
    """The executor of one plane plan on ``device``, cached by the plan's
    key (and content) and the device."""
    return _executor(pp, _indexed(device_of(device)))


def _executor(pp: PlanePlan, d: torch.device) -> PlaneExecutor:
    key = (pp.key, str(d))
    with _EXEC_LOCK:
        ex = _EXEC_CACHE.get(key)
        if ex is None or (ex.pp is not pp and ex.pp.digest() != pp.digest()):
            if ex is not None:
                _drop([key])
            ex = _EXEC_CACHE[key] = PlaneExecutor(pp, d)
    return ex


def _drop(keys) -> None:
    """Drop the executors at ``keys`` (the caller holds ``_EXEC_LOCK``).
    Their graphs may be the last of their pool, which the allocator then
    frees: later captures start a new pool."""
    for k in keys:
        del _EXEC_CACHE[k]
    if keys:
        _GRAPH_STATE.clear()


def drop_executors(plan: TransformPlan) -> None:
    """Drop the executors (and their graphs) that hold ``plan``'s plane
    plans, on every device."""
    planes = [pp for pp in (plan.luma, plan.chroma) if pp is not None]
    with _EXEC_LOCK:
        _drop([k for k, ex in _EXEC_CACHE.items() if any(ex.pp is pp for pp in planes)])


def clear_executor_cache() -> None:
    with _EXEC_LOCK:
        _drop(list(_EXEC_CACHE))


def transform_frame_planes(
    plan: TransformPlan, planes: Sequence, device="cuda"
) -> Tuple[torch.Tensor, ...]:
    """[B, H, W] planes in (uint8, or uint16 for deep formats), same
    layout and dtype out, through the plane executors.

    Plane 0 uses the luma map; every other plane shares the chroma map
    (``vf_transform360.c:372``).  The chroma planes take one launch of
    each kernel as two sources read where they lie (no stacking copy);
    its output is split into one view per plane.  Tensors are transformed
    on their own device; numpy planes are copied to ``device``.
    """
    placed = [_placed(p, device) for p in planes]
    if len(planes) != plan.n_planes:
        raise ValueError(
            f"expected {plan.n_planes} plane(s) for {plan.pix_fmt}, got {len(planes)}"
        )
    (y, dev), rest = placed[0], placed[1:]
    outs = [_executor(plan.luma, dev)(y)]
    if rest:
        devs = {d for _, d in rest}
        if len(devs) > 1:
            raise ValueError(f"the chroma planes lie on several devices: {sorted(map(str, devs))}")
        stacked = _executor(plan.chroma, devs.pop())(*[p for p, _ in rest])
        outs.extend(torch.split(stacked, [p.shape[0] for p, _ in rest], dim=0))
    return tuple(outs)


def transform_planes(plan: TransformPlan, y, u, v, device="cuda"):
    """YUV 3-plane convenience over :func:`transform_frame_planes`."""
    return transform_frame_planes(plan, (y, u, v), device=device)


def transform_batch(plan: TransformPlan, y, u=None, v=None, device="cuda"):
    """Transform a batch of planar frames.

    ``y``: [B, H, W] (or [H, W] for one frame), uint8 or, for deep
    formats, uint16; ``u``/``v``: the chroma planes (omit for single-plane
    formats).  Tensors are transformed on their own device, read where
    they lie (they must outlive the work queued on the current stream);
    numpy planes are copied to ``device`` (where a graph replays, into the
    buffer it keeps for them).  Returns new planes of the same dtype at the
    negotiated output size on the planes' device (a bare tensor for
    single-plane formats).
    """
    planes = [p for p in (y, u, v) if p is not None]
    squeeze = len(planes[0].shape) == 2
    if squeeze:
        planes = [p[None] for p in planes]
    outs = transform_frame_planes(plan, planes, device=device)
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
    plane, dev = _placed(plane, device)
    squeeze = plane.dim() == 2
    if squeeze:
        plane = plane[None]
    out = _executor(pp, dev)(plane)
    return out[0] if squeeze else out
