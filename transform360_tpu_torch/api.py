"""Public API: :class:`Transform360` and :func:`open_filter`, as in
``transform360_tpu.api``, with an explicit torch ``device``.

* :class:`Transform360` mirrors the C ABI surface
  (``VideoFrameTransformHandler.h:24-47``): construct from a config,
  generate maps, transform plane buffers.
* :func:`open_filter` mirrors the FFmpeg filter shell: it parses the
  option string (``vf_transform360.c:407-987``), negotiates the output
  geometry (``vf_transform360.c:167-304``) and returns a ready engine.

The engine's device (default ``"cuda"``) is where planes are transformed:
inputs are moved there, outputs are tensors there, uint8 or, for the deep
pixel formats, uint16.  With ``mesh=`` (:func:`.parallel.make_mesh`, or a
sequence of devices) a ``[B, H, W]`` batch is sharded over the mesh's
devices instead, and each output plane is a
:class:`.parallel.mesh.ShardedBatch`.  ``backend="native"`` runs the
dependency-free C++ engine (:mod:`.native`) on the host's CPU instead:
8-bit formats only, its device is ``cpu`` and its outputs are CPU uint8
tensors; without a C++ compiler it raises, and nothing degrades
silently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import (
    StereoFormat,
    TransformConfig,
    get_pixel_format,
    negotiate_output_geometry,
    parse_options,
    resolve_stereo_formats,
)
from .parallel.mesh import as_mesh, transform_batch_sharded
from .pipeline import device_of, drop_executors, transform_batch, transform_plane
from .plan import TransformPlan, build_plan, load_plan, save_plan
from .utils.profiling import span


class Transform360:
    """Stateful transform engine for one (config, output size) on one device."""

    def __init__(
        self,
        config: TransformConfig,
        out_w: Optional[int] = None,
        out_h: Optional[int] = None,
        backend: str = "auto",
        pix_fmt: str = "yuv420p",
        mesh=None,
        device="cuda",
    ):
        """``backend``: "auto" (the PyTorch pipeline on ``device``) or
        "native" (the dependency-free C++ engine on the host's CPU, with
        the reference's threading model; see :mod:`.native`; ``device``
        is then ``cpu``).  ``mesh``: shard ``[B, H, W]`` batches over
        these devices (a :class:`.parallel.mesh.Mesh` or a sequence of
        devices; B must be a multiple of its size).  ``device``: where
        frames are transformed otherwise ("cuda" launches the hand-written
        kernels; "cpu" runs their plain PyTorch versions)."""
        config.validate()
        if backend not in ("auto", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        if mesh is not None and backend == "native":
            raise ValueError("mesh sharding requires the auto backend")
        self._backend = backend
        self._mesh = None if mesh is None else as_mesh(mesh)
        self._pix_fmt = get_pixel_format(pix_fmt)
        self._device = torch.device("cpu") if backend == "native" else device_of(device)
        self._cfg = config
        self._out_w = out_w
        self._out_h = out_h
        self._plan: Optional[TransformPlan] = None
        self._native = None

    @property
    def config(self) -> TransformConfig:
        return self._cfg

    @property
    def plan(self) -> Optional[TransformPlan]:
        return self._plan

    @property
    def device(self) -> torch.device:
        return self._device

    def generate_map(self, in_w: int, in_h: int) -> TransformPlan:
        """Build (on the CPU) the warp maps + filter plan for this input
        size and move their arrays to the engine's device."""
        if self._out_w is None or self._out_h is None:
            raise ValueError("output size not set; use open_filter or pass out_w/out_h")
        cfg = self._cfg
        if StereoFormat.GUESS in (cfg.input_stereo_format, cfg.output_stereo_format):
            in_fmt, out_fmt = resolve_stereo_formats(cfg, in_w, in_h)
            cfg = cfg.replace(input_stereo_format=in_fmt, output_stereo_format=out_fmt)
        self.use_plan(build_plan(cfg, in_w, in_h, self._out_w, self._out_h, self._pix_fmt))
        return self._plan

    def use_plan(self, plan: TransformPlan) -> None:
        """Adopt a ready plan (e.g. :func:`..plan.plan_from_jax`) and move
        its arrays to the engine's device; the executors (and their CUDA
        graphs) of the plan it replaces are dropped."""
        if plan.pix_fmt != self._pix_fmt.name:
            raise ValueError(
                f"plan was built for pix_fmt {plan.pix_fmt!r} but this engine "
                f"is {self._pix_fmt.name!r}"
            )
        devices = {self._device} | set(() if self._mesh is None else self._mesh.devices)
        for pp in (plan.luma, plan.chroma):
            if pp is not None:
                for d in devices:
                    pp.tables(d)
        if self._plan is not None and self._plan is not plan:
            drop_executors(self._plan)
        self._plan = plan
        self._out_w, self._out_h = plan.out_w, plan.out_h

    def _ensure_plan(self, in_w: int, in_h: int) -> TransformPlan:
        if self._plan is None or self._plan.in_w != in_w or self._plan.in_h != in_h:
            self.generate_map(in_w, in_h)
        return self._plan

    def transform(self, y, u=None, v=None):
        """Transform one frame or a batch of planar frames.

        ``y``: [H, W] or [B, H, W] (numpy array or tensor), uint8 or, for
        the deep pixel formats, uint16; ``u``/``v`` the chroma planes (omit
        for single-plane formats).  Maps are generated lazily on the first
        frame, like the reference filter.  Returns tensors of the same
        dtype on the engine's device (a bare tensor for single-plane
        formats); with a mesh, a ``[B, H, W]`` batch returns a
        :class:`.parallel.mesh.ShardedBatch` per plane instead, each shard
        on its device until ``.cpu()``/``.numpy()`` joins them in batch
        order.  CUDA work is queued on the current stream; reading the
        result waits for it.  Every batch size runs the same kernels (K1,
        then the window-gather remap K3), through the plan's executors
        (:func:`..pipeline.plane_executor`): a batch of at most
        ``GRAPH_MAX_BATCH`` frames replays a captured CUDA graph.
        """
        return self.transform_async(y, u, v)

    def transform_async(self, y, u=None, v=None):
        """Submit a transform without waiting for the card: the name the
        CLI pipeline calls (as ``transform360_tpu.api.Transform360
        .transform_async``).  Returns device tensors whose work is queued
        on the current stream; ``.cpu()`` waits for it.  Batches retire
        in submission order because one stream runs them in order.  On
        the native backend this is synchronous (CPU tensors out).  While
        a torch profiler records, the call is the span ``t360.transform``
        (:func:`.utils.profiling.span`)."""
        with span("transform"):
            if self._backend == "native":
                return self._transform_native(y, u, v)
            if self._mesh is not None and getattr(y, "ndim", None) == 3:
                n = self._mesh.size
                if y.shape[0] % n:
                    raise ValueError(
                        f"batch {y.shape[0]} is not divisible by the mesh size {n}"
                    )
                in_h, in_w = y.shape[-2:]
                plan = self._ensure_plan(int(in_w), int(in_h))
                return transform_batch_sharded(self._mesh, plan, y, u, v)
            planes = [self._on_device(p) for p in (y, u, v)]
            in_h, in_w = planes[0].shape[-2:]
            plan = self._ensure_plan(int(in_w), int(in_h))
            return transform_batch(plan, *planes, device=self._device)

    def _on_device(self, p):
        """A tensor moved to the engine's device; a numpy plane as it is
        (the executor copies it to the card once, into the buffer its
        graph keeps where it replays one)."""
        return p.to(self._device) if isinstance(p, torch.Tensor) else p

    def _transform_native(self, y, u, v):
        from . import native

        pf = self._pix_fmt
        if pf.depth > 8:
            raise ValueError(
                f"the native (C++) engine is 8-bit only — {pf.name} "
                "requires the auto backend (the reference engine wraps "
                "planes as CV_8U, VideoFrameTransform.cpp:1331-1335)"
            )
        # a device tensor is copied to the host explicitly (the engine's
        # device is the CPU); numpy arrays and CPU tensors are not copied
        planes = [p.cpu() if isinstance(p, torch.Tensor) else p
                  for p in (y, u, v) if p is not None]
        if len(planes) != pf.n_planes:
            raise ValueError(
                f"expected {pf.n_planes} plane(s) for {pf.name}, got {len(planes)}"
            )
        if self._out_w is None or self._out_h is None:
            raise ValueError("output size not set")
        cfg = self._cfg
        if StereoFormat.GUESS in (cfg.input_stereo_format, cfg.output_stereo_format):
            in_fmt, out_fmt = resolve_stereo_formats(
                cfg, planes[0].shape[-1], planes[0].shape[-2]
            )
            cfg = cfg.replace(input_stereo_format=in_fmt, output_stereo_format=out_fmt)
        if self._native is None or self._native.config != cfg:
            self._native = native.NativeTransform(cfg)
        # single frame, or batch via the C engine's frame-pool runner (one
        # worker per frame, maps generated once)
        outs = self._native.transform_planar(planes, self._out_w, self._out_h, pf.name)
        outs = tuple(torch.from_numpy(o) for o in outs)
        return outs if len(outs) > 1 else outs[0]

    def transform_frame_plane(
        self, plane, map_plane_index: int, in_w: int, in_h: int
    ) -> torch.Tensor:
        """Single-plane raw-buffer entry, mirroring
        ``VideoFrameTransform_transformFramePlane``
        (``VideoFrameTransformHandler.h:36-47``)."""
        if map_plane_index == 0:
            self._ensure_plan(in_w, in_h)
        elif self._plan is None:
            raise RuntimeError("generate luma map before transforming chroma planes")
        return transform_plane(self._plan, self._on_device(plane), map_plane_index,
                               device=self._device)

    def output_dims(self) -> Tuple[int, int]:
        return self._out_w, self._out_h

    def save_plan(self, path: str) -> None:
        """Write the engine's plan to a plan file (see :func:`..plan.save_plan`;
        the JAX package reads it too)."""
        if self._plan is None:
            raise RuntimeError("no plan to save; call generate_map first")
        save_plan(self._plan, path)

    def load_plan(self, path: str) -> None:
        """Adopt a plan from a file written by either package, in place of
        generating the maps, and move its arrays to the engine's device."""
        self.use_plan(load_plan(path))


def open_filter(
    options: str,
    in_w: int,
    in_h: int,
    eager: bool = True,
    backend: str = "auto",
    pix_fmt: str = "yuv420p",
    mesh=None,
    device="cuda",
) -> Transform360:
    """FFmpeg-shell analog: parse the option string, negotiate output
    geometry against the input size, and return a ready engine on
    ``device``."""
    opts = parse_options(options)
    out_w, out_h, cfg = negotiate_output_geometry(opts, in_w, in_h)
    t = Transform360(
        cfg, out_w, out_h, backend=backend, pix_fmt=pix_fmt, mesh=mesh, device=device
    )
    if eager and backend != "native":
        t.generate_map(in_w, in_h)
    return t
