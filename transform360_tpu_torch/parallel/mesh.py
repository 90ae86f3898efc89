"""Batch-parallel execution over several devices.

The port of ``transform360_tpu.parallel.mesh``.  Frames are independent,
so a batch of ``[B, H, W]`` planes is cut on ``B`` into contiguous equal
shards, one per mesh entry, and each shard runs the whole frame path
(K1, then K3, then INTER_AREA for a supersampled plan) on its own device
against that device's copy of the plan's tables, through that device's
plane executors (:func:`..pipeline.plane_executor`).  No collective and no
device-to-device copy runs: the host scatters the shards and reads them
back.

Torch has no global sharded array, so a :class:`Mesh` is an ordered tuple
of ``torch.device``\\ s, one shard each, plus this process's place in a
multi-process run (:mod:`.distributed`; one process by default).  A mesh
may name one device more than once: shards on the same device run one
after another on its current stream.  Outputs are :class:`ShardedBatch`
planes that keep each shard on its device until read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipeline import as_plane, device_of, transform_batch
from ..plan import TransformPlan


def default_devices() -> List[torch.device]:
    """Every visible CUDA device; raises when there is none (nothing falls
    back to the CPU: name ``"cpu"`` devices explicitly)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "pass devices such as ['cpu'] * N to run the plain PyTorch path"
        )
    return [torch.device("cuda", i) for i in range(n)]


def _as_device(d) -> torch.device:
    d = device_of(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D batch mesh: this process's ``devices``, one batch shard each,
    and the process's index and count in a multi-process run.  Process
    ``p`` holds global shards ``[p * D, (p + 1) * D)`` of ``size``."""

    devices: Tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """Shards in the global batch: local devices x processes."""
        return len(self.devices) * self.process_count


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D batch mesh of this process over all visible CUDA devices, or
    the given ones (``torch.device``\\ s or names; repeats allowed)."""
    devs = default_devices() if devices is None else [_as_device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a :func:`make_mesh` of a sequence of devices."""
    return mesh if isinstance(mesh, Mesh) else make_mesh(mesh)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """How a mesh cuts a global batch: contiguous equal shards in mesh
    order."""

    mesh: Mesh

    def shards(self, batch: int) -> List[Tuple[torch.device, int, int]]:
        """``(device, first, end)``: the global frame range of each of this
        process's shards of a global batch of ``batch`` frames."""
        n = self.mesh.size
        if batch % n:
            raise ValueError(f"batch {batch} is not divisible by the mesh size {n}")
        k = batch // n
        base = self.mesh.process_index * len(self.mesh.devices)
        return [(d, (base + i) * k, (base + i + 1) * k)
                for i, d in enumerate(self.mesh.devices)]


def batch_sharding(mesh) -> BatchSharding:
    """Sharding for ``[B, H, W]`` planes: the batch split across the mesh."""
    return BatchSharding(as_mesh(mesh))


class ShardedBatch:
    """One plane's batch as shards, each a ``[b, H, W]`` tensor on its own
    device with its global batch offset.  ``.cpu()`` and ``.numpy()``
    copy the shards to the host and join them in batch order (the
    frames this process holds)."""

    def __init__(self, shards: Sequence[torch.Tensor], offsets: Sequence[int]):
        if len(shards) != len(offsets) or not shards:
            raise ValueError("a sharded batch needs one offset per shard, and a shard")
        order = sorted(range(len(shards)), key=lambda i: offsets[i])
        self.shards = tuple(shards[i] for i in order)
        self.offsets = tuple(int(offsets[i]) for i in order)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(s.shape[0] for s in self.shards),) + tuple(self.shards[0].shape[1:])

    def indices(self) -> np.ndarray:
        """The global batch index of each frame held, in order."""
        return np.concatenate([np.arange(o, o + s.shape[0])
                               for o, s in zip(self.offsets, self.shards)])

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()


def _shard(plane, ranges, base: int) -> ShardedBatch:
    """Cut ``plane`` (its first frame is global frame ``base``) into the
    given ``(device, first, end)`` global ranges, each copied to its
    device."""
    shards = []
    for dev, lo, hi in ranges:
        p = plane[lo - base:hi - base]
        if isinstance(p, torch.Tensor):
            shards.append(p.to(dev))
        else:
            shards.append(as_plane(np.asarray(p), dev))
    return ShardedBatch(shards, [lo for _, lo, _ in ranges])


def shard_batch(mesh, *planes):
    """Place ``[B, H, W]`` planes (numpy or tensors) with the batch sharded
    over the mesh: this process's shards of the global batch ``B``.

    B must be divisible by the mesh size (pad the final partial batch).
    Returns a :class:`ShardedBatch` per plane (a bare one for one plane).
    """
    s = batch_sharding(mesh)
    out = tuple(_shard(p, s.shards(int(np.shape(p)[0])), 0) for p in planes)
    return out if len(out) > 1 else out[0]


def transform_batch_sharded(mesh, plan: TransformPlan, y, u=None, v=None):
    """Run the full-frame transform with the batch sharded over the mesh.

    Takes ``[B, H, W]`` planes (numpy, tensors, or :class:`ShardedBatch`
    from :func:`shard_batch` or :func:`.distributed.shard_batch_local`),
    transforms each shard on its device and returns a :class:`ShardedBatch`
    per output plane (a bare one for single-plane formats), each shard
    still on its device, byte-identical to :func:`..pipeline.transform_batch`
    on the same frames.
    """
    mesh = as_mesh(mesh)
    planes = [p if isinstance(p, ShardedBatch) else shard_batch(mesh, p)
              for p in (y, u, v) if p is not None]
    offsets = planes[0].offsets
    if any(p.offsets != offsets or len(p.shards) != len(offsets) for p in planes):
        raise ValueError("the planes of a batch are sharded differently")
    outs = []
    for i in range(len(offsets)):
        o = transform_batch(plan, *[p.shards[i] for p in planes])
        outs.append(o if isinstance(o, tuple) else (o,))
    res = tuple(ShardedBatch([o[j] for o in outs], offsets) for j in range(len(outs[0])))
    return res if len(res) > 1 else res[0]
