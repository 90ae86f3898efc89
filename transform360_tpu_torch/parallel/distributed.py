"""Multi-process scale-out.

The port of ``transform360_tpu.parallel.distributed``.  Each process owns
its local devices and a contiguous run of the global batch: process ``p``
of ``P`` holds frames ``[p * B / P, (p + 1) * B / P)``, cut again over its
local devices (:class:`.mesh.Mesh`).  No collective runs in the math path,
so ``torch.distributed`` is only the rendezvous: :func:`initialize` joins
a process group on the **gloo** backend (NCCL cannot put two ranks on one
GPU, and a one-GPU host runs several processes on the same card).

Two feeding patterns, as in the JAX package:

* every process passes the SAME full batch to :func:`.mesh.shard_batch`
  (or ``Transform360(mesh=global_mesh()).transform``): each keeps its own
  run of it (simple; decode is replicated);
* each process passes only ITS run through :func:`shard_batch_local`
  (decode is sharded too).

Outputs are :class:`.mesh.ShardedBatch` planes holding this process's
frames; :func:`local_output_frames` reads them back with their global
batch indices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, ShardedBatch, _shard, as_mesh, batch_sharding, make_mesh

# CUDA device ordinals this process was given by initialize(local_device_ids=...)
_local_device_ids: Optional[Tuple[int, ...]] = None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the process group (idempotent) on the gloo backend.

    With no address, count and id, torch's ``env://`` rendezvous reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    otherwise all three are given (``"HOST:PORT"``, ``P``, ``p``) and rank
    0 serves the rendezvous at ``tcp://HOST:PORT``.  ``local_device_ids``
    are the CUDA ordinals :func:`global_mesh` uses in this process
    (default: every visible CUDA device).
    """
    import torch.distributed as dist

    global _local_device_ids
    if is_initialized():
        return
    given = (coordinator_address, num_processes, process_id)
    if all(g is None for g in given):
        dist.init_process_group("gloo", init_method="env://")
    elif any(g is None for g in given):
        raise ValueError("coordinator_address, num_processes and process_id go together")
    else:
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process {process_id} outside [0, {num_processes})")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    _local_device_ids = None if local_device_ids is None else tuple(local_device_ids)


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The batch mesh of a multi-process run: this process's devices
    (``devices``, else those of ``initialize(local_device_ids=...)``, else
    every visible CUDA device) placed at its rank.  Processes own
    contiguous runs of the global batch axis, which
    :func:`shard_batch_local` and :func:`local_output_frames` rely on; the
    processes must hold equally many devices."""
    if devices is None and _local_device_ids is not None:
        devices = [torch.device("cuda", i) for i in _local_device_ids]
    local = make_mesh(devices)
    return Mesh(local.devices, process_index(), process_count())


def shard_batch_local(mesh, *planes):
    """Shard per-process slices of a global batch.

    Each process passes only ITS contiguous run of the global batch
    (process p of P owns frames ``[p*B/P, (p+1)*B/P)``); the shards carry
    their global offsets.  Returns a :class:`.mesh.ShardedBatch` per
    plane (a bare one for one plane)."""
    mesh = as_mesh(mesh)
    s = batch_sharding(mesh)
    out = []
    for p in planes:
        b = int(np.shape(p)[0])
        out.append(_shard(p, s.shards(b * mesh.process_count), b * mesh.process_index))
    return tuple(out) if len(out) > 1 else out[0]


def local_output_frames(arr: ShardedBatch) -> Tuple[np.ndarray, np.ndarray]:
    """This process's frames of a batch-sharded output.

    Returns ``(global_indices, frames)``: the global batch positions this
    process holds and the corresponding host numpy frames, in ascending
    order.  Purely local: nothing crosses processes."""
    return arr.indices(), arr.numpy()
