"""Batch sharding over devices (:mod:`.mesh`), single-frame latency bands
(:mod:`.latency`) and multi-process runs (:mod:`.distributed`): the port
of ``transform360_tpu.parallel``."""

from . import distributed
from .latency import band_plans, transform_frame_banded
from .mesh import batch_sharding, make_mesh, shard_batch, transform_batch_sharded

__all__ = [
    "band_plans",
    "batch_sharding",
    "distributed",
    "make_mesh",
    "shard_batch",
    "transform_batch_sharded",
    "transform_frame_banded",
]
