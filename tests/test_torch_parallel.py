"""Batch sharding in the port (``transform360_tpu_torch.parallel.mesh``) and
the API and CLI wiring of ``parallel/`` on the CPU.

* Over a mesh of ``["cpu"] * 4`` (a mesh may name one device more than
  once), ``transform_batch_sharded`` at B = 8 is byte-identical to
  ``transform_batch``, with and without the prefilter, at 10 bits and on
  gray; the shards are contiguous equal runs of the batch, each on its
  mesh entry's device, and stay there until read; a batch that the mesh
  size does not divide raises, as in the JAX package.
* ``open_filter(mesh=...)`` shards 3-D batches and equals the unsharded
  engine; a single [H, W] frame takes the engine's own device.
* The CLI: ``--devices 1`` and ``2`` (with a tail batch padded for the
  mesh), ``--latency-bands 2`` and the bands x frames grid on a raw
  4-frame file give the plain CLI run's bytes; usage errors exit with 2.
"""

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from transform360_tpu_torch.cli import main as cli_main
from transform360_tpu_torch.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu_torch.parallel import (
    batch_sharding, make_mesh, shard_batch, transform_batch_sharded,
)
from transform360_tpu_torch.parallel.mesh import Mesh, ShardedBatch
from transform360_tpu_torch.utils.yuv import write_yuv420_batch

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
MESH = ["cpu"] * 4


def make_batch(rng, b, h, w, pf="yuv420p"):
    pf = P.config.get_pixel_format(pf)
    dt = np.uint8 if pf.depth == 8 else np.uint16
    cw, ch = P.chroma_dims(w, h, pf)
    out = [rng.integers(0, pf.maxval + 1, (b, h, w)).astype(dt)]
    return out + [rng.integers(0, pf.maxval + 1, (b, ch, cw)).astype(dt)
                  for _ in range(pf.n_planes - 1)]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("cfg, pf", [
    (TransformConfig(interpolation_alg=Interpolation.LINEAR, enable_low_pass_filter=0, **MONO),
     "yuv420p"),
    (TransformConfig(**MONO), "yuv420p"),  # cubic + the prefilter
    (TransformConfig(**MONO), "yuv420p10le"),
    (TransformConfig(width_scale_factor=2.0, height_scale_factor=2.0, **MONO), "gray"),
], ids=["linear", "prefilter", "10bit", "supersampled-gray"])
def test_sharded_equals_unsharded(rng, cfg, pf):
    plan = P.build_plan(cfg, 128, 64, 48, 32, pf)
    planes = make_batch(rng, 8, 64, 128, pf)
    want = as_tuple(P.transform_batch(plan, *planes, device="cpu"))
    got = as_tuple(transform_batch_sharded(MESH, plan, *planes))
    assert len(got) == len(want) == plan.n_planes
    for g, w in zip(got, want):
        assert isinstance(g, ShardedBatch) and g.shape == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        assert torch.equal(g.cpu(), w)


def test_batch_actually_sharded(rng):
    mesh = make_mesh(MESH)
    assert isinstance(mesh, Mesh) and mesh.size == 4 and mesh.process_count == 1
    y = make_batch(rng, 16, 64, 128)[0]
    ys = shard_batch(mesh, y)
    assert [tuple(s.shape) for s in ys.shards] == [(4, 64, 128)] * 4  # 16 frames / 4
    assert ys.offsets == (0, 4, 8, 12) and all(s.device.type == "cpu" for s in ys.shards)
    np.testing.assert_array_equal(ys.indices(), np.arange(16))
    np.testing.assert_array_equal(ys.numpy(), y)
    assert batch_sharding(mesh).shards(8) == [(torch.device("cpu"), 2 * i, 2 * i + 2)
                                              for i in range(4)]
    # tensors are sharded too, and an output keeps its shards apart
    plan = P.build_plan(TransformConfig(**MONO), 128, 64, 48, 32, "gray")
    out = transform_batch_sharded(mesh, plan, torch.from_numpy(y))
    assert len(out.shards) == 4 and out.offsets == (0, 4, 8, 12)


def test_indivisible_batch_raises(rng):
    plan = P.build_plan(TransformConfig(**MONO), 128, 64, 48, 32)
    planes = make_batch(rng, 6, 64, 128)
    with pytest.raises(ValueError, match="not divisible by the mesh size 4"):
        transform_batch_sharded(MESH, plan, *planes)
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh([])


def test_api_mesh_wiring(rng):
    vf = ("w=48:h=32:input_stereo_format=mono:output_layout=equirect:"
          "interpolation_alg=linear:enable_low_pass_filter=0")
    y, u, v = make_batch(rng, 8, 64, 128)
    want = P.open_filter(vf, 128, 64, device="cpu").transform(y, u, v)
    t = P.open_filter(vf, 128, 64, mesh=MESH, device="cpu")
    got = t.transform(y, u, v)
    for g, w in zip(got, want):
        assert isinstance(g, ShardedBatch) and len(g.shards) == 4
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    one = t.transform(y[0], u[0], v[0])  # one frame: the engine's device, no mesh
    for g, w in zip(one, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), w[0].numpy())
    with pytest.raises(ValueError, match="not divisible"):
        t.transform(y[:3], u[:3], v[:3])


def _cli_input(tmp_path, rng, frames=4):
    y, u, v = make_batch(rng, frames, 128, 64)
    path = tmp_path / "in.yuv"
    write_yuv420_batch(str(path), y, u, v)
    vf = ("w=64:h=32:input_stereo_format=mono:output_layout=equirect:"
          "interpolation_alg=cubic")
    return ["--vf", vf, "--input-size", "64x128", "-i", str(path), "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--devices", "1"],
    ["--devices", "2", "--batch", "2"],
    ["--devices", "3", "--batch", "3"],  # a 1-frame tail batch, padded to the mesh
    ["--devices", "0", "--batch", "4"],
    ["--latency-bands", "2"],
    ["--latency-bands", "-1", "--devices", "3"],
    ["--latency-bands", "2", "--devices", "4"],  # 2 frames in flight
], ids=["devices1", "devices2", "devices3-tail", "devices0", "bands2", "bands-per-device",
        "bands-grid"])
def test_cli_parallel_flags_give_the_plain_bytes(tmp_path, rng, flags):
    args = _cli_input(tmp_path, rng)
    assert cli_main(args + ["-o", str(tmp_path / "plain.yuv"), "--batch", "3"]) == 0
    assert cli_main(args + ["-o", str(tmp_path / "par.yuv")] + flags) == 0
    assert (tmp_path / "par.yuv").read_bytes() == (tmp_path / "plain.yuv").read_bytes()


@pytest.mark.parametrize("flags, message", [
    (["--devices", "3", "--batch", "4"], "not a multiple of --devices 3"),
    (["--distributed", "nonsense"], "--distributed expects"),
], ids=["batch-not-multiple", "bad-distributed"])
def test_cli_usage_errors(tmp_path, rng, capsys, flags, message):
    args = _cli_input(tmp_path, rng, frames=1)
    assert cli_main(args + ["-o", str(tmp_path / "o.yuv")] + flags) == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "o.yuv").exists()


def test_cli_banded_distributed_needs_raw_output(tmp_path, rng, capsys):
    args = _cli_input(tmp_path, rng, frames=1)
    assert cli_main(args + ["-o", str(tmp_path / "o.mp4"), "--latency-bands", "2",
                            "--distributed", "127.0.0.1:1,2,0"]) == 2
    assert "use raw output" in capsys.readouterr().err
