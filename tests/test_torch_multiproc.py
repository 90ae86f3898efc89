"""Multi-process runs of the port (``transform360_tpu_torch.parallel.distributed``)
on the CPU: two ``python`` processes that import only the port join a
``torch.distributed`` gloo group at ``tcp://127.0.0.1:PORT`` and each
transform its part; the parts stitched in process order equal one
process's output byte for byte.

* Library, one rendezvous: "local" feeding (each process shards only its
  run of the global batch, ``shard_batch_local``), "full" feeding (every
  process passes the whole batch to ``Transform360(mesh=global_mesh())``)
  and banded mode (each process runs its group of the global bands,
  ``local_band_range``), 2 CPU mesh entries per process.
* The CLI with ``--distributed 127.0.0.1:PORT,2,PID``: batch mode (each
  process writes its run of every batch, a short final batch included)
  and banded mode (each process writes its row slice of every frame).

Every spawn has a 120 s timeout; a failed rendezvous fails the test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu_torch.parallel.latency import band_plans, local_band_range
from transform360_tpu_torch.utils.yuv import read_yuv420_batch, write_yuv420_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_W, IN_H, OUT_W, OUT_H = 256, 128, 96, 64
CFG = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO,
           interpolation_alg=Interpolation.CUBIC, enable_low_pass_filter=1)

WORKER = r"""
import sys
import numpy as np
import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu_torch.parallel import distributed as dist, transform_batch_sharded
from transform360_tpu_torch.parallel.latency import local_band_range, transform_frame_banded

pid, nproc, coord, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.initialize(coord, nproc, pid)
assert dist.is_initialized() and dist.process_count() == nproc and dist.process_index() == pid
mesh = dist.global_mesh(["cpu"] * 2)
assert mesh.size == 2 * nproc
cfg = TransformConfig(input_stereo_format=StereoFormat.MONO,
                      output_stereo_format=StereoFormat.MONO,
                      interpolation_alg=Interpolation.CUBIC, enable_low_pass_filter=1)
plan = P.build_plan(cfg, 256, 128, 96, 64)
B = 2 * mesh.size
rng = np.random.default_rng(0)
y = rng.integers(0, 256, (B, 128, 256), dtype=np.uint8)
u = rng.integers(0, 256, (B, 64, 128), dtype=np.uint8)
v = rng.integers(0, 256, (B, 64, 128), dtype=np.uint8)
res = {}
lo, hi = pid * B // nproc, (pid + 1) * B // nproc
local = transform_batch_sharded(mesh, plan, *dist.shard_batch_local(mesh, y[lo:hi], u[lo:hi],
                                                                     v[lo:hi]))
full = P.Transform360(cfg, 96, 64, mesh=mesh, device="cpu").transform(y, u, v)
for mode, outs in (("local", local), ("full", full)):
    for name, o in zip("yuv", outs):
        res[f"{mode}.{name}.idx"], res[f"{mode}.{name}"] = dist.local_output_frames(o)
parts = transform_frame_banded(plan, (y[0], u[0], v[0]), devices=list(mesh.devices),
                               n=mesh.size, row_costs="auto",
                               bands_slice=local_band_range(mesh.size))
for name, p in zip("yuv", parts):
    res[f"banded.{name}"] = p
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "transform360_tpu")]
assert not bad, bad
np.savez(f"{out}/p{pid}.npz", **res)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs, timeout=120):
    """Run one process per argv (the same coordinator), wait for all."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable] + a, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for a in argvs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a process did not finish within {timeout} s: {argvs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {pid} rc={p.returncode}\n{log[-3000:]}"


def _reference(B):
    plan = P.build_plan(TransformConfig(**CFG), IN_W, IN_H, OUT_W, OUT_H)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (B, IN_H, IN_W), dtype=np.uint8)
    u = rng.integers(0, 256, (B, IN_H // 2, IN_W // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (B, IN_H // 2, IN_W // 2), dtype=np.uint8)
    return [o.numpy() for o in P.transform_batch(plan, y, u, v, device="cpu")]


def test_two_processes_library_match_one(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    _spawn([["-c", WORKER, str(pid), "2", coord, str(tmp_path)] for pid in range(2)])
    parts = [np.load(tmp_path / f"p{pid}.npz") for pid in range(2)]
    want = _reference(8)
    for mode in ("local", "full"):
        for name, w in zip("yuv", want):
            idx = np.concatenate([z[f"{mode}.{name}.idx"] for z in parts])
            assert idx.tolist() == list(range(8)), (mode, name, idx)  # each frame once
            got = np.concatenate([z[f"{mode}.{name}"] for z in parts])
            np.testing.assert_array_equal(got, w)
    for name, w in zip("yuv", want):
        np.testing.assert_array_equal(
            np.concatenate([z[f"banded.{name}"] for z in parts]), w[0])


def _cli_input(tmp_path, frames):
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (frames, 128, 64), dtype=np.uint8)
    u = rng.integers(0, 256, (frames, 64, 32), dtype=np.uint8)
    v = rng.integers(0, 256, (frames, 64, 32), dtype=np.uint8)
    write_yuv420_batch(str(tmp_path / "in.yuv"), y, u, v)
    vf = "w=64:h=32:input_stereo_format=mono:output_layout=equirect:interpolation_alg=cubic"
    args = ["-m", "transform360_tpu_torch.cli", "--vf", vf, "--input-size", "64x128",
            "-i", str(tmp_path / "in.yuv"), "--device", "cpu"]
    from transform360_tpu_torch.cli import main

    assert main(args[2:] + ["-o", str(tmp_path / "one.yuv")]) == 0
    return args, read_yuv420_batch(str(tmp_path / "one.yuv"), 64, 32)


def test_two_processes_cli_batch_mode(tmp_path):
    """6 frames, --batch 4 over 2 processes x 2 CPU mesh entries: process
    p writes frames [2p, 2p + 2) of each batch of 4; stitched batch by
    batch they are the one-process output."""
    args, want = _cli_input(tmp_path, 6)
    coord = f"127.0.0.1:{_free_port()}"
    _spawn([args + ["-o", str(tmp_path / f"p{pid}.yuv"), "--batch", "4", "--devices", "2",
                    "--distributed", f"{coord},2,{pid}"] for pid in range(2)])
    parts = [read_yuv420_batch(str(tmp_path / f"p{pid}.yuv"), 64, 32) for pid in range(2)]
    assert [p[0].shape[0] for p in parts] == [4, 2]  # the short last batch is process 0's
    order = [(0, slice(0, 2)), (1, slice(0, 2)), (0, slice(2, 4))]
    for j, w in enumerate(want):
        got = np.concatenate([parts[pid][j][sl] for pid, sl in order])
        np.testing.assert_array_equal(got, w)


def test_two_processes_cli_banded_mode(tmp_path):
    """--latency-bands 4 over 2 processes: process p writes the rows of
    global bands local_band_range(4, p, 2) of every frame."""
    args, want = _cli_input(tmp_path, 3)
    coord = f"127.0.0.1:{_free_port()}"
    _spawn([args + ["-o", str(tmp_path / f"p{pid}.yuv"), "--latency-bands", "4",
                    "--distributed", f"{coord},2,{pid}"] for pid in range(2)])
    plan = P.open_filter(args[3], 64, 128, device="cpu").plan
    bands = band_plans(plan, 4)
    got = [np.empty_like(w) for w in want]
    row = [0, 0]
    for pid in range(2):
        b0, b1 = local_band_range(4, pid, 2)
        hs = [sum(b.luma.out_h for b in bands[b0:b1]), sum(b.chroma.out_h for b in bands[b0:b1])]
        raw = np.fromfile(tmp_path / f"p{pid}.yuv", np.uint8)
        sizes = [hs[0] * 64, hs[1] * 32, hs[1] * 32]
        assert raw.size == 3 * sum(sizes)
        frames = raw.reshape(3, -1)
        for j, (lo, n) in enumerate(zip(np.cumsum([0] + sizes[:-1]), sizes)):
            k = min(j, 1)
            got[j][:, row[k]:row[k] + hs[k]] = frames[:, lo:lo + n].reshape(3, hs[k], -1)
        row = [row[0] + hs[0], row[1] + hs[1]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
