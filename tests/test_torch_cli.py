"""The port's CLI (``transform360_tpu_torch.cli``) against the JAX package's.

* Raw yuv420p at the fidelity gate's size (1920x960 -> 480x320, cubic,
  prefilter on), 4 frames, ``--device cpu``: ``--batch 1`` (every frame on
  the small-batch route) and ``--batch 3`` (a batch and a 1-frame tail)
  write the same bytes, and match the JAX CLI's output file within the
  bound of tests/test_torch_pipeline.py for the port's own plan (at least
  99.5% identical pixels and 50 dB per plane).
* ``-i - -o -`` streams through stdin/stdout and equals the file run.
* ``--save-plan`` then ``--load-plan`` give the same bytes as the API,
  and the saved file loads in the JAX package; a 10-bit raw stream
  (``--pix-fmt yuv420p10le``, 16-bit little-endian samples) equals the
  API's bytes.
* ``--backend native`` (the C++ engine, ROADMAP A14) writes the API's
  bytes, and refuses ``--devices``, ``--latency-bands`` and
  ``--distributed`` with exit code 2 and no output file, as the JAX CLI
  does (tests/test_torch_parallel.py and test_torch_multiproc.py run
  those flags on the auto backend; tests/test_torch_native.py holds the
  native engine against the JAX package's).
"""

import io
import json
import sys
import types

import numpy as np
import pytest

from transform360_tpu.cli import main as jax_cli_main
from transform360_tpu.fidelity import _video_like_planes
from transform360_tpu.plan import load_plan as jax_load_plan
import transform360_tpu_torch as P
from transform360_tpu_torch.cli import main as cli_main
from transform360_tpu_torch.utils.yuv import (
    read_yuv420_batch, write_yuv420_batch, write_yuv420_frames,
)

from conftest import psnr
from test_torch_deep import deep_planes

GATE_VF = ("cube_edge_length=160:interpolation_alg=cubic:enable_low_pass_filter=1:"
           "input_stereo_format=mono")


def _stream(path, w, h, n):
    y, u, v = _video_like_planes(w, h)
    planes = [np.stack([np.roll(p, 11 * k, axis=1) for k in range(n)]) for p in (y, u, v)]
    write_yuv420_batch(str(path), *planes)
    return path


def test_cli_matches_jax_cli_at_gate_size(tmp_path, capsys):
    src = _stream(tmp_path / "in.yuv", 1920, 960, 4)
    common = ["--vf", GATE_VF, "--input-size", "1920x960", "-i", str(src)]
    assert jax_cli_main(common + ["-o", str(tmp_path / "jax.yuv"), "--batch", "4"]) == 0
    for b in ("1", "3"):
        out = tmp_path / f"port{b}.yuv"
        assert cli_main(common + ["-o", str(out), "--batch", b, "--device", "cpu",
                                  "--stats"]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["frames"] == 4 and stats["device"] == "cpu"
        assert stats["batches"] == (4 if b == "1" else 2)
    one = (tmp_path / "port1.yuv").read_bytes()
    assert one == (tmp_path / "port3.yuv").read_bytes()
    got = read_yuv420_batch(str(tmp_path / "port1.yuv"), 480, 320)
    want = read_yuv420_batch(str(tmp_path / "jax.yuv"), 480, 320)
    for a, b, name in zip(got, want, "YUV"):
        assert a.shape == b.shape and a.shape[0] == 4
        assert (a == b).mean() >= 0.995, (name, (a == b).mean())
        assert psnr(a, b) >= 50.0, (name, psnr(a, b))


def test_cli_stdin_stdout_pipe(tmp_path, monkeypatch):
    src = _stream(tmp_path / "in.yuv", 256, 128, 5)
    vf = "w=96:h=64:input_stereo_format=mono:interpolation_alg=linear"
    args = ["--vf", vf, "--input-size", "256x128", "--batch", "2", "--stats",
            "--device", "cpu"]
    assert cli_main(args + ["-i", str(src), "-o", str(tmp_path / "want.yuv")]) == 0
    fake_in = types.SimpleNamespace(buffer=io.BytesIO(src.read_bytes()))
    fake_out = types.SimpleNamespace(buffer=io.BytesIO())
    monkeypatch.setattr(sys, "stdin", fake_in)
    monkeypatch.setattr(sys, "stdout", fake_out)
    try:
        rc = cli_main(args + ["-i", "-", "-o", "-"])
    finally:
        monkeypatch.undo()
    assert rc == 0
    assert fake_out.buffer.getvalue() == (tmp_path / "want.yuv").read_bytes()


@pytest.mark.parametrize(
    "flags, refusal",
    [
        (["--devices", "2", "--backend", "native"], "--devices requires the auto backend"),
        (["--latency-bands", "2", "--backend", "native"],
         "--latency-bands requires the auto backend"),
        (["--distributed", "env", "--backend", "native"],
         "--distributed requires the auto backend"),
        (["--backend", "native"], None),
    ],
)
def test_unported_flags_raise_naming_the_roadmap_item(tmp_path, capsys, flags, refusal):
    # ROADMAP A14, served now: the native backend refuses the auto
    # backend's device, band and process flags; alone it writes the API's bytes
    vf = "cube_edge_length=32:input_stereo_format=mono"
    src = _stream(tmp_path / "in.yuv", 256, 128, 2)
    out = tmp_path / "o.yuv"
    args = ["--vf", vf, "--input-size", "256x128", "-i", str(src), "-o", str(out),
            "--device", "cpu"]
    rc = cli_main(args + flags)
    if refusal:
        assert rc == 2 and refusal in capsys.readouterr().err
        assert not out.exists()
        return
    assert rc == 0
    planes = read_yuv420_batch(str(src), 256, 128)
    api = [o.numpy() for o in P.open_filter(vf, 256, 128, backend="native").transform(*planes)]
    assert out.read_bytes() == b"".join(p[k].tobytes() for k in range(2) for p in api)


def _api_bytes(vf, w, h, planes, pix_fmt):
    out = P.open_filter(vf, w, h, pix_fmt=pix_fmt, device="cpu").transform(*planes)
    out = [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]
    le = [o.astype("<u2") if o.dtype == np.uint16 else o for o in out]
    return b"".join(p[k].tobytes() for k in range(out[0].shape[0]) for p in le)


def test_cli_save_plan_then_load_plan(tmp_path):
    src = _stream(tmp_path / "in.yuv", 256, 128, 3)
    vf = ("cube_edge_length=32:interpolation_alg=cubic:input_stereo_format=mono:"
          "width_scale_factor=2:height_scale_factor=2")
    args = ["--vf", vf, "--input-size", "256x128", "-i", str(src), "--device", "cpu",
            "--batch", "2"]
    plan = tmp_path / "plan.npz"
    assert cli_main(args + ["-o", str(tmp_path / "a.yuv"), "--save-plan", str(plan)]) == 0
    assert plan.is_file()
    assert cli_main(args + ["-o", str(tmp_path / "b.yuv"), "--load-plan", str(plan)]) == 0
    a, b = (tmp_path / "a.yuv").read_bytes(), (tmp_path / "b.yuv").read_bytes()
    planes = read_yuv420_batch(str(src), 256, 128)
    assert a == b == _api_bytes(vf, 256, 128, planes, "yuv420p")
    jp = jax_load_plan(str(plan))  # the file is the JAX package's format
    assert (jp.out_w, jp.out_h, jp.luma.scaled_w, jp.luma.scaled_h) == (96, 64, 192, 128)


def test_cli_deep_raw_stream(tmp_path):
    y, u, v = deep_planes(256, 128, "yuv420p10le", frames=3)
    src = tmp_path / "in10.yuv"
    write_yuv420_frames(str(src), zip(y, u, v))
    vf = "cube_edge_length=32:interpolation_alg=cubic:input_stereo_format=mono"
    out = tmp_path / "out10.yuv"
    assert cli_main(["--vf", vf, "--input-size", "256x128", "-i", str(src), "-o", str(out),
                     "--pix-fmt", "yuv420p10le", "--device", "cpu", "--batch", "2"]) == 0
    assert out.read_bytes() == _api_bytes(vf, 256, 128, (y, u, v), "yuv420p10le")
