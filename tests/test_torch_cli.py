"""The port's CLI (``transform360_tpu_torch.cli``) against the JAX package's.

* Raw yuv420p at the fidelity gate's size (1920x960 -> 480x320, cubic,
  prefilter on), 4 frames, ``--device cpu``: ``--batch 1`` (every frame on
  the small-batch route) and ``--batch 3`` (a batch and a 1-frame tail)
  write the same bytes, and match the JAX CLI's output file within the
  bound of tests/test_torch_pipeline.py for the port's own plan (at least
  99.5% identical pixels and 50 dB per plane).
* ``-i - -o -`` streams through stdin/stdout and equals the file run.
* Flags whose modules are not ported raise ``NotImplementedError`` naming
  their ROADMAP item.
"""

import io
import json
import sys
import types

import numpy as np
import pytest

from transform360_tpu.cli import main as jax_cli_main
from transform360_tpu.fidelity import _video_like_planes
from transform360_tpu_torch.cli import main as cli_main
from transform360_tpu_torch.utils.yuv import read_yuv420_batch, write_yuv420_batch

from conftest import psnr

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
    "flags, item",
    [
        (["--devices", "2"], "A13"),
        (["--latency-bands", "2"], "A13"),
        (["--distributed", "env"], "A13"),
        (["--backend", "native"], "A14"),
        (["--save-plan", "p.npz"], "A11"),
        (["--load-plan", "p.npz"], "A11"),
    ],
)
def test_unported_flags_raise_naming_the_roadmap_item(tmp_path, flags, item):
    src = _stream(tmp_path / "in.yuv", 256, 128, 1)
    args = ["--vf", "cube_edge_length=32:input_stereo_format=mono", "--input-size",
            "256x128", "-i", str(src), "-o", str(tmp_path / "o.yuv"), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        cli_main(args + flags)
    assert not (tmp_path / "o.yuv").exists()
