"""The port's drop-in ffmpeg wrapper (``transform360_tpu_torch.ffmpeg``)
against the JAX package's (``transform360_tpu.ffmpeg``).

* Every argv of tests/test_ffmpeg_wrapper.py and test_ffmpeg_arity.py,
  copied in below: the tokenizer, the ``-filter_complex`` rewrite and
  split (compared with ``dataclasses.asdict``), ``find_transform360``,
  ``build_commands``/``build_commands_complex`` and
  ``build_command_extra`` give the JAX module's results, and the same
  ``UsageError`` messages; so do ``_is_flag_opt``, ``pipe_format`` and
  ``probe_decoded``.
* The fake-pipe run of test_ffmpeg_wrapper.py through ``--t360-device
  cpu`` for yuv420p, yuv444p and yuv420p10le: the encoded bytes equal the
  port's ``open_filter(..., device="cpu")``.
* The two reference faults the port refuses with rc 2: a stdin or pipe
  input with two outputs (read twice), and a non-deterministic filter
  before a tee'd ``split`` (run twice); a ``scale`` there is kept.
"""

import copy
import dataclasses
import io
import subprocess

import numpy as np
import pytest

from transform360_tpu import ffmpeg as jwrap
import transform360_tpu_torch as P
from transform360_tpu_torch import ffmpeg as wrap
from transform360_tpu_torch.utils import video

from test_ffmpeg_arity import FFMPEG_FLAG_OPTIONS, FFMPEG_VALUE_OPTIONS

VF = (
    "cube_edge_length=32:input_stereo_format=mono:"
    "interpolation_alg=linear:enable_low_pass_filter=0"
)


def _fc(graph, *rest, out="out.mp4", inputs=("in.mp4",)):
    argv = []
    for i in inputs:
        argv += ["-i", i]
    return argv + ["-filter_complex", graph, *rest, out]


CORPUS = [
    ["-y", "-ss", "10", "-i", "in.mp4", "-c:v", "libx264", "-an", "out.mp4"],
    ["-i", "a.mp4", "o1.mp4", "o2.mp4"],
    ["-i", "a.mp4", "-c:v", "libx264"],
    ["-i"],
    ["-y", "-i", "in.mp4", "-vf", f"transform360={VF}", "-c:v", "libx264", "out1.mp4",
     "-c:v", "libx265", "-an", "out2.mp4"],
    ["-i", "in.mp4", "-vf", "transform360=w=64", "o1.mp4", "-vf", "transform360=w=64", "o2.mp4"],
    ["-i", "in.mp4", "-filter_complex", "[0:v]transform360=w=64[v]", "-map", "[v]", "o1.mp4",
     "-an", "o2.mp4"],
    ["-ss", "3", "-i", "in.mp4", "-c:v", "libx265", "-an", "out2.mp4"],
    ["-i", "in.mp4", "-c:v", "libx264", "-vf",
     "scale=320:160,transform360=cube_edge_length=64,hflip", "out.mp4"],
    ["-i", "in.mp4", "-filter:v", "transform360='w=64:h=32'", "out.mp4"],
    ["-i", "in.mp4", "-vf", "scale=1:1", "-b:v", "1M", "out.mp4"],
    ["-y", "-i", "in.mp4", "-vf", f"scale=256:128,transform360={VF},hflip", "-c:v", "libx264",
     "-crf", "18", "out.mp4"],
    ["-i", "in.mp4", "-vf", f"transform360={VF}", "-an", "o.mp4"],
    ["-i", "in.mp4", "-vf", f"transform360={VF}", "-map", "0:v", "o.mp4"],
    _fc("[0:v]scale=320:160,transform360=cube_edge_length=64,hflip[v]", "-map", "[v]",
        "-c:v", "libx264"),
    _fc("transform360=w=64", "-map", "0:a"),
    _fc("[0:v]scale=2:2[v]", "-map", "[v]"),
    _fc("[0:v]split[a][b];[a]transform360=w=64[v]", "-map", "[v]"),
    _fc("[0:v][1:v]overlay,transform360=w=64[v]", "-map", "[v]"),
    _fc("[1:v]transform360=w=64[v]", "-map", "[v]"),
    _fc("[0:v]transform360=w=64[v]", "-map", "[v]", "-map", "0:v"),
    _fc("[0:v]transform360=w=64[out]"),
    _fc("[0:v]scale=1920:960[s];[s]transform360=w=64[v]", "-map", "[v]", "-map", "0:a",
        "-c:a", "aac"),
    _fc("[0:v]transform360=w=64[t];[t][1:v]overlay=10:10[v]", "-map", "[v]",
        inputs=("in.mp4", "logo.png")),
    _fc("[1:v]hflip[x];[x]scale=100:50,transform360=w=64,hflip[t];"
        "[t]drawtext=text=hi[v];[0:a]volume=2[a]", "-map", "[v]", "-map", "[a]"),
    _fc("[0:v]scale=128:64[s];[s]transform360=w=64"),
    _fc("[0:v]transform360=w=64;[0:a]volume=2[a]", "-map", "[a]"),
    _fc("[1]transform360=w=64[t];[t][0:v]overlay[v]", "-map", "[v]"),
    _fc("[0:v]hflip,transform360=w=64[v];[0:a]volume=2[a]", "-map", "[v]", "-map",
        "[__t360in]"),
    _fc("[0:v]split[a][b];[a]transform360=w=64[t];[t][b]overlay[v]", "-map", "[v]"),
    _fc("[0:v]hflip,split[a][b];[a]transform360=w=64[t];[t][b]overlay[v]", "-map", "[v]"),
    _fc("[0:v]split=3[a][b][c];[a]transform360=w=64[t];[t][b]overlay[x];[x][c]overlay[v]",
        "-map", "[v]"),
    _fc("[0:v]hflip[a][b];[a]transform360=w=64[t];[t][b]overlay[v]", "-map", "[v]"),
    _fc("[0:v]scale=64:32[s];[s]split[a][b];[a]transform360=w=64[t];[t][b]overlay[v]",
        "-map", "[v]"),
    _fc("[0:v]hflip[x];[x]transform360=w=64[v]", "-map", "[v]", "-map", "[x]"),
    _fc("[0:v]transform360=w=64[a];[a]transform360=w=64[v]", "-map", "[v]"),
    _fc("[t]hflip[x];[x]transform360=w=64[t]", "-map", "[t]"),
    _fc("transform360=w=64[t];[t][1:v]overlay[v]", "-map", "[v]"),
    _fc("[0:v]scale=2:2[a];[a]hflip[v]"),
    _fc(f"[0:v]transform360={VF}[v]", "-map", "[v]", "-map", "0:a", "-c:a", "aac"),
    ["-y", "-i", "in.mp4", "-filter_complex", f"[0:v]transform360={VF}[v]", "-map", "[v]",
     "-map", "0:a", "-c:a", "aac", "out.mp4"],
    ["-i", "a.mp4", "-vf", "scale=64:32", "out.mp4"],
    ["-y", "-i", "in.mp4", "-vf", f"transform360={VF}", "out.mp4"],
    ["-y", "-i", "in.mp4", "-vf", f"transform360={VF}", "t.mp4", "-c:v", "libx265", "-an",
     "copy.mp4"],
    ["-y", "-i", "in.mp4", "-i", "logo.png", "-filter_complex",
     f"[0:v]transform360={VF}[t];[t][1:v]overlay=0:0[v]", "-map", "[v]", "-c:v", "libx264",
     "out.mp4"],
    ["-y", "-i", "in.mp4", "-apad", "whole_dur=2", "-shortest", "out.mp4"],
    ["-i", "in.yuv", "-vf", f"transform360={VF}", "-f", "rawvideo", "out.yuv"],
    ["-nostdin", "-hide_banner", "-i", "in.mp4", "-vf", f"transform360={VF}", "-n", "out.mp4"],
]

PIX_FMTS = ["yuv420p", "yuv444p", "yuvj422p", "gbrp", "gray", "yuv420p10le", "rgb24", "bgra",
            "nv12", "nv21", "p010le", "p010be", "p016le", "p210le", "yuv420p10be",
            "yuv444p12be", "yuv420p9le", "yuv422p14le", "yuv420p14be", "gray16be", "gray9le",
            None]


def _call(mod, fn, *args):
    try:
        out = fn(*args)
    except mod.UsageError as e:
        return ("UsageError", str(e))
    return dataclasses.asdict(out) if dataclasses.is_dataclass(out) else out


def _helpers(mod, argv):
    """Every pure helper's result on one argv, with UsageErrors as their
    messages."""
    res = {"tokenize": _call(mod, mod.tokenize_outputs, list(argv))}
    if res["tokenize"][0] == "UsageError":
        return res
    inputs, outputs, g = res["tokenize"]
    for k, (opts, path) in enumerate(outputs):
        res[f"extra{k}"] = mod.build_command_extra(inputs, opts, path, g)
        res[f"find{k}"] = _call(mod, mod.find_transform360, copy.deepcopy(opts))
        res[f"rewrite{k}"] = _call(mod, mod.rewrite_filter_complex, copy.deepcopy(opts))
        try:
            cs = mod.split_complex_graph(copy.deepcopy(opts))
        except mod.UsageError as e:
            res[f"split{k}"] = ("UsageError", str(e))
            continue
        if cs is not None:
            res[f"split{k}"] = dataclasses.asdict(cs)
            res[f"build{k}"] = mod.build_commands_complex(
                inputs, cs, path, g, (256, 128, 25.0), (96, 64), pix_fmt="yuv444p")
            continue
        rewritten = res[f"rewrite{k}"]
        if rewritten[0] == "UsageError":
            continue
        new_opts, needs = rewritten
        found = _call(mod, mod.find_transform360, new_opts)
        if found is not None and found[0] != "UsageError":
            res[f"build{k}"] = mod.build_commands(
                inputs, new_opts, path, g, found, (256, 128, 25.0), (96, 64),
                pix_fmt="yuv420p10le", needs_src_input=needs)
    return res


@pytest.mark.parametrize("argv", CORPUS, ids=range(len(CORPUS)))
def test_helpers_equal_the_jax_module(argv):
    assert _helpers(wrap, argv) == _helpers(jwrap, argv)


@pytest.mark.parametrize("opts", [FFMPEG_FLAG_OPTIONS + FFMPEG_VALUE_OPTIONS + [
    "-nostats", "-nostdin", "-noaccurate_seek", "-noautorotate", "-fix_sub_duration:s:0",
    "-autorotate:v", "-copyinkf:v:1"]], ids=["arity"])
def test_option_arity_equals_the_jax_module(opts):
    assert [wrap._is_flag_opt(o) for o in opts] == [jwrap._is_flag_opt(o) for o in opts]
    assert wrap.FLAG_OPTS == jwrap.FLAG_OPTS and wrap.GLOBAL_FLAGS == jwrap.GLOBAL_FLAGS


def test_pipe_format_equals_the_jax_module(capsys):
    got = [wrap.pipe_format(f) for f in PIX_FMTS]
    port_err = capsys.readouterr().err
    assert got == [jwrap.pipe_format(f) for f in PIX_FMTS]
    assert port_err == capsys.readouterr().err
    assert wrap.LOSSLESS_PIPE == jwrap.LOSSLESS_PIPE


def test_probe_decoded_equals_the_jax_module(monkeypatch):
    stderr = (
        "Input #0, mov, from 'in.mp4':\n"
        "    Stream #0:0: Video: h264, yuv420p, 3840x2160, 30 fps\n"
        "Output #0, null, to 'pipe:':\n"
        "    Stream #0:0: Video: wrapped_avframe, yuv444p(tv, "
        "progressive), 1920x960 [SAR 1:1], q=2-31, 29.97 fps, 29.97 tbn\n"
    )
    monkeypatch.setattr(wrap.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 0, "", stderr))
    got = wrap.probe_decoded([], "in.mp4", ["scale=1920:960"])
    assert got == jwrap.probe_decoded([], "in.mp4", ["scale=1920:960"])
    assert got == (1920, 960, pytest.approx(29.97), "yuv444p")
    cs = wrap.split_complex_graph([("-filter_complex", "[0:v]scale=128:64[s];"
                                    "[s]transform360=w=64")])
    assert wrap.probe_decoded_complex([([], "in.mp4")], cs)[:2] == (1920, 960)


def test_extract_t360_opts(monkeypatch):
    monkeypatch.setenv("T360_BATCH", "4")
    b, p, s, dev, rest = wrap._extract_t360_opts(
        ["--t360-prefetch", "2", "-i", "x", "--t360-device", "cpu", "--t360-stats", "y.mp4"]
    )
    assert (b, p, s, dev) == (4, 2, True, "cpu")
    assert rest == ["-i", "x", "y.mp4"]
    assert wrap._extract_t360_opts(["-i", "x", "y.mp4"])[3] == "cuda"
    with pytest.raises(wrap.UsageError, match="cuda or cpu"):
        wrap._extract_t360_opts(["--t360-device", "tpu", "-i", "x", "y.mp4"])


# ------------------------------------------------------------ end to end

class _FakeProc:
    def __init__(self, stdout=None, stdin=None):
        self.stdout, self.stdin = stdout, stdin

    def wait(self):
        return 0


class _Sink(io.BytesIO):
    def close(self):  # keep the payload readable after the wrapper closes
        pass


def fake_pipes(monkeypatch, raw, w, h, pix_fmt):
    """Decode and encode processes on in-memory pipes; returns the encode
    sink and the list of spawned argvs."""
    sink, spawned = _Sink(), []

    def fake_popen(cmd, stdout=None, stdin=None):
        spawned.append(cmd)
        if stdout is not None:  # the decode side
            return _FakeProc(stdout=io.BytesIO(raw))
        return _FakeProc(stdin=sink if stdin is not None else None)

    monkeypatch.setattr(wrap.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(video, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(video, "_probe_ffmpeg", lambda path: (w, h, 30.0, pix_fmt))
    return sink, spawned


def frames(pix_fmt, w, h, n, seed=42):
    """n random frames of ``pix_fmt`` and their raw stream bytes."""
    pf = P.config.get_pixel_format(pix_fmt)
    dt = np.uint8 if pf.depth == 8 else np.dtype("<u2")
    rng = np.random.default_rng(seed)
    cw, ch = P.chroma_dims(w, h, pf)
    planes = [rng.integers(0, pf.maxval + 1, (n, h, w)).astype(dt)]
    planes += [rng.integers(0, pf.maxval + 1, (n, ch, cw)).astype(dt) for _ in range(2)]
    raw = b"".join(p[k].tobytes() for k in range(n) for p in planes)
    return planes, raw


def api_bytes(planes, w, h, pix_fmt, device):
    out = P.open_filter(VF, w, h, pix_fmt=pix_fmt, device=device).transform(*planes)
    out = [o.cpu().numpy() for o in out]
    out = [o.astype("<u2") if o.dtype == np.uint16 else o for o in out]
    return b"".join(p[k].tobytes() for k in range(out[0].shape[0]) for p in out)


@pytest.mark.parametrize("pix_fmt", ["yuv420p", "yuv444p", "yuv420p10le"])
def test_wrapper_end_to_end_fake_pipes(pix_fmt, monkeypatch, capsys):
    """The full wrapper on in-memory pipes: the encoded stream equals the
    port's API on the same frames, in the probed format (deep formats as
    16-bit little-endian samples)."""
    w, h, n = 128, 64, 5
    planes, raw = frames(pix_fmt, w, h, n)
    sink, spawned = fake_pipes(monkeypatch, raw, w, h, pix_fmt)
    rc = wrap.main(["--t360-batch", "2", "--t360-stats", "--t360-device", "cpu", "-y", "-i",
                    "in.mp4", "-vf", f"transform360={VF}", "out.mp4"])
    assert rc == 0
    assert len(spawned) == 2
    for cmd in spawned:  # both raw pipes carry the probed format
        assert cmd[cmd.index("-pix_fmt") + 1] == pix_fmt
    assert sink.getvalue() == api_bytes(planes, w, h, pix_fmt, "cpu")
    assert '"frames": 5' in capsys.readouterr().err


def test_wrapper_end_to_end_multi_output_and_multichain(monkeypatch):
    """A second output runs as its own passthrough process; a multi-chain
    graph pipes the transform stream and renumbers the encode side."""
    w, h, n = 128, 64, 3
    planes, raw = frames("yuv420p", w, h, n)
    want = api_bytes(planes, w, h, "yuv420p", "cpu")
    sink, spawned = fake_pipes(monkeypatch, raw, w, h, "yuv420p")
    assert wrap.main(["--t360-device", "cpu", "-y", "-i", "in.mp4", "-vf",
                      f"transform360={VF}", "t.mp4", "-c:v", "libx265", "-an",
                      "copy.mp4"]) == 0
    assert spawned[0] == ["ffmpeg", "-v", "error", "-nostdin", "-y", "-i", "in.mp4",
                          "-c:v", "libx265", "-an", "copy.mp4"]
    assert sink.getvalue() == want
    sink, spawned = fake_pipes(monkeypatch, raw, w, h, "yuv420p")
    assert wrap.main(["--t360-device", "cpu", "-y", "-i", "in.mp4", "-i", "logo.png",
                      "-filter_complex", f"[0:v]transform360={VF}[t];[t][1:v]overlay=0:0[v]",
                      "-map", "[v]", "-c:v", "libx264", "out.mp4"]) == 0
    enc = spawned[1]
    assert enc[enc.index("-filter_complex") + 1] == "[0:v]null[t];[t][2:v]overlay=0:0[v]"
    assert sink.getvalue() == want


def test_passthrough_without_transform360(monkeypatch):
    calls = []
    monkeypatch.setattr(wrap.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    argv = ["-i", "a.mp4", "-vf", "scale=64:32", "out.mp4"]
    assert wrap.main(argv) == 0
    assert calls == [["ffmpeg", *argv]]


@pytest.mark.parametrize("src", ["-", "pipe:0", "pipe:", "/dev/stdin"])
def test_stream_input_with_two_outputs_is_refused(src, monkeypatch, capsys):
    # the reference wrapper would read the stream in the decode and in
    # the passthrough process (transform360_tpu/ffmpeg.py:990-996)
    monkeypatch.setattr(wrap.subprocess, "Popen", lambda *a, **k: pytest.fail("spawned"))
    rc = wrap.main(["-y", "-i", src, "-vf", f"transform360={VF}", "t.mp4", "-an", "copy.mp4"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "read only once" in err and "write the stream to a file first" in err


@pytest.mark.parametrize("src", ["-", "pipe:0", "/dev/stdin"])
@pytest.mark.parametrize("pre", ["", "scale=1920:960,"], ids=["no-pre-filter", "pre-filter"])
def test_probed_stream_input_is_refused(src, pre, monkeypatch, capsys):
    # a single-output command probes its input before the decode reads it
    # (ffprobe, or ffmpeg through the pre-transform filters), so the decode
    # would miss the head of the stream (transform360_tpu/ffmpeg.py:989-996)
    monkeypatch.setattr(wrap.subprocess, "Popen", lambda *a, **k: pytest.fail("spawned"))
    monkeypatch.setattr(wrap.subprocess, "run", lambda *a, **k: pytest.fail("probed"))
    monkeypatch.setattr(video, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(video, "_probe_ffmpeg", lambda path: pytest.fail("probed"))
    rc = wrap.main(["-y", "-i", src, "-vf", f"{pre}transform360={VF}", "t.mp4"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "read only once" in err and "write the stream to a file first" in err
    # a graph whose decode side probes the stream is refused too
    rc = wrap.main(["-y", "-i", src, "-i", "logo.png", "-filter_complex",
                    f"[0:v]{pre}transform360={VF}[t];[t][1:v]overlay=0:0[v]", "-map", "[v]",
                    "out.mp4"])
    assert rc == 2 and "read only once" in capsys.readouterr().err


def test_nondeterministic_filter_before_a_teed_split_is_refused(capsys):
    # the reference wrapper would run the noise filter twice, once per
    # branch (transform360_tpu/ffmpeg.py:430-436), and the branches differ
    graph = "[0:v]noise=alls=20,split[a][b];[a]transform360=w=64[t];[t][b]overlay[v]"
    assert wrap.main(_fc(graph, "-map", "[v]")) == 2
    err = capsys.readouterr().err
    assert "noise=alls=20" in err and "would run twice" in err
    assert jwrap.split_complex_graph([("-filter_complex", graph)]) is not None
    # a deterministic filter there is still tee'd, as the JAX module does
    kept = "[0:v]scale=64:32,split[a][b];[a]transform360=w=64[t];[t][b]overlay[v]"
    cs = wrap.split_complex_graph([("-filter_complex", kept), ("-map", "[v]")])
    assert dataclasses.asdict(cs) == dataclasses.asdict(
        jwrap.split_complex_graph([("-filter_complex", kept), ("-map", "[v]")]))
    assert "[1:v]scale=64:32[b]" in cs.enc_fc
