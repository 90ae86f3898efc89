"""The port's native C++ engine (``transform360_tpu_torch.native``) against
the JAX package's (``transform360_tpu.native``).

* Both engines compile the same ``t360.cpp`` with the same flags on this
  host, so their outputs must be equal byte for byte: the seven configs
  of tests/test_native.py, TB stereo, yuv444p and gray, the warp maps,
  ``enable_multi_threading``, the frame pool, the tiny LANCZOS4 barrel
  plane, ``open_filter(backend="native")`` and ``cli --backend native``.
* The native engine shares no code with the port's PyTorch path, so
  against it (and against the JAX pipeline) it holds the bound of
  tests/test_native.py: at least 50 dB per plane.
* The port builds its own copy of the source into
  ``transform360_tpu_torch/build/`` under a name that hashes the host
  CPU's identity, writes nothing into the JAX package, and raises when
  there is no compiler (nothing falls back).

Frames are small (256x128 -> 96x64) and the frame pool is given its
thread count where it is compared with per-frame output.
"""

import os

import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu import native as jax_native
from transform360_tpu.config import Interpolation, Layout, StereoFormat
import transform360_tpu_torch as P
from transform360_tpu_torch import native
from transform360_tpu_torch.cli import main as cli_main
from transform360_tpu_torch.geometry import build_warp_map
from transform360_tpu_torch.ops import _build
from transform360_tpu_torch.plan import config_from_jax
from transform360_tpu_torch.utils.yuv import read_yuv420_batch, write_yuv420_batch

from conftest import psnr
from test_native import make_yuv

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
NO_BLUR_LINEAR = dict(interpolation_alg=Interpolation.LINEAR, enable_low_pass_filter=0)
VF = "cube_edge_length=32:input_stereo_format=mono"
PMONO = P.TransformConfig(input_stereo_format=P.StereoFormat.MONO,
                          output_stereo_format=P.StereoFormat.MONO)  # cubic + prefilter

# name: (config keywords, in_w, in_h, out_w, out_h, pixel format)
CASES = {
    "linear": (dict(MONO, **NO_BLUR_LINEAR), 256, 128, 96, 64, "yuv420p"),
    "cubic": (dict(MONO, interpolation_alg=Interpolation.CUBIC, enable_low_pass_filter=0),
              256, 128, 96, 64, "yuv420p"),
    "nearest": (dict(MONO, interpolation_alg=Interpolation.NEAREST, enable_low_pass_filter=0),
                256, 128, 96, 64, "yuv420p"),
    "lanczos4": (dict(MONO, interpolation_alg=Interpolation.LANCZOS4, enable_low_pass_filter=0),
                 256, 128, 96, 64, "yuv420p"),
    "defaults (cubic + prefilter)": (dict(MONO), 256, 128, 96, 64, "yuv420p"),
    "equirect yaw 30": (dict(MONO, output_layout=Layout.EQUIRECT, fixed_yaw=30.0,
                             **NO_BLUR_LINEAR), 256, 128, 96, 64, "yuv420p"),
    "scale 2x2": (dict(MONO, width_scale_factor=2.0, height_scale_factor=2.0, **NO_BLUR_LINEAR),
                  256, 128, 96, 64, "yuv420p"),
    "tb stereo": (dict(input_stereo_format=StereoFormat.TB, output_stereo_format=StereoFormat.TB,
                       **NO_BLUR_LINEAR), 256, 256, 96, 128, "yuv420p"),
    "yuv444p": (dict(MONO, **NO_BLUR_LINEAR), 256, 128, 96, 64, "yuv444p"),
    "gray": (dict(MONO, **NO_BLUR_LINEAR), 256, 128, 96, 64, "gray"),
}


def _planes(rng, w, h, pix_fmt):
    y, u, v = make_yuv(rng, h, w)
    if pix_fmt == "yuv444p":
        return y, make_yuv(rng, h, w)[0], make_yuv(rng, h, w)[0]
    return (y,) if pix_fmt == "gray" else (y, u, v)


def _np(planes):
    planes = planes if isinstance(planes, tuple) else (planes,)
    return [np.asarray(p) for p in planes]


@pytest.mark.parametrize("case", list(CASES))
def test_native_equals_jax_native_and_holds_50db(rng, case):
    kw, w, h, ow, oh, pix_fmt = CASES[case]
    jcfg = J.TransformConfig(**kw)
    pcfg = config_from_jax(jcfg)
    planes = _planes(rng, w, h, pix_fmt)
    got = native.NativeTransform(pcfg).transform_planar(planes, ow, oh, pix_fmt)
    want = jax_native.NativeTransform(jcfg).transform_planar(planes, ow, oh, pix_fmt)
    assert len(got) == len(want) == len(planes)
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    plain = _np(P.transform_batch(P.build_plan(pcfg, w, h, ow, oh, pix_fmt), *planes,
                                  device="cpu"))
    jax_out = _np(J.transform_batch(J.build_plan(jcfg, w, h, ow, oh, pix_fmt), *planes))
    for name, a, b, c in zip("YUV", got, plain, jax_out):
        assert psnr(a, b) >= 50.0, f"{name}: native vs the port's plain path ({case})"
        assert psnr(a, c) >= 50.0, f"{name}: native vs the JAX pipeline ({case})"


@pytest.mark.parametrize("plane", [0, 1])
def test_export_warp_map(plane):
    jcfg = J.TransformConfig(**MONO)
    pcfg = config_from_jax(jcfg)
    dims = (256, 128, 96, 64) if plane == 0 else (128, 64, 48, 32)
    engines = [native.NativeTransform(pcfg), jax_native.NativeTransform(jcfg)]
    for e in engines:
        e.generate_map_for_plane(*dims, plane)
    got, want = (e.export_warp_map(plane) for e in engines)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (dims[3], dims[2], 2)
    # 1/32-px quantized against the port's float32 geometry
    assert np.abs(got - build_warp_map(pcfg, *dims).numpy()).max() < 1.0 / 32 + 1e-3


def test_multithreading_does_not_change_bytes(rng):
    y, u, v = make_yuv(rng, 128, 256)
    outs = []
    for mt in (0, 1):
        jcfg = J.TransformConfig(**MONO, enable_multi_threading=mt, num_vertical_segments=7,
                                 num_horizontal_segments=3)
        outs.append(native.NativeTransform(config_from_jax(jcfg)).transform_frame(
            y, u, v, 96, 64))
        want = jax_native.NativeTransform(jcfg).transform_frame(y, u, v, 96, 64)
        for a, b in zip(outs[-1], want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_frame_pool_equals_per_frame(rng, n_threads):
    frames = [make_yuv(rng, 128, 256) for _ in range(5)]
    ys, us, vs = (np.stack([f[i] for f in frames]) for i in range(3))
    t = native.NativeTransform(PMONO)
    t.transform_frame(ys[0], us[0], vs[0], 96, 64)  # generates both maps
    oy = t.transform_frames_plane(ys, 96, 64, 0, 0, n_threads=n_threads)
    ou = t.transform_frames_plane(us, 48, 32, 1, 1, n_threads=n_threads)
    assert oy.shape == (5, 64, 96) and ou.shape == (5, 32, 48)
    t1 = native.NativeTransform(PMONO)
    for i in range(5):
        sy, su, _ = t1.transform_frame(ys[i], us[i], vs[i], 96, 64)
        np.testing.assert_array_equal(oy[i], sy)
        np.testing.assert_array_equal(ou[i], su)


def test_rejects_unresolved_guess():
    with pytest.raises(ValueError, match="GUESS"):
        native.NativeTransform(P.TransformConfig())


def test_tiny_lanczos4_barrel_plane(rng):
    # 8-tap footprints on a chroma plane shorter than 5 px (reflect
    # indices past the edge) run cleanly, deterministically, as the JAX
    # package's engine
    jcfg = J.TransformConfig(**MONO, output_layout=Layout.BARREL,
                             interpolation_alg=Interpolation.LANCZOS4, enable_low_pass_filter=0)
    y, u, v = make_yuv(rng, 8, 16)
    t = native.NativeTransform(config_from_jax(jcfg))
    a = t.transform_frame(y, u, v, 32, 16)
    b = t.transform_frame(y, u, v, 32, 16)
    want = jax_native.NativeTransform(jcfg).transform_frame(y, u, v, 32, 16)
    for p, q, r in zip(a, b, want):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(p, r)
    assert a[1].shape == (8, 16)


@pytest.mark.parametrize("form", ["numpy", "cpu tensors"])
def test_open_filter_native_batch_and_frame(rng, form):
    y, u, v = make_yuv(rng, 128, 256)
    yb, ub, vb = (np.stack([p, np.roll(p, 5, axis=1)]) for p in (y, u, v))
    if form == "cpu tensors":
        yb, ub, vb = (torch.from_numpy(p) for p in (yb, ub, vb))
    eng = P.open_filter(VF, 256, 128, backend="native")
    assert eng.device == torch.device("cpu") and eng.plan is None  # maps made on first use
    batch = eng.transform(yb, ub, vb)
    one = eng.transform(yb[1], ub[1], vb[1])
    want = J.open_filter(VF, 256, 128, backend="native").transform(
        *(np.asarray(p) for p in (yb, ub, vb)))
    for b, o, w in zip(batch, one, want):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.uint8 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), w)
        np.testing.assert_array_equal(o.numpy(), w[1])
    gray = P.open_filter(VF, 256, 128, backend="native", pix_fmt="gray").transform(yb)
    assert isinstance(gray, torch.Tensor) and torch.equal(gray, batch[0])  # a bare tensor
    with pytest.raises(ValueError, match="expected 1 plane"):
        P.open_filter(VF, 256, 128, backend="native", pix_fmt="gray").transform(yb, ub, vb)


def test_open_filter_native_refuses_deep_formats_and_a_mesh():
    y = np.zeros((128, 256), np.uint16)
    c = np.zeros((64, 128), np.uint16)
    with pytest.raises(ValueError, match="8-bit only"):
        P.open_filter(VF, 256, 128, backend="native", pix_fmt="yuv420p10le").transform(y, c, c)
    with pytest.raises(ValueError, match="mesh"):
        P.open_filter(VF, 256, 128, backend="native", mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="uint8"):  # no silent cast at the C boundary
        native.NativeTransform(PMONO).transform_frame(y, c, c, 96, 64)


def _stream(tmp_path, rng, n):
    frames = [make_yuv(rng, 128, 256) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(3)]
    path = tmp_path / "in.yuv"
    write_yuv420_batch(str(path), *planes)
    return path, planes


def test_cli_native_equals_the_api(tmp_path, rng):
    src, planes = _stream(tmp_path, rng, 3)
    vf = VF + ":interpolation_alg=cubic"
    out = tmp_path / "out.yuv"
    assert cli_main(["--vf", vf, "--input-size", "256x128", "-i", str(src), "-o", str(out),
                     "--batch", "2", "--backend", "native"]) == 0
    got = read_yuv420_batch(str(out), 96, 64)
    api = P.open_filter(vf, 256, 128, backend="native").transform(*planes)
    for a, b in zip(got, api):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize(
    "flags, message",
    [
        (["--latency-bands", "2"], "--latency-bands requires the auto backend"),
        (["--devices", "2"], "--devices requires the auto backend"),
        (["--save-plan", "p.npz"], "plan files apply to the auto backend only"),
        (["--load-plan", "p.npz"], "plan files apply to the auto backend only"),
        (["--distributed", "env"], "--distributed requires the auto backend"),
    ],
)
def test_cli_native_refuses_auto_only_flags(tmp_path, rng, capsys, flags, message):
    src, _ = _stream(tmp_path, rng, 1)
    out = tmp_path / "out.yuv"
    args = ["--vf", VF, "--input-size", "256x128", "-i", str(src), "-o", str(out),
            "--backend", "native"]
    assert cli_main(args + flags) == 2
    assert message in capsys.readouterr().err
    assert not out.exists()


def _jax_native_files():
    d = os.path.dirname(jax_native.__file__)
    paths = (os.path.join(d, n) for n in os.listdir(d))
    return {p: os.stat(p).st_mtime_ns for p in paths if os.path.isfile(p)}


def test_build_lands_in_the_port_build_dir(tmp_path, monkeypatch):
    jax_native.available()  # the JAX engine's own build, if it has not run yet
    before = _jax_native_files()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    assert native.available() and native.build_error() is None
    libs = list((tmp_path / "build").iterdir())
    assert len(libs) == 1 and libs[0].suffix == ".so"
    assert libs[0].name.startswith("libt360-")
    assert libs[0].stem.endswith(_build.host_fingerprint())
    assert _build.BUILD_SECONDS["t360"] > 0
    assert _jax_native_files() == before  # nothing written into the JAX package
    assert _build.CXX_FLAGS == ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
                                "-shared", "-pthread")  # the JAX package's Makefile's


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    assert not native.available()
    assert "C++ compiler not found" in native.build_error()
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler not found"):
        native.NativeTransform(PMONO)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler not found"):
        P.open_filter(VF, 256, 128, backend="native").transform(
            np.zeros((128, 256), np.uint8), np.zeros((64, 128), np.uint8),
            np.zeros((64, 128), np.uint8))
    assert not (tmp_path / "build").exists()
