"""The port stands alone: it imports neither jax nor the JAX package, ships
its CUDA sources, and refuses (never falls back from) a CUDA request it
cannot serve."""

import os
import pkgutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

import transform360_tpu_torch as t3
from transform360_tpu_torch import fidelity, pipeline
from transform360_tpu_torch.ops import _build, blur, sources, window
from transform360_tpu_torch.utils.profiling import COUNTERS

ROOT = Path(__file__).resolve().parent.parent
# every module of the package, found by walking it (a new module cannot
# escape the check)
MODULES = ["transform360_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(t3.__path__, "transform360_tpu_torch.")
)


def test_every_module_is_walked():
    for m in ("transform360_tpu_torch.ops.window", "transform360_tpu_torch.cli",
              "transform360_tpu_torch.utils.yuv", "transform360_tpu_torch.utils.video",
              "transform360_tpu_torch.utils.profiling", "transform360_tpu_torch.ops.blur",
              "transform360_tpu_torch.fidelity", "transform360_tpu_torch.ffmpeg",
              "transform360_tpu_torch.parallel", "transform360_tpu_torch.parallel.mesh",
              "transform360_tpu_torch.parallel.latency",
              "transform360_tpu_torch.parallel.distributed",
              "transform360_tpu_torch.native"):
        assert m in MODULES
    assert "transform360_tpu_torch.ops.remap" not in MODULES  # K2 is retired


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transform360_tpu' or m.startswith('transform360_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cuda_sources_exist_and_are_packaged():
    for name in ("blur.cu", "window.cu", "common.cuh"):
        assert (_build.CSRC / name).is_file()
    assert not (_build.CSRC / "remap.cu").exists()
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert data["transform360_tpu_torch"] == ["csrc/*.cu", "csrc/*.cuh", "data/*.npz",
                                              "native/*.cpp"]
    # the native engine's source: the port's own copy, byte for byte
    assert _build.NATIVE_SRC.read_bytes() == (
        ROOT / "transform360_tpu" / "native" / "t360.cpp").read_bytes()
    assert (ROOT / "transform360_tpu_torch" / "data" / "fidelity_oracle.npz").is_file()
    # sm_90a target (wgmma/TMA-capable Hopper) and no silent FMA contraction
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "-fmad=false" in _build.NVCC_FLAGS


def test_cuda_engine_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        t3.open_filter("cube_edge_length=32:input_stereo_format=mono", 256, 128)
    # the pipeline's entries, the gate and the wrapper refuse it too
    plan = t3.open_filter("cube_edge_length=32:input_stereo_format=mono", 256, 128,
                          device="cpu").plan
    y = np.zeros((128, 256), np.uint8)
    for call in (lambda: t3.transform_batch(plan, y[None]),
                 lambda: t3.transform_frame(plan, y, y[:64, :128], y[:64, :128]),
                 lambda: pipeline.transform_plane(plan, y, 0),
                 lambda: t3.device_put_plan(plan),
                 lambda: fidelity.bench_fidelity(in_wh=(256, 128), out_wh=(96, 64), batch=1,
                                                 parity_sweep=False, want={})):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_wrappers_refuse_other_devices_and_bad_inputs(monkeypatch):
    eng = t3.open_filter(
        "cube_edge_length=32:input_stereo_format=mono", 256, 128, device="cpu"
    )
    t = eng.plan.luma.tables("cpu")
    wt = eng.plan.luma.window_tables("cpu")
    meta = torch.empty((1, 128, 256), dtype=torch.uint8, device="meta")
    for fn, tab in ((blur.blur_px, t.blur), (window.remap_window_px, wt)):
        with pytest.raises(ValueError):
            fn(tab, meta)  # neither cpu nor cuda: no silent fallback
        with pytest.raises(TypeError):
            fn(tab, torch.zeros((1, 128, 256), dtype=torch.float32))
        with pytest.raises(TypeError):  # tables cut for uint8 planes
            fn(tab, torch.zeros((1, 128, 256), dtype=torch.uint16))
        with pytest.raises(ValueError):  # uint8 samples saturate at 255
            fn(tab, torch.zeros((1, 128, 256), dtype=torch.uint8), 1023)
        with pytest.raises(ValueError):
            fn(tab, torch.zeros((1, 64, 256), dtype=torch.uint8))
        with pytest.raises(ValueError):
            fn(tab, torch.zeros((1, 256, 128), dtype=torch.uint8).transpose(1, 2))
    # CPU tensors run the plain versions and never count as kernel launches
    before = (COUNTERS["blur.launches"], COUNTERS["window.launches"])
    calls = []
    real = pipeline.remap_window_px
    monkeypatch.setattr(pipeline, "remap_window_px",  # x: a plane batch, or its sources
                        lambda wt, x, *a: calls.append(sources.frames(sources.as_sources(x)))
                        or real(wt, x, *a))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (9, 128, 256), np.uint8))
    assert eng.transform_frame_plane(x[:2], 0, 256, 128).shape == (2, 64, 96)
    assert eng.transform_frame_plane(x, 0, 256, 128).shape == (9, 64, 96)
    assert calls == [2, 9]  # K3's route at every batch size
    assert (COUNTERS["blur.launches"], COUNTERS["window.launches"]) == before


@pytest.mark.parametrize(
    "kwargs, refusal",
    [
        (dict(backend="native"), None),
        (dict(backend="native", mesh=["cpu"] * 2), "mesh"),  # mesh= needs the auto backend
    ],
)
def test_unported_options_raise_naming_the_roadmap_item(kwargs, refusal):
    # ROADMAP A14, served now: backend="native" builds an engine on the
    # host's CPU (whatever device= says); with a mesh it is refused
    cfg = t3.TransformConfig(
        input_stereo_format=t3.StereoFormat.MONO,
        output_stereo_format=t3.StereoFormat.MONO,
    )
    if refusal:
        with pytest.raises(ValueError, match=refusal):
            t3.Transform360(cfg, 96, 64, device="cpu", **kwargs)
        return
    eng = t3.Transform360(cfg, 96, 64, device="cuda", **kwargs)
    assert eng.device == torch.device("cpu")
    y = np.zeros((128, 256), np.uint8)
    out = eng.transform(y, y[:64, :128], y[:64, :128])
    assert [tuple(o.shape) for o in out] == [(64, 96), (32, 48), (32, 48)]
    assert all(o.dtype == torch.uint8 and o.device.type == "cpu" for o in out)


@pytest.mark.parametrize(
    "opts, pix_fmt",
    [
        ("", "yuv420p10le"),
        ("", "gray16le"),
        (":width_scale_factor=2:height_scale_factor=1.5", "yuv420p"),
        (":width_scale_factor=0.75", "gbrp12le"),
    ],
)
def test_deep_formats_and_scale_factors_are_served(opts, pix_fmt, tmp_path):
    # the options that raised before the port served them: the engine
    # builds, transforms and saves and loads its plan
    eng = t3.open_filter("cube_edge_length=32:input_stereo_format=mono" + opts, 256, 128,
                         pix_fmt=pix_fmt, device="cpu")
    pf = t3.config.get_pixel_format(pix_fmt)
    dt = np.uint8 if pf.depth == 8 else np.uint16
    cw, ch = t3.chroma_dims(256, 128, pf)
    planes = [np.full((128, 256), pf.maxval // 3, dt)] + [np.full((ch, cw), pf.neutral, dt)] * (
        pf.n_planes - 1)
    out = eng.transform(*planes)
    out = out if isinstance(out, tuple) else (out,)
    assert out[0].dtype == (torch.uint8 if pf.depth == 8 else torch.uint16)
    assert tuple(out[0].shape) == (eng.output_dims()[1], eng.output_dims()[0])
    eng.save_plan(str(tmp_path / "p.npz"))
    eng.load_plan(str(tmp_path / "p.npz"))


def test_plan_files_import_no_jax(tmp_path):
    # saving and loading a plan file pulls in neither jax nor the JAX package
    code = (
        "import sys\n"
        "import transform360_tpu_torch as t3\n"
        "e = t3.open_filter('cube_edge_length=32:input_stereo_format=mono:"
        "width_scale_factor=2', 256, 128, pix_fmt='yuv420p10le', device='cpu')\n"
        f"e.save_plan({str(tmp_path / 'p.npz')!r})\n"
        f"p = t3.load_plan({str(tmp_path / 'p.npz')!r})\n"
        "assert p.luma.depth == 10 and p.luma.area is not None\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transform360_tpu' or m.startswith('transform360_tpu.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
