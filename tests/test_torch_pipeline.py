"""The slice end to end: ``transform360_tpu_torch.open_filter(...,
device="cpu").transform(y, u, v)`` against ``transform360_tpu.open_filter
(...).transform`` on yuv420p batches.

* On the JAX plan (``plan_from_jax``): the port's plain path equals the
  JAX pipeline except where XLA-CPU's jitted program contracts a
  multiply-add into an FMA (ROADMAP C) and so rounds a sum that lies
  within an ulp of a .5 tie the other way: at most 1 LSB on at most 0.2%
  of a plane's pixels.  Measured: Y 0.0007%, V 0.05%, U up to 0.146% at
  these sizes; the smooth synthetic U plane (a sine of the column only)
  is locally linear, and cubic weights reproduce a ramp, so exact-.5
  results are common there.  0 pixels differ when the JAX functions run
  op by op (tests/test_torch_blur.py, tests/test_torch_remap.py).
* On the port's own plan (float32 torch geometry): at least 99.5% of
  pixels identical and at least 50 dB PSNR against the JAX output
  (measured: over 99.8% and over 77 dB at the gate size).
"""

import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu.fidelity import _video_like_planes
import transform360_tpu_torch as P
from transform360_tpu_torch import pipeline
from transform360_tpu_torch import plan as plan_mod
from transform360_tpu_torch.ops import window
from transform360_tpu_torch.plan import plan_from_jax

from conftest import psnr

FLAGSHIP = "interpolation_alg=cubic:enable_low_pass_filter=1:input_stereo_format=mono"
FMA_TIE_FRAC = 0.002
SIZES = {
    "small": (512, 256, "cube_edge_length=64"),
    # the fidelity gate's size (fidelity.py:69-70): 1920x960 -> 480x320
    "gate": (1920, 960, "cube_edge_length=160"),
}


def _frames(w, h, b=3):
    y, u, v = _video_like_planes(w, h)
    return tuple(np.stack([np.roll(p, 7 * k, axis=1) for k in range(b)]) for p in (y, u, v))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_flagship_against_jax(size):
    w, h, edge = SIZES[size]
    opts = f"{edge}:{FLAGSHIP}"
    y, u, v = _frames(w, h)
    jf = J.open_filter(opts, w, h)
    want = jf.transform(y, u, v)

    same_plan = P.Transform360(P.parse_options(opts).config, device="cpu")
    same_plan.use_plan(plan_from_jax(jf.plan))
    got = same_plan.transform(y, u, v)
    for a, b, name in zip(got, want, "YUV"):
        assert tuple(a.shape) == b.shape and a.dtype == torch.uint8
        d = np.abs(a.numpy().astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= FMA_TIE_FRAC, (name, d.max(), (d > 0).mean())

    own = P.open_filter(opts, w, h, device="cpu").transform(y, u, v)
    for a, b, name in zip(own, want, "YUV"):
        a = a.numpy()
        assert a.shape == b.shape
        assert (a == b).mean() >= 0.995, (name, (a == b).mean())
        assert psnr(a, b) >= 50.0, (name, psnr(a, b))


@pytest.mark.parametrize(
    "opts, pix_fmt",
    [
        ("cube_edge_length=64:input_stereo_format=tb:output_stereo_format=tb", "yuv420p"),
        ("w=192:h=64:output_layout=barrel:interpolation_alg=lanczos4:"
         "input_stereo_format=mono", "yuv422p"),
        ("w=128:h=96:output_layout=flat_fixed:interpolation_alg=linear:"
         "enable_low_pass_filter=0:input_stereo_format=lr:output_stereo_format=lr", "gray"),
    ],
)
def test_other_layouts_and_formats_against_jax(opts, pix_fmt, rng):
    w, h = (256, 256) if "tb" in opts else (512, 128) if "lr" in opts else (256, 128)
    jf = J.open_filter(opts, w, h, pix_fmt=pix_fmt)
    planes = [rng.integers(0, 256, (2, h, w), dtype=np.uint8)]
    if pix_fmt != "gray":
        cw, ch = J.chroma_dims(w, h, pix_fmt)
        planes += [rng.integers(0, 256, (2, ch, cw), dtype=np.uint8) for _ in range(2)]
    want = jf.transform(*planes)
    eng = P.Transform360(P.parse_options(opts).config, pix_fmt=pix_fmt, device="cpu")
    eng.use_plan(plan_from_jax(jf.plan))
    got = eng.transform(*planes)
    if pix_fmt == "gray":
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        d = np.abs(a.numpy().astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= FMA_TIE_FRAC


def test_single_frame_and_single_plane_entries(rng):
    opts = f"cube_edge_length=64:{FLAGSHIP}"
    eng = P.open_filter(opts, 512, 256, device="cpu")
    y, u, v = _frames(512, 256)
    by, bu, bv = eng.transform(y, u, v)
    fy, fu, fv = eng.transform(y[1], u[1], v[1])  # [H, W] frame in, [h, w] out
    assert torch.equal(fy, by[1]) and torch.equal(fu, bu[1]) and torch.equal(fv, bv[1])
    assert torch.equal(eng.transform_frame_plane(u, 1, 512, 256), bu)
    assert torch.equal(eng.transform_frame_plane(torch.from_numpy(y), 0, 512, 256), by)
    with pytest.raises(ValueError):
        eng.transform(y, u)  # a chroma plane missing
    with pytest.raises(TypeError):
        eng.transform(y.astype(np.float32), u, v)


def test_numpy_planes_through_the_pipeline_entries():
    # numpy planes are copied to device= (here the CPU), as the JAX
    # package takes them through jnp.asarray; tensors stay on their device
    eng = P.open_filter(f"cube_edge_length=64:{FLAGSHIP}", 512, 256, device="cpu")
    plan = eng.plan
    y, u, v = _frames(512, 256)
    want = P.transform_batch(plan, *(torch.from_numpy(p) for p in (y, u, v)))
    got = P.transform_batch(plan, y, u, v, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = P.transform_frame(plan, y[1], u[1], v[1], device="cpu")
    assert all(torch.equal(a, b[1]) for a, b in zip(one, want))
    assert torch.equal(pipeline.transform_plane(plan, u, 1, device="cpu"), want[1])
    assert torch.equal(pipeline.transform_plane(plan, y[0], 0, device="cpu"), want[0][0])
    bcast = np.broadcast_to(y[0], (2,) + y[0].shape)  # read-only, strided
    assert torch.equal(pipeline.transform_plane(plan, bcast, 0, device="cpu")[1], want[0][0])
    with pytest.raises(TypeError):
        P.transform_batch(plan, y.astype(np.float32), u, v, device="cpu")


def test_device_put_plan_builds_the_tables_once(monkeypatch):
    plan_mod.clear_plan_cache()  # a fresh plan: no tile plan built yet
    plan = P.build_plan(P.TransformConfig(input_stereo_format=P.StereoFormat.MONO,
                                          output_stereo_format=P.StereoFormat.MONO),
                        256, 128, 96, 64)
    built = []
    real = window.build_window_plan
    monkeypatch.setattr(plan_mod, "build_window_plan",
                        lambda *a: built.append(a) or real(*a))
    assert P.device_put_plan(plan, "cpu") is plan
    tables = [(pp.tables("cpu"), pp.window_tables("cpu")) for pp in (plan.luma, plan.chroma)]
    assert len(built) == 2  # luma and chroma, each once
    assert P.device_put_plan(plan, torch.device("cpu")) is plan
    again = [(pp.tables("cpu"), pp.window_tables("cpu")) for pp in (plan.luma, plan.chroma)]
    assert len(built) == 2
    assert all(a is b for x, y in zip(tables, again) for a, b in zip(x, y))


def test_the_port_exports_every_name_of_the_jax_package():
    assert set(J.__all__) <= set(P.__all__)
    for name in P.__all__:
        assert hasattr(P, name), name
