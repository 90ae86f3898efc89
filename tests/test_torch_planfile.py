"""Plan files across the two packages.

* Files written by the JAX package (v3, with and without its TPU kernel
  plans; v2 and v1 layouts written from its own array and header
  helpers) load in the port and transform byte for byte as the same
  plan carried across by ``plan_from_jax``.
* A file the port writes loads in the JAX package's ``load_plan`` and
  gives the JAX package's own bytes for its plan; the port's own
  8-bit, deep and supersampled plans round-trip through the port.
* Files of another format, version or without a header are rejected,
  and no pickle is read.
* The v3 codec stores an int64 array outside the int32 range exactly
  (the JAX package's encoder would truncate it, ``plan.py:253``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import transform360_tpu as J
from transform360_tpu import plan as jplan
from transform360_tpu.config import Layout, StereoFormat, TransformConfig
from transform360_tpu.pipeline import transform_batch as jax_transform_batch
import transform360_tpu_torch as P
from transform360_tpu_torch import plan as tplan
from transform360_tpu_torch.plan import config_from_jax, load_plan, plan_from_jax, save_plan

from test_torch_deep import deep_planes

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
CASES = {
    "cubic-prefilter": (TransformConfig(**MONO), 256, 128, 96, 64, "yuv420p"),
    "barrel-lanczos4": (TransformConfig(output_layout=Layout.BARREL_SPLIT, interpolation_alg=4,
                                        **MONO), 256, 128, 192, 64, "yuv420p"),
    "deep-10": (TransformConfig(**MONO), 256, 128, 96, 64, "yuv420p10le"),
    "supersampled": (TransformConfig(width_scale_factor=1.5, height_scale_factor=2.0, **MONO),
                     128, 64, 48, 32, "yuv420p"),
    "gray": (TransformConfig(**MONO), 256, 128, 96, 64, "gray"),
}


def _planes(iw, ih, pix_fmt):
    if pix_fmt in ("yuv420p", "gray"):
        ps = [(p >> 2).astype(np.uint8) for p in deep_planes(iw, ih, "yuv420p10le")]
        return ps[:1] if pix_fmt == "gray" else ps
    return deep_planes(iw, ih, pix_fmt)


def _port_out(plan, planes):
    out = P.transform_batch(plan, *[torch.from_numpy(p) for p in planes])
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _jax_out(plan, planes):
    out = jax_transform_batch(plan, *planes)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _same_plans(a, b):
    assert (a.in_w, a.in_h, a.out_w, a.out_h, a.pix_fmt, a.n_planes) == (
        b.in_w, b.in_h, b.out_w, b.out_h, b.pix_fmt, b.n_planes)
    assert a.cfg == b.cfg
    for x, y in ((a.luma, b.luma), (a.chroma, b.chroma)):
        assert (x is None) == (y is None)
        if x is None:
            continue
        assert (x.key, x.fill, x.depth, x.scaled_w, x.scaled_h) == (
            y.key, y.fill, y.depth, y.scaled_w, y.scaled_h)
        for f in ("base_y", "base_x", "frac_y", "frac_x", "valid"):
            u, v = getattr(x.spec, f), getattr(y.spec, f)
            assert (u is None) == (v is None)
            if u is not None:
                assert u.dtype == v.dtype and np.array_equal(u, v), f
        assert (x.blur is None) == (y.blur is None)
        if x.blur is not None:
            for p, q in zip(x.blur.bands, y.blur.bands):
                for f in ("kx", "ky", "kx_col", "ky_col"):
                    assert np.array_equal(getattr(p, f), getattr(q, f)), f
        assert (x.area is None) == (y.area is None)
        if x.area is not None:
            assert np.array_equal(x.area.row.matrix(), y.area.row.matrix())
            assert np.array_equal(x.area.col.matrix(), y.area.col.matrix())


@pytest.mark.parametrize("kernel_plans", [True, False])
@pytest.mark.parametrize("name",
                         ["cubic-prefilter", "barrel-lanczos4", "deep-10", "supersampled"])
def test_jax_written_v3_files_load_in_the_port(name, kernel_plans, tmp_path):
    cfg, iw, ih, ow, oh, pix_fmt = CASES[name]
    jp = J.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    path = tmp_path / "jax.npz"
    jplan.save_plan(jp, str(path), include_kernel_plans=kernel_plans)
    with np.load(path) as f:
        header = json.loads(bytes(f["header"]))
        assert header["version"] == 3 and bool(header["kernel_plans"]) == kernel_plans
        if pix_fmt == "yuv420p":  # the TPU lane plans ride along, for 8-bit planes only
            assert any(".lane." in k for k in f.files) == kernel_plans
    loaded = load_plan(str(path))
    carried = plan_from_jax(jp)
    _same_plans(loaded, carried)
    planes = _planes(iw, ih, pix_fmt)
    for a, b in zip(_port_out(loaded, planes), _port_out(carried, planes)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("version", [1, 2])
def test_jax_v1_and_v2_layouts_load_in_the_port(version, tmp_path):
    # v1 and v2 stored every array raw (no "enc"); v2 added the TPU kernel
    # plans, which the port reads past
    cfg, iw, ih, ow, oh, pix_fmt = CASES["cubic-prefilter"]
    jp = J.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    arrays = {**jplan._plane_arrays("luma", jp.luma), **jplan._plane_arrays("chroma", jp.chroma)}
    kernel_meta = {}
    if version == 2:
        for prefix, pp in (("luma", jp.luma), ("chroma", jp.chroma)):
            km, ka = jplan._lane_plan_meta_and_arrays(prefix, pp)
            kernel_meta[prefix] = km
            arrays.update(ka)
        assert any(".lane." in k or ".blur_lane." in k for k in arrays)
    header = {
        "format": jplan.PLAN_FORMAT, "version": version,
        "cfg": {k: int(v) if hasattr(v, "value") else v
                for k, v in dataclasses.asdict(jp.cfg).items()},
        "in_w": iw, "in_h": ih, "out_w": ow, "out_h": oh, "pix_fmt": pix_fmt, "n_planes": 3,
        "luma": jplan._plane_meta(jp.luma), "chroma": jplan._plane_meta(jp.chroma),
    }
    if version == 2:
        header["kernel_plans"] = kernel_meta
    path = tmp_path / f"v{version}.npz"
    with open(path, "wb") as f:
        np.savez(f, header=np.frombuffer(json.dumps(header).encode(), np.uint8), **arrays)
    loaded = load_plan(str(path))
    _same_plans(loaded, plan_from_jax(jp))
    assert np.array_equal(jplan.load_plan(str(path)).luma.spec.base_x, jp.luma.spec.base_x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_written_files_load_in_jax(name, tmp_path):
    cfg, iw, ih, ow, oh, pix_fmt = CASES[name]
    jp = J.build_plan(cfg, iw, ih, ow, oh, pix_fmt)
    path = tmp_path / "port.npz"
    save_plan(plan_from_jax(jp), str(path))
    with np.load(path) as f:
        header = json.loads(bytes(f["header"]))
    assert header["format"] == "transform360_tpu-plan" and header["version"] == 3
    assert header["kernel_plans"] == {}
    back = jplan.load_plan(str(path))
    assert back.pix_fmt == jp.pix_fmt and back.luma.depth == jp.luma.depth
    assert back.luma.key == jp.luma.key and back.cfg == jp.cfg
    planes = _planes(iw, ih, pix_fmt)
    for a, b in zip(_jax_out(back, planes), _jax_out(jp, planes)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_own_plans_round_trip(name, tmp_path):
    cfg, iw, ih, ow, oh, pix_fmt = CASES[name]
    plan = P.build_plan(config_from_jax(cfg), iw, ih, ow, oh, pix_fmt)
    path = tmp_path / "own.npz"
    save_plan(plan, str(path))
    loaded = load_plan(str(path))
    _same_plans(loaded, plan)
    planes = _planes(iw, ih, pix_fmt)
    for a, b in zip(_port_out(loaded, planes), _port_out(plan, planes)):
        assert np.array_equal(a, b)
    if name == "deep-10":
        assert loaded.luma.depth == 10 and loaded.chroma.fill == 512
    # the engine adopts a file in place of generating the maps
    eng = P.Transform360(plan.cfg, pix_fmt=pix_fmt, device="cpu")
    eng.load_plan(str(path))
    assert eng.output_dims() == (ow, oh)
    for a, b in zip(_port_out(eng.plan, planes), _port_out(plan, planes)):
        assert np.array_equal(a, b)


def test_engine_save_then_load(tmp_path):
    opts = "cube_edge_length=32:input_stereo_format=mono"
    eng = P.open_filter(opts, 256, 128, pix_fmt="gray10le", device="cpu")
    path = tmp_path / "e.npz"
    eng.save_plan(str(path))
    other = P.open_filter(opts, 256, 128, pix_fmt="gray10le", eager=False, device="cpu")
    with pytest.raises(RuntimeError, match="no plan"):
        other.save_plan(str(tmp_path / "none.npz"))
    other.load_plan(str(path))
    y = deep_planes(256, 128, "gray10le")[0]
    assert torch.equal(other.transform(y), eng.transform(y))
    wrong = P.open_filter(opts, 256, 128, pix_fmt="gray", eager=False, device="cpu")
    with pytest.raises(ValueError, match="pix_fmt"):
        wrong.load_plan(str(path))


def _write(path, header, **arrays):
    with open(path, "wb") as f:
        np.savez(f, header=np.frombuffer(json.dumps(header).encode(), np.uint8), **arrays)


def test_bad_files_are_rejected(tmp_path):
    _write(tmp_path / "fmt.npz", {"format": "something-else", "version": 3})
    _write(tmp_path / "ver.npz", {"format": tplan.PLAN_FORMAT, "version": 99})
    _write(tmp_path / "none.npz", {"format": tplan.PLAN_FORMAT})
    with open(tmp_path / "nohead.npz", "wb") as f:
        np.savez(f, base_x=np.zeros(3, np.int32))
    with open(tmp_path / "pickled.npz", "wb") as f:  # an object array needs pickle
        np.savez(f, header=np.array([{"format": tplan.PLAN_FORMAT}], dtype=object))
    for name, match in (("fmt", "not a transform360_tpu plan"), ("ver", "version 99"),
                        ("none", "version None"), ("nohead", "not a transform360_tpu plan"),
                        ("pickled", "pickle")):
        with pytest.raises(ValueError, match=match):
            load_plan(str(tmp_path / f"{name}.npz"))


def test_codec_keeps_every_integer_range():
    arrays = {
        "wide": np.array([-(1 << 40), 0, (1 << 33) + 7], np.int64),
        "i32": np.array([-70000, 5, 1 << 20], np.int64),
        "u8": np.arange(300, dtype=np.int32) % 256,
        "floats": np.tile(np.float32([0.25, 0.5, 1 / 3]), 2000),
        "mask": np.array([True, False]),
    }
    packed, enc = tplan._encode_arrays(arrays)
    assert packed["wide"].dtype == np.int64 and "wide" not in enc
    assert packed["i32"].dtype == np.int32 and enc["i32"] == {"c": "int", "dtype": "int64"}
    assert packed["u8"].dtype == np.uint8
    assert enc["floats"]["c"] == "dict" and packed["floats"].dtype == np.uint8

    class Npz(dict):
        files = property(lambda self: list(self))

    data = tplan._Decoded(Npz(packed), enc)
    for k, a in arrays.items():
        assert data[k].dtype == a.dtype and np.array_equal(data[k], a), k
