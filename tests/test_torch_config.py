"""The port's option parsing and output-geometry negotiation against the
JAX package's: same results, same exception types, on the option strings
of tests/test_config.py and the ffmpeg wrapper's fixtures."""

import dataclasses

import pytest

import transform360_tpu.config as jc
import transform360_tpu_torch.config as tc

OPTION_STRINGS = [
    "",
    "input_stereo_format=TB:interpolation_alg=cubic:w=192:h=160:"
    "output_layout=barrel:yaw=15.5:enable_low_pass_filter=0:"
    "num_vertical_segments=7:cube_offcenter_z=-0.35:vflip=true",
    "output_layout=CUBEMAP_32:input_stereo_format=MONO",
    "output_layout=cubemap_32:input_stereo_format=mono",
    "size=100x100:w=50:h=50",
    "bogus_option=1",
    "max_cube_edge_length=1000:input_stereo_format=mono",
    "cube_edge_length=530:input_stereo_format=mono",
    "cube_edge_length=512:output_layout=cubemap_23_offcenter:input_stereo_format=mono",
    "cube_edge_length=64:output_layout=equirect:input_stereo_format=mono",
    "cube_edge_length=64:output_layout=equirect:w=100:h=50:input_stereo_format=mono",
    "cube_edge_length=64:output_layout=equirect:input_stereo_format=tb:"
    "output_stereo_format=tb",
    "w=480:h=out_w/2:input_stereo_format=mono",
    "w=out_h*3:h=320:input_stereo_format=mono",
    "cube_edge_length=256:input_stereo_format=tb:output_stereo_format=tb",
    "cube_edge_length=256:input_stereo_format=tb:output_stereo_format=lr",
    "max_cube_edge_length=16384:input_stereo_format=lr",
    "cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:"
    "input_stereo_format=mono",
    "cube_edge_length=64:interpolation_alg=linear:output_layout=eac_32",
    "w=960:h=480:output_layout=flat_fixed:hfov=90:vfov=60:yaw=30:pitch=-10",
    "size=320x160:interpolation_alg=nearest:output_layout=barrel_split",
    "s=640x480",
    "w=640",
    "output_layout=unknown_layout:s=64x64",
    "interpolation_alg=3:s=64x64",
    "noequals",
    "num_horizontal_segments=15:num_vertical_segments=32:adjust_kernel=1:"
    "cube_edge_length=128",
    "cube_offcenter_x=0.1:cube_offcenter_y=-0.2:cube_offcenter_z=0.3:"
    "is_horizontal_offset=1:cube_edge_length=128",
    "w=floor(out_h*2):h=100",
    "w=bad_fn(3):h=100",
]
INPUT_SIZES = [(3840, 2160), (3840, 1920), (1024, 1024), (4096, 1024), (513, 257)]


def _plain(v):
    """Enums to ints, dataclasses to dicts: comparable across packages."""
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_plain(x) for x in v)
    if hasattr(v, "value") and hasattr(v, "name"):
        return int(v)
    return v


def _outcome(fn, *args):
    try:
        return "ok", _plain(fn(*args))
    except Exception as e:  # the exception TYPE is part of the contract
        return "raise", type(e).__name__


@pytest.mark.parametrize("opts", OPTION_STRINGS)
def test_parse_and_negotiate_agree(opts):
    pj = _outcome(jc.parse_options, opts)
    pt = _outcome(tc.parse_options, opts)
    assert pt == pj
    if pj[0] != "ok":
        return
    oj, ot = jc.parse_options(opts), tc.parse_options(opts)
    for w, h in INPUT_SIZES:
        assert _outcome(tc.resolve_stereo_formats, ot, w, h) == _outcome(
            jc.resolve_stereo_formats, oj, w, h
        )
        assert _outcome(tc.negotiate_output_geometry, ot, w, h) == _outcome(
            jc.negotiate_output_geometry, oj, w, h
        )


def test_defaults_cache_keys_and_validation_agree():
    assert _plain(tc.TransformConfig()) == _plain(jc.TransformConfig())
    kw = dict(fixed_yaw=12.5, num_vertical_segments=9, interpolation_alg=1)
    assert tc.TransformConfig(**kw).cache_key() == jc.TransformConfig(**kw).cache_key()
    for bad in (
        dict(width_scale_factor=0.0),
        dict(kernel_height_scale_factor=-1.0),
        dict(num_vertical_segments=1),
        dict(num_horizontal_segments=0),
        dict(min_kernel_half_height=0.1),
    ):
        assert _outcome(tc.TransformConfig(**bad).validate) == _outcome(
            jc.TransformConfig(**bad).validate
        )


def test_pixel_formats_and_chroma_dims_agree():
    assert sorted(tc.PIXEL_FORMATS) == sorted(jc.PIXEL_FORMATS)
    for name in jc.PIXEL_FORMATS:
        assert _plain(tc.get_pixel_format(name)) == _plain(jc.get_pixel_format(name))
        for w, h in INPUT_SIZES:
            assert tc.chroma_dims(w, h, name) == jc.chroma_dims(w, h, name)
    assert _outcome(tc.get_pixel_format, "rgb24") == _outcome(jc.get_pixel_format, "rgb24")
