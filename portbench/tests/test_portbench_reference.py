"""The frozen reference against the port's plain path on tiny frames: both
configurations at a small input size, and the rest of the option surface
(projections, stereo, interpolators, border rules, deep formats)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.reference import plan as ref
from transform360_tpu_torch import api

ROOT = Path(__file__).resolve().parents[2]


def _tiny(config: str) -> str:
    """A configuration's options at a cube edge for a small input."""
    with open(ROOT / "portbench" / "configs" / f"{config}.json") as f:
        return json.load(f)["options"].replace("cube_edge_length=512", "cube_edge_length=32")


CASES = [
    (_tiny("cubemap512_4k"), 240, 135, "yuv420p"),
    (_tiny("cubemap512_4k_ss2x2"), 240, 135, "yuv420p"),
    ("cube_edge_length=32:interpolation_alg=lanczos4:input_stereo_format=TB", 128, 128, "yuv420p10le"),
    ("output_layout=barrel:interpolation_alg=cubic:w=192:h=64:enable_low_pass_filter=1", 256, 128,
     "yuv420p"),
    ("output_layout=barrel_split:interpolation_alg=linear:w=96:h=64", 256, 128, "yuv444p12le"),
    ("output_layout=eac_32:interpolation_alg=nearest:w=96:h=64:yaw=30:pitch=-10", 256, 128, "gray16le"),
    ("output_layout=flat_fixed:w=64:h=48:hfov=90:vfov=70:interpolation_alg=cubic", 256, 128, "yuv422p"),
    ("cube_edge_length=32:input_stereo_format=LR:output_layout=cubemap_23_offcenter:"
     "cube_offcenter_z=-0.3:enable_low_pass_filter=1:adjust_kernel=1:num_horizontal_segments=4", 512, 128,
     "yuv420p"),
    ("output_layout=equirect:w=128:h=64:width_scale_factor=1.5:height_scale_factor=1.5:"
     "interpolation_alg=linear", 256, 128, "gbrp"),
]


@pytest.mark.parametrize("options, w, h, pix_fmt", CASES)
def test_reference_equals_the_plain_path(options, w, h, pix_fmt):
    rp = ref.open_plan(options, w, h, pix_fmt)
    f = api.open_filter(options, w, h, pix_fmt=pix_fmt, device="cpu")
    assert (rp.out_w, rp.out_h) == f.output_dims()
    g = torch.Generator().manual_seed(w * h)
    planes = [torch.randint(0, rp.luma.maxval + 1, (2, pp.in_h, pp.in_w), generator=g,
                            dtype=torch.int32).to(rp.luma.dtype) for pp in rp.plane_plans()]
    got = f.transform(*planes)
    got = got if isinstance(got, tuple) else (got,)
    want = ref.transform(rp, planes, ref.Tables("cpu"), block=1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.reference.plan, portbench.check, portbench.work, "
            "portbench.inputs, portbench.devtrace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120).stdout
    top = set(eval(out))
    assert not top & {"transform360_tpu_torch", "transform360_tpu", "jax", "jaxlib", "flax"}
