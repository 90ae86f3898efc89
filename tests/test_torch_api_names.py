"""Public-name parity between the JAX package and the port.

Every public top-level name (a function, class or assignment whose name
does not start with ``_``) of each module of ``transform360_tpu`` exists
in the module of the same path in ``transform360_tpu_torch``, or stands
on one of the exclusion lists below, each with its reason.  Names are
read with ``ast`` (nothing of either module runs).  Then the reference
wrapper's ``tokenize`` cases (``tests/test_ffmpeg_wrapper.py``,
``tests/test_ffmpeg_arity.py``) run against both packages.
"""

import ast
import pathlib

import pytest

from transform360_tpu import ffmpeg as jax_wrap
from transform360_tpu_torch import ffmpeg as port_wrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "transform360_tpu", ROOT / "transform360_tpu_torch"

# JAX name -> the port's name for the same function
RENAMED = {
    "filtering": {"apply_blur": "blur_plain"},
    "sampling": {"apply_area_resize": "area_resize"},
    "utils.profiling": {"time_jitted": "time_chain"},
}
# XLA/TPU-only names: lane-kernel routing thresholds read at trace time,
# HLO-constant staging of the remap's tap tables and its fix-up, the
# jax.sharding axis and replication helper, and TPU-fitted link rates
XLA_ONLY = {
    "pipeline": {"LANE_MIN_BATCH", "LANE_PACK_MAX", "LANE_MERGED", "BLUR_IMG_MAX_BATCH"},
    "sampling": {"remap_const", "remap_traced", "partial_fixup", "fixup_values",
                 "tap_arrays", "const_budget_bytes", "MAX_CONST_BYTES"},
    "parallel.mesh": {"replicated", "BATCH_AXIS"},
    "parallel.latency": {"HOST_INJECT_GBPS", "ICI_GBPS"},
}
# JAX modules with no module of the same path in the port
NOT_PORTED = {
    "ops.blur_lane": "the Pallas prefilter; K1 is ops/blur.py",
    "ops.remap_lane": "the Pallas lane remaps B2-B4, closed on K3 (ops/window.py)",
    "ops.remap_pallas": "the Pallas window remap B5; K3 is ops/window.py",
    "ops.staging": "hoists plan arrays out of XLA HLO constants",
    "oracle": "needs OpenCV; its planes reach the port as data/fidelity_oracle.npz",
    "utils.backend": "JAX platform set-up; the port keeps host_fingerprint in ops/_build.py",
}


def _modules(root: pathlib.Path):
    return sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in root.rglob("*.py"))


def _public(root: pathlib.Path, mod: str) -> set:
    tree = ast.parse((root / (mod.replace(".", "/") + ".py")).read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


@pytest.mark.parametrize("mod", _modules(JAX))
def test_every_public_name_has_a_port_counterpart(mod):
    if mod in NOT_PORTED:
        assert not (PORT / (mod.replace(".", "/") + ".py")).exists(), (
            f"{mod} is ported now: take it off NOT_PORTED")
        return
    jax_names, port_names = _public(JAX, mod), _public(PORT, mod)
    renamed, xla = RENAMED.get(mod, {}), XLA_ONLY.get(mod, set())
    assert set(renamed) | xla <= jax_names, f"stale exclusions for {mod}"
    assert set(renamed.values()) <= port_names, f"a renamed counterpart is missing from {mod}"
    missing = jax_names - port_names - set(renamed) - xla
    assert not missing, f"{mod}: public names of the JAX package missing in the port: {missing}"


def test_executor_names_are_ported():
    """``plane_executor`` and ``clear_executor_cache`` are no longer
    XLA-only: the port's executors capture CUDA graphs."""
    assert {"plane_executor", "clear_executor_cache", "transform_planes"} <= _public(
        PORT, "pipeline")
    assert not {"plane_executor", "clear_executor_cache"} & XLA_ONLY["pipeline"]


@pytest.mark.parametrize("wrap", [jax_wrap, port_wrap], ids=["jax", "port"])
def test_tokenize_basic(wrap):
    inputs, out_opts, out_path, g = wrap.tokenize(
        ["-y", "-ss", "10", "-i", "in.mp4", "-c:v", "libx264", "-an", "out.mp4"]
    )
    assert g == ["-y"]
    assert inputs == [([("-ss", "10")], "in.mp4")]
    assert out_opts == [("-c:v", "libx264"), ("-an", None)]
    assert out_path == "out.mp4"


@pytest.mark.parametrize("argv", [
    ["-i", "a.mp4", "o1.mp4", "o2.mp4"],
    ["-i", "a.mp4", "-c:v", "libx264"],
    ["-i"],
])
@pytest.mark.parametrize("wrap", [jax_wrap, port_wrap], ids=["jax", "port"])
def test_tokenize_rejects_multiple_outputs_and_missing_output(wrap, argv):
    with pytest.raises(wrap.UsageError):
        wrap.tokenize(argv)


@pytest.mark.parametrize("argv", [
    ["-y", "-i", "in.mp4", "-apad", "whole_dur=2", "-shortest", "out.mp4"],
    ["-hide_banner", "-i", "in.mp4", "-vf", "transform360=cube_edge_length=512", "-c:v",
     "libx264", "-crf", "18", "out.mp4"],
    ["-ss", "1", "-i", "a.mp4", "-i", "b.wav", "-map", "0:v", "-map", "1:a", "out.mkv"],
])
def test_tokenize_equals_the_reference(argv):
    assert port_wrap.tokenize(argv) == jax_wrap.tokenize(argv)
