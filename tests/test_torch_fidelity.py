"""The port's fidelity gate (``transform360_tpu_torch.fidelity``) on the CPU.

* At the gate size (1920x960 -> 480x320) against live ``oracle.py``
  outputs: every case's worst-plane PSNR is at least 50 dB and no more
  than 0.1 dB under the JAX package's on the same planes (its CPU path,
  one frame).  Measured: the port is within 0.01 dB of the JAX package on
  seven cases and 2 dB above it on ``nearest``.
* The committed oracle fixture is rebuilt by
  ``port_tools/make_fidelity_fixture.py``'s functions and is byte for
  byte the same file, input hashes included; the gate reads it when no
  ``want`` is given.
* The gate turns red on bugs injected into the port, as
  tests/test_fidelity.py does for the JAX package: a 2% cubic tap bug, a
  stereo eye-offset bug and a lanczos weight bug, each at 512x256 ->
  192x128 against the live oracle.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from transform360_tpu_torch import fidelity as F
from transform360_tpu_torch import geometry, sampling
from transform360_tpu_torch.config import Interpolation, StereoFormat
from transform360_tpu_torch.pipeline import clear_executor_cache
from transform360_tpu_torch.plan import clear_plan_cache

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "make_fidelity_fixture", ROOT / "port_tools" / "make_fidelity_fixture.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)

SMALL = dict(in_wh=(512, 256), out_wh=(192, 128), batch=2, device="cpu")
CASES = [name for name, _, _ in F.gate_cases(F.GATE_OUT)]
JAX_MARGIN_DB = 0.1  # the port's float32 geometry moves a case by a few hundredths


@pytest.fixture(scope="module")
def gate():
    """The oracle's outputs at the gate size and the fixture rebuilt from
    them (the JAX package's PSNRs included)."""
    want = mk.oracle_outputs(F.GATE_IN, F.GATE_OUT)
    return want, mk.build_fixture(want=want)


@pytest.fixture(scope="module")
def port_gate(gate):
    clear_plan_cache()
    return F.bench_fidelity(device="cpu", batch=2, want=gate[0])


def test_fixture_rebuilds_byte_identical(gate):
    assert mk.npz_bytes(gate[1]) == F.FIXTURE.read_bytes()
    fx = F.load_fixture()
    assert fx.sha256 == F.planes_sha256(F._video_like_planes(*F.GATE_IN))
    assert list(fx.want) == CASES
    for name in CASES:
        for a, b in zip(fx.want[name], gate[0][name]):
            assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_gate_case_against_live_oracle(name, gate, port_gate):
    jax_db = float(gate[1][f"jax_db.{name}"])
    db = (min(port_gate[p] for p in "YUV") if name == "flagship"
          else port_gate["configs"][name])
    assert db >= 50.0 and db >= jax_db - JAX_MARGIN_DB, (name, db, jax_db)


def test_gate_reads_the_fixture(port_gate):
    assert F.bench_fidelity(device="cpu", batch=2) == port_gate
    assert port_gate["worst_db"] == min([port_gate[p] for p in "YUV"]
                                        + list(port_gate["configs"].values()))
    with pytest.raises(ValueError, match="want="):
        F.bench_fidelity(in_wh=(512, 256), device="cpu")


def test_gate_raises_when_a_frame_differs(monkeypatch):
    plan = F.case_plans(SMALL["in_wh"], SMALL["out_wh"], parity_sweep=False)["flagship"]
    planes = F._video_like_planes(*SMALL["in_wh"])
    real = F.transform_batch

    def frame_fault(*args, **kw):
        y, u, v = real(*args, **kw)
        y = y.clone()
        y[1, 0, 0] ^= 1
        return y, u, v

    monkeypatch.setattr(F, "transform_batch", frame_fault)
    with pytest.raises(RuntimeError, match=r"frames \[1\] differs from frame 0"):
        F.run_case(plan, planes, 2, "cpu")


@pytest.fixture(scope="module")
def small_want():
    return mk.oracle_outputs(SMALL["in_wh"], SMALL["out_wh"])


@pytest.fixture
def fresh_plans():
    # plans, and the executors that hold equal plans' tables, built anew
    # with the code as the test patches it
    clear_plan_cache()
    clear_executor_cache()
    yield
    clear_plan_cache()
    clear_executor_cache()


def test_gate_green_at_the_small_size(small_want, fresh_plans):
    healthy = F.bench_fidelity(want=small_want, **SMALL)
    assert healthy["worst_db"] >= 50.0, healthy


def _scaled_tap(interp, k):
    """``_tap_weights`` with tap ``k`` of ``interp`` 2% too large."""
    real = sampling._tap_weights

    def buggy(i, f, xp=np):
        ws = real(i, f, xp)
        if i == interp:
            ws[k] = ws[k] * 1.02
        return ws

    return buggy


def test_gate_red_on_injected_cubic_tap_bug(small_want, fresh_plans, monkeypatch):
    bug = _scaled_tap(Interpolation.CUBIC, 1)
    # the plain path's weights and K3's tile plan (sampling.weight_table)
    monkeypatch.setattr(sampling, "_tap_weights", bug)
    broken = F.bench_fidelity(want=small_want, **SMALL)
    assert broken["worst_db"] < 50.0, f"injected tap bug not detected: {broken}"


def test_gate_red_on_injected_stereo_offset_bug(small_want, fresh_plans, monkeypatch):
    # the second eye's map rows sample 2 px past where the eye split puts
    # them: only the stereo cases read this offset
    real = geometry.build_warp_map

    def buggy(cfg, in_w, in_h, ow, oh):
        m = real(cfg, in_w, in_h, ow, oh).clone()
        if cfg.input_stereo_format == StereoFormat.TB:
            m[..., 1] = torch.where(m[..., 1] >= in_h / 2, m[..., 1] + 2.0, m[..., 1])
        elif cfg.input_stereo_format == StereoFormat.LR:
            m[..., 0] = torch.where(m[..., 0] >= in_w / 2, m[..., 0] + 2.0, m[..., 0])
        return m

    monkeypatch.setattr(geometry, "build_warp_map", buggy)
    broken = F.bench_fidelity(want=small_want, **SMALL)
    assert broken["Y"] >= 50.0, "flagship (MONO) should stay green"
    assert min(broken["configs"]["stereo_tb"], broken["configs"]["stereo_lr"]) < 50.0, broken
    assert broken["worst_db"] < 50.0


def test_gate_red_on_injected_lanczos_weight_bug(small_want, fresh_plans, monkeypatch):
    bug = _scaled_tap(Interpolation.LANCZOS4, 3)
    monkeypatch.setattr(sampling, "_tap_weights", bug)
    broken = F.bench_fidelity(want=small_want, **SMALL)
    assert broken["Y"] >= 50.0, "flagship (CUBIC) should stay green"
    assert broken["configs"]["lanczos4"] < 50.0, broken
    assert broken["worst_db"] < 50.0
