"""``correct`` comes out false when the timed path is broken underneath a
run, and when the control (the reference in bfloat16) stands in the
program's place; a sound run is correct.  Tiny sizes on the CPU: the
harness's look for a card is skipped, the rest of a run is driven."""

import time

import pytest
import torch

from portbench import check, harness
from portbench.tests.test_portbench_harness import TINY, tiny_traffic
from transform360_tpu_torch.api import Transform360

SOUND = Transform360.transform


def _run(traffic):
    run, verdict = harness.run_cell(TINY, tiny_traffic(traffic), 7 * 2**31 + 5, 0.2, False, "cpu",
                                    time.perf_counter(), log=lambda m: None)
    return verdict


def stale(self, *planes):
    """A call that returns the last call's outputs (its state unchanged)."""
    out = SOUND(self, *planes)
    last = getattr(self, "_last", None)
    self._last = out
    return out if last is None else last


def half_batch(self, *planes):
    """Half of the batch left out: the second half repeats the first."""
    out = SOUND(self, *planes)
    out = out if isinstance(out, tuple) else (out,)
    if out[0].dim() < 3 or out[0].shape[0] < 2:
        return out
    h = out[0].shape[0] // 2
    return tuple(torch.cat([o[:h], o[:h], o[:o.shape[0] - 2 * h]]) for o in out)


def other_frame_v(self, *planes):
    """V from another frame: a batch's V planes shifted by one frame, or
    one frame's V left from the last call (a source not re-pointed)."""
    out = SOUND(self, *planes)
    v = out[2]
    if v.dim() == 3 and v.shape[0] > 1:
        return out[:2] + (torch.roll(v, 1, dims=0),)
    last = getattr(self, "_last_v", None)
    self._last_v = v
    return out[:2] + (v if last is None else last,)


def altered(self, *planes):
    """Every answer altered where it is produced: luma off by one level."""
    out = SOUND(self, *planes)
    y = out[0]
    return (torch.where(y < 255, y + 1, y - 1),) + tuple(out[1:])


MIXES = ["batch128", "live1_card+host", "live1_card"]


@pytest.mark.parametrize("traffic", MIXES)
def test_a_sound_run_is_correct(traffic):
    v = _run(traffic)
    assert v.correct and v.readings == {"max_lsb": 0.0, "diff_share": 0.0}


@pytest.mark.parametrize("fault, traffics", [
    (stale, MIXES),
    (half_batch, ["batch128"]),
    (other_frame_v, MIXES),
    (altered, MIXES),
])
def test_a_broken_path_is_not_correct(monkeypatch, fault, traffics):
    monkeypatch.setattr(Transform360, "transform", fault)
    for traffic in traffics:
        v = _run(traffic)
        assert not v.correct, (fault.__name__, traffic, v.readings)
        assert v.wrong_frames > 0


@pytest.mark.parametrize("traffic", ["batch128", "live1_card+host"])
def test_the_control_is_not_correct(traffic):
    """The reference in bfloat16 (the precision below the float32 the
    filter states) in the program's place, on the frames a run judges."""
    t = tiny_traffic(traffic)
    judge = check.Judge.for_config(TINY, "cpu")
    control = check.Judge(judge.plan, judge.tables, torch.bfloat16)
    for seed in (11, 12, 13):
        sets = harness.make_sets(TINY, t, seed, torch.device("cpu"))
        sampler = check.Sampler(seed, t["check_calls"], t["check_frames"], t["batch"])
        for i in range(50):
            sampler.offer(i % len(sets), ())
        frames = []
        for k in sampler.judged():
            frames += check.frame_readings(control.want(sets, k.input_set, k.frames),
                                           judge.want(sets, k.input_set, k.frames))
        v = check.verdict(frames, TINY["limits"])
        assert not v.correct and v.readings["max_lsb"] > 1 and v.readings["diff_share"] > 0.005
        judge.forget()
        control.forget()
