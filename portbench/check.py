"""What decides ``correct``: the timed path's own outputs against the
plain reference.

The window keeps a sample of its calls, drawn from the seed (a reservoir
of ``check_calls`` calls, and the last call); of each kept call,
``check_frames`` frames, one from each equal stretch of its batch, so
both halves of a batch are always judged.  The reference builds its own
plan from the configuration's options and transforms the same input
frames; every output plane of every judged frame is compared sample by
sample.  Two numbers are compared, each with the configuration's limit:

* ``max_lsb``: the largest difference of one sample, in units of the
  last bit;
* ``diff_share``: the largest share of differing samples in one plane
  of one frame.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .inputs import frames_of
from .reference import plan as ref

NUMBERS = ("max_lsb", "diff_share")


@dataclasses.dataclass
class Kept:
    """One call kept from the window: its index, the input set it was
    given, the frames to judge and what it returned."""

    call: int
    input_set: int
    frames: Tuple[int, ...]
    outputs: Tuple[torch.Tensor, ...]


class Sampler:
    """A seeded reservoir of the window's calls, plus its last call."""

    def __init__(self, seed: int, calls: int, frames: int, batch: int):
        self._rng = random.Random(seed ^ 0x5EED)
        self._k = calls
        self._frames = min(frames, batch)
        self._batch = batch
        self.kept: List[Kept] = []
        self.last: Optional[Kept] = None
        self._seen = 0

    def _frames_to_judge(self) -> Tuple[int, ...]:
        n, b = self._frames, self._batch
        return tuple(sorted({(i * b) // n + self._rng.randrange(max(1, b // n)) for i in range(n)}))

    def offer(self, input_set: int, outputs) -> None:
        """Called once per call of the window, in order."""
        i = self._seen
        self._seen += 1
        self.last = Kept(i, input_set, (), tuple(outputs))
        if len(self.kept) < self._k:
            self.kept.append(Kept(i, input_set, (), self.last.outputs))
        else:
            j = self._rng.randrange(i + 1)
            if j < self._k:
                self.kept[j] = Kept(i, input_set, (), self.last.outputs)

    def judged(self) -> List[Kept]:
        """The kept calls (the last among them), each with its frames
        drawn from the seed."""
        out = [k for k in self.kept if self.last is None or k.call != self.last.call]
        if self.last is not None:
            out.append(self.last)
        for k in out:
            k.frames = self._frames_to_judge()
        return out


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x[None]


@dataclasses.dataclass
class Verdict:
    readings: Dict[str, float]
    limits: Dict[str, float]
    judged_frames: int
    wrong_frames: int

    @property
    def correct(self) -> bool:
        return (self.judged_frames > 0 and self.wrong_frames == 0
                and all(self.readings[k] <= self.limits[k] for k in NUMBERS))

    def lines(self) -> List[str]:
        return [f"check {k} {self.readings[k]!r} limit {self.limits[k]!r}" for k in NUMBERS]

    def as_json(self) -> Dict[str, dict]:
        return {k: {"value": self.readings[k], "limit": self.limits[k]} for k in NUMBERS}


class Judge:
    """The reference's plan and tables for one configuration on one
    device, and its outputs per (input set, frame), computed once per set
    of inputs (:meth:`forget` when the inputs change)."""

    def __init__(self, plan: ref.Plan, tables: ref.Tables, dt: torch.dtype = torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.plan = plan
        self.tables = tables
        self.device = tables.device
        self.dt = dt
        self._cache: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def for_config(cls, config: dict, device, dt: torch.dtype = torch.float32) -> "Judge":
        plan = ref.open_plan(config["options"], config["in_w"], config["in_h"],
                             config["pix_fmt"])
        return cls(plan, ref.Tables(device), dt)

    def forget(self) -> None:
        self._cache.clear()

    def want(self, sets: Sequence[Sequence], input_set: int, frames: Sequence[int]):
        """The reference's output planes ``[len(frames), h, w]`` for these
        frames of an input set (numpy or tensor planes)."""
        need = [f for f in frames if (input_set, f) not in self._cache]
        if need:
            planes = [_as_batch(torch.as_tensor(p).to(self.device)) for p in sets[input_set]]
            outs = ref.transform(self.plan, [frames_of(p, need) for p in planes], self.tables,
                                 self.dt)
            for i, f in enumerate(need):
                self._cache[(input_set, f)] = tuple(o[i:i + 1] for o in outs)
        return tuple(torch.cat([self._cache[(input_set, f)][p] for f in frames])
                     for p in range(self.plan.n_planes))


def frame_readings(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> List[Dict[str, float]]:
    """Per frame, the compared numbers of ``got`` against ``want`` (output
    planes ``[frames, h, w]``, one per image plane)."""
    if len(got) != len(want):
        raise RuntimeError(f"{len(got)} output planes, not {len(want)}")
    out = []
    for i in range(want[0].shape[0]):
        frame = {key: 0.0 for key in NUMBERS}
        for g, w in zip(got, want):
            if g.shape[1:] != w.shape[1:] or g.dtype != w.dtype:
                frame = {"max_lsb": float(1 << 16), "diff_share": 1.0}
                break
            d = (g[i].int() - w[i].int()).abs()
            frame["max_lsb"] = max(frame["max_lsb"], float(d.max()))
            frame["diff_share"] = max(frame["diff_share"], float((d > 0).float().mean()))
        out.append(frame)
    return out


def verdict(frames: Sequence[Dict[str, float]], limits: Dict[str, float]) -> Verdict:
    worst = {key: max([f[key] for f in frames], default=0.0) for key in NUMBERS}
    wrong = sum(any(f[key] > limits[key] for key in NUMBERS) for f in frames)
    return Verdict(worst, dict(limits), len(frames), wrong)


def judge(judge_: Judge, sets, kept: Sequence[Kept], limits: Dict[str, float]) -> Verdict:
    """Compare every judged frame of every kept call with the reference."""
    frames = []
    for k in kept:
        got = [frames_of(_as_batch(o), k.frames).to(judge_.device) for o in k.outputs]
        frames += frame_readings(got, judge_.want(sets, k.input_set, k.frames))
    return verdict(frames, limits)
