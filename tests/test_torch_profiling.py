"""The port's profiling tools (``transform360_tpu_torch.utils.profiling``) on
the CPU: a ``torch.profiler`` trace written and read back, the chain
timers on a tiny plan, and a CUDA trace refused without a card (it never
quietly records the CPU alone).  ``chip_smoke.py`` phase 18 runs them on
the card."""

import json
import math

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from transform360_tpu_torch.utils.profiling import (
    StageStats, device_trace, time_chain, time_frame_step, trace_kernels,
)

VF = "cube_edge_length=32:input_stereo_format=mono"


def test_device_trace_on_the_cpu_writes_a_trace_that_trace_kernels_reads(tmp_path):
    eng = P.open_filter(VF, 256, 128, device="cpu")
    y = torch.zeros((2, 128, 256), dtype=torch.uint8)
    c = torch.zeros((2, 64, 128), dtype=torch.uint8)
    with device_trace(str(tmp_path), device="cpu") as path:
        eng.transform(y, c, c)
    assert path.startswith(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e["name"].startswith("aten::") for e in events)
    assert trace_kernels(path) == {}  # no card, so no kernel
    # the card's kernels as CUPTI's events name them: counted and summed by name
    kernel = {"ph": "X", "cat": "kernel", "ts": 0}
    events += [dict(kernel, name="window_kernel<4>", dur=250.0),
               dict(kernel, name="window_kernel<4>", dur=500.0),
               dict(kernel, name="blur_ring_kernel", dur=1000.0),
               dict(kernel, name="async", ph="b", dur=5.0)]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    assert trace_kernels(path) == {"window_kernel<4>": (2, 0.75), "blur_ring_kernel": (1, 1.0)}


def test_chain_timers_return_a_finite_positive_time_on_the_cpu():
    eng = P.open_filter(VF, 256, 128, device="cpu")
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (2, 128, 256), np.uint8))
    c = torch.from_numpy(rng.integers(0, 256, (2, 64, 128), np.uint8))
    step = time_frame_step(eng.plan, y, c, c, n_short=1, n_long=3, repeats=2)
    one = time_frame_step(eng.plan, y[0], c[0], c[0], n_short=1, n_long=3, repeats=2)
    add = time_chain(lambda x: x + 1, y, n_short=1, n_long=5, repeats=2)
    for t in (step, one, add):
        assert math.isfinite(t) and t > 0


def test_cuda_trace_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is not reachable")
    with pytest.raises(RuntimeError, match="cuda"):
        with device_trace(str(tmp_path / "t")):
            pass
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        with device_trace(str(tmp_path / "t"), device="meta"):
            pass
    assert not (tmp_path / "t").exists()  # nothing written


def test_stage_stats_line(capsys):
    import sys

    s = StageStats(stream=sys.stdout)
    s.record(4, 0.5)
    s.emit(wall_seconds=2.0, device="cpu")
    line = json.loads(capsys.readouterr().out)
    assert line["frames"] == 4 and line["fps"] == 2.0 and line["device"] == "cpu"
