"""The port's profiling tools (``transform360_tpu_torch.utils.profiling``) on
the CPU: a ``torch.profiler`` trace written and read back, the chain
timers on a tiny plan, and a CUDA trace refused without a card (it never
quietly records the CPU alone).  ``chip_smoke.py`` phase 18 runs them on
the card.  The call path's spans and counters: off without a profiler
(no ``record_function``, no clock, nothing recorded), one
``t360.transform`` per API call with its spans inside it under a CPU
profiler, nested in the Chrome trace as in the table, the table started
anew by each profiler session and bounded.  ``tests/test_torch_cuda.py``
holds the spans against CUPTI's launches on the card."""

import json
import math
import sys
import threading

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from torch.profiler import ProfilerActivity, profile, record_function

from transform360_tpu_torch.utils import profiling
from transform360_tpu_torch.utils.profiling import (
    COUNTERS, StageStats, count, device_trace, self_ns, span, time_chain, time_frame_step,
    trace_kernels, traced,
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


def _engine_and_planes(b=2):
    eng = P.open_filter(VF, 256, 128, device="cpu")
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.integers(0, 256, (b, 128, 256), np.uint8))
    u, v = (torch.from_numpy(rng.integers(0, 256, (b, 64, 128), np.uint8)) for _ in range(2))
    return eng, (y, u, v)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# one CPU API call's spans, in the order they are entered: the luma
# executor, then the chroma one, each its key then K1's and K3's wrappers
CPU_CALL = ["t360.transform"] + ["t360.executor", "t360.executor.key", "t360.k1.launch",
                                 "t360.k3.launch"] * 2


def test_span_off_enters_no_record_function_reads_no_clock_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while no profiler records")

    eng, planes = _engine_and_planes()
    eng.transform(*planes)  # the first call builds the tables
    monkeypatch.setattr(profiling, "_TABLE", profiling._Table(ended=True))
    monkeypatch.setattr(profiling, "_RecordFunction", refuse)
    monkeypatch.setattr(profiling, "_now", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    eng.transform(*planes)
    assert span("executor") is span("transform")  # one preallocated no-op
    with span("executor"):
        pass
    assert traced() == ([], {}, 0)


def test_each_transform_is_one_call_of_spans_under_a_cpu_profiler():
    eng, planes = _engine_and_planes()
    eng.transform(*planes)
    with _cpu_profile():
        eng.transform(*planes)
        eng.transform(*planes)
    spans = traced().spans
    assert [s.name for s in spans] == CPU_CALL * 2
    roots = [i for i, s in enumerate(spans) if s.name == "t360.transform"]
    assert [spans[i].parent for i in roots] == [-1, -1] and roots == [0, len(CPU_CALL)]
    for i, s in enumerate(spans):
        assert s.call == max(r for r in roots if r <= i)  # its API call's id
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.call == s.call
    assert [s.name for s in spans if s.parent == 0] == ["t360.executor"] * 2
    assert {spans[s.parent].name for s in spans if s.name == "t360.k1.launch"} == {"t360.executor"}
    # a span's own time: its duration less its children's
    inside = sum(s.end_ns - s.start_ns for s in spans if s.parent == 0)
    assert self_ns(spans, 0) == spans[0].end_ns - spans[0].start_ns - inside
    key = CPU_CALL.index("t360.executor.key")
    assert self_ns(spans, key) == spans[key].end_ns - spans[key].start_ns


def test_chrome_trace_nests_the_spans_in_the_callers_own(tmp_path):
    eng, planes = _engine_and_planes()
    eng.transform(*planes)
    with device_trace(str(tmp_path), device="cpu") as path:
        with record_function("caller"):
            eng.transform(*planes)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    caller = [e for e in events if e["name"] == "caller"]
    ours = [e for e in events if e["name"].startswith("t360.")]
    assert len(caller) == 1 and sorted(e["name"] for e in ours) == sorted(CPU_CALL)

    def within(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    assert all(within(e, caller[0]) for e in ours)
    (call,) = [e for e in ours if e["name"] == "t360.transform"]
    assert all(within(e, call) for e in ours)
    assert len(traced().spans) == len(CPU_CALL)


def test_a_new_profiler_session_starts_the_table_anew():
    eng, planes = _engine_and_planes(1)
    with _cpu_profile():
        eng.transform(*planes)
        count("test.session")
    assert traced().counts == {"test.session": 1}
    with _cpu_profile():
        eng.transform(*planes)
        eng.transform(*planes)
    t = traced()
    assert [s.name for s in t.spans].count("t360.transform") == 2
    assert t.counts == {} and t.dropped == 0
    assert [s.call for s in t.spans if s.name == "t360.transform"] == [0, len(CPU_CALL)]


def test_counters_count_always_and_are_tallied_while_traced():
    before = COUNTERS["test.counter"]
    count("test.counter", 2)
    with _cpu_profile():
        count("test.counter")
        count("test.counter", 4)
    count("test.counter")
    assert COUNTERS["test.counter"] == before + 8
    assert traced().counts == {"test.counter": 5}


def test_the_table_is_bounded_and_counts_what_it_drops(monkeypatch):
    eng, planes = _engine_and_planes(1)
    eng.transform(*planes)
    monkeypatch.setattr(profiling, "TABLE_RECORDS", 4)
    with _cpu_profile():
        eng.transform(*planes)
    # spans are kept as they end: the luma executor's three, then itself;
    # its API call's span ended past the bound, so they lie in no kept span
    t = traced()
    assert [s.name for s in t.spans] == CPU_CALL[1:5]
    assert t.dropped == len(CPU_CALL) - 4
    assert [s.parent for s in t.spans] == [-1, 0, 0, 0]
    assert all(s.call == -1 and s.end_ns >= s.start_ns for s in t.spans)


def test_spans_of_many_threads_lose_no_record():
    # more threads than cores, switching often: every span is kept once,
    # inside the span its own thread opened around it
    threads, depth, rounds = 16, 3, 200

    def work():
        for _ in range(rounds):
            with span("transform"), span("executor"), span("executor.key"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    t = traced()
    assert len(t.spans) == threads * depth * rounds and t.dropped == 0
    names = {"t360.executor": "t360.transform", "t360.executor.key": "t360.executor"}
    for s in t.spans:
        if s.name == "t360.transform":
            assert s.parent == -1 and t.spans[s.call] is s
        else:
            p = t.spans[s.parent]
            assert p.name == names[s.name] and p.call == s.call
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
