"""The readers of the program's spans and counters on the CPU at tiny
sizes: nothing on an untraced run or on a program without the spans, and
on a tiny CPU engine driven under a CPU profiler each reader's value per
API call, recomputed here from the program's table; the live readers
read nothing from a table of eager calls, and read a replay's spans and
node updates where a graph was replayed (a captured graph's replay path
driven on the CPU with a stand-in graph)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from transform360_tpu_torch import api, pipeline
from transform360_tpu_torch.ops import nodes
from transform360_tpu_torch.ops.sources import Source
from transform360_tpu_torch.utils import profiling

LIVE = ["executor_ms.live", "executor_key_ms.live", "repoint_ms.live", "replay_ms.live",
        "node_updates.live"]
BATCH = ["launch_ms.batch", "transform_max_ms.batch"]
OPTS = ("cube_edge_length=32:interpolation_alg=cubic:enable_low_pass_filter=1:"
        "input_stereo_format=mono:width_scale_factor=2:height_scale_factor=2")
CALLS = 3


def _read(name):
    return harness.reader(name)(None)


def _per_call_ms(names):
    spans = profiling.traced().spans
    return sum(s.end_ns - s.start_ns for s in spans if s.name in names) / CALLS / 1e6


@pytest.fixture
def fresh_table(monkeypatch):
    monkeypatch.setattr(profiling, "_TABLE", profiling._Table(ended=True))


def _eager_calls():
    """CALLS calls of a tiny supersampled CPU engine (K1, K3 and K4's plain
    versions) under a CPU profiler."""
    eng = api.open_filter(OPTS, 240, 136, device="cpu")
    planes = (torch.zeros((2, 136, 240), dtype=torch.uint8),
              torch.zeros((2, 68, 120), dtype=torch.uint8),
              torch.zeros((2, 68, 120), dtype=torch.uint8))
    eng.transform(*planes)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(CALLS):
            eng.transform(*planes)


@pytest.mark.parametrize("name", LIVE + BATCH)
def test_nothing_on_an_untraced_run(name, fresh_table):
    eng = api.open_filter(OPTS, 240, 136, device="cpu")
    eng.transform(torch.zeros((1, 136, 240), dtype=torch.uint8),
                  torch.zeros((1, 68, 120), dtype=torch.uint8),
                  torch.zeros((1, 68, 120), dtype=torch.uint8))
    assert _read(name) is None


@pytest.mark.parametrize("name", LIVE + BATCH)
def test_nothing_from_a_program_without_the_spans(name, monkeypatch):
    _eager_calls()
    monkeypatch.delattr(profiling, "traced")
    assert _read(name) is None


def test_eager_calls_under_a_cpu_profiler():
    _eager_calls()
    spans = profiling.traced().spans
    assert _read("executor_ms.live") == pytest.approx(_per_call_ms({"t360.executor"}))
    assert _read("executor_key_ms.live") == pytest.approx(_per_call_ms({"t360.executor.key"}))
    launches = {"t360.k1.launch", "t360.k3.launch", "t360.k4.launch"}
    assert {s.name for s in spans} >= launches
    assert _read("launch_ms.batch") == pytest.approx(_per_call_ms(launches))
    longest = max(s.end_ns - s.start_ns for s in spans if s.name == "t360.transform")
    assert _read("transform_max_ms.batch") == pytest.approx(longest / 1e6)
    assert 0 < _read("executor_key_ms.live") < _read("executor_ms.live")
    assert _read("launch_ms.batch") < _read("transform_max_ms.batch") * CALLS
    # an eager run replays no graph: the live readers that need one read nothing
    for name in ("repoint_ms.live", "replay_ms.live", "node_updates.live"):
        assert _read(name) is None


class _Replayed:
    """A captured graph's stand-in: its replay does nothing."""

    def replay(self):
        pass


def test_replayed_calls_under_a_cpu_profiler():
    # a graph of four recorded nodes (K1 on the sources, one between, two
    # K3 launches on the output), replayed CALLS times on other planes and
    # a fresh output each, inside the API call's and the executor's spans
    def node(handle, src, out):
        return nodes.Node(handle, src, out, lambda *a: None)

    src, mid, out = (Source(1 << 20, 1, 0, True),), 7 << 20, 9 << 20
    recorded = [node(1, src, mid), node(2, (Source(mid, 1, 0, True),), mid + 1),
                node(3, (Source(mid + 1, 1, 0, True),), out),
                node(4, (Source(mid + 1, 1, 0, True),), out)]
    g = pipeline._Graph(_Replayed(), 0, nodes.Program(recorded, src, out), (None,), (None,),
                        (1, 8, 8), torch.uint8, torch.device("cpu"), (("blur.launches", 1),))
    plane = torch.zeros((1, 16, 16), dtype=torch.uint8)
    kept = []
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(CALLS):
            with profiling.span("transform"), profiling.span("executor"):
                kept.append(g([plane], [Source((2 + k) << 20, 1, 0, True)]))
    t = profiling.traced()
    assert t.counts == {"nodes.updates": 3 * CALLS, "blur.launches": CALLS}
    assert _read("node_updates.live") == 3
    assert _read("repoint_ms.live") == pytest.approx(_per_call_ms({"t360.executor.repoint"}))
    assert _read("replay_ms.live") == pytest.approx(_per_call_ms({"t360.executor.replay"}))
    assert (_read("repoint_ms.live") + _read("replay_ms.live") < _read("executor_ms.live")
            <= _read("transform_max_ms.batch") * CALLS)
    assert _read("executor_key_ms.live") is None  # no key span in this stand-in
    assert _read("launch_ms.batch") is None  # a replay calls no kernel wrapper
