"""The reader of ``k3_wide_share.batch`` on the CPU: nothing on an untraced
run, nor where the program counts no K3 tiles (as a program before the
counters ``window.tiles`` and ``window.tiles_wide``); under a CPU profiler,
the share of the tiles that K3's launches counted wide, with K3's C entry
faked (its launches are counted on the host: a 128-frame batch stages its
small windows 8 frames a pass, a 1-frame batch none)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from transform360_tpu_torch import api
from transform360_tpu_torch.ops import sources, window
from transform360_tpu_torch.utils import profiling

NAME = "k3_wide_share.batch"
OPTS = "cube_edge_length=96:interpolation_alg=cubic:input_stereo_format=mono"


class _FakeLibrary:
    def t360_window(self, call, stream, node):
        return 0


@pytest.fixture
def fresh_table(monkeypatch):
    monkeypatch.setattr(profiling, "_TABLE", profiling._Table(ended=True))


def _launch(B):
    """K3's launches of a B-frame luma batch of a small cubemap (class 0
    in two ranges, asked for whatever the share of its small windows),
    through the fake library."""
    pp = api.open_filter(OPTS, 1024, 512, device="cpu").plan.luma
    wp = window.build_window_plan(pp.spec, pp.fill, 1,
                                  (window.SMALL_BYTES, window.WIDE_FRAMES, 0.0))
    wt = window.WindowTables.from_plan(wp, "cpu")
    assert [g[3] for g in wt.groups][:2] == [window.WIDE_FRAMES, 2]
    src = (sources.Source(0x10000, B, pp.in_h * pp.in_w, True),)
    window._launch_plan(_FakeLibrary(), wt, src, torch.empty(0, dtype=torch.uint8), 0, 255)
    return wt


def test_nothing_untraced_or_without_the_counters(fresh_table):
    _launch(128)
    assert harness.reader(NAME)(None) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("window.launches")  # a program that counts no tiles
    assert harness.reader(NAME)(None) is None


@pytest.mark.parametrize("B", [128, 1])
def test_share_of_tiles_staged_wide(B, fresh_table):
    with profile(activities=[ProfilerActivity.CPU]):
        wt = _launch(B)
    counts = profiling.traced().counts
    assert counts["window.tiles"] == wt.meta.shape[0]
    small = wt.groups[0][1]
    want = 100.0 * small / wt.meta.shape[0] if B > window.CTA_FRAMES_MIN else 0.0
    assert harness.reader(NAME)(None) == pytest.approx(want)
