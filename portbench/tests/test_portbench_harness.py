"""The harness on the CPU at tiny sizes: what BENCHMARK.json names exists,
the result line's shape, the trace arithmetic, no card means no result,
and no module of jax or of the JAX package is ever loaded."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
TINY = {"options": "cube_edge_length=32:interpolation_alg=cubic:enable_low_pass_filter=1:"
                   "input_stereo_format=mono:width_scale_factor=2:height_scale_factor=2",
        "in_w": 240, "in_h": 135, "pix_fmt": "yuv420p", "limits": {"max_lsb": 1, "diff_share": 0.005}}


# a mix's name, or ``live1_card+host``: that mix with numpy planes in and
# each output taken to the host (the loop's host options, which no cell uses)
HOST = {"inputs": "host", "outputs": "host"}


def tiny_traffic(name: str) -> dict:
    name, _, host = name.partition("+")
    t = harness.load_json(ROOT / "portbench" / "traffic" / f"{name}.json")
    return dict(t, batch=min(t["batch"], 8), warmup_calls=2, check_frames=min(t["check_frames"], 4),
                **(HOST if host else {}))


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == {"max_lsb", "diff_share"}
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert any(c["name"] == w["config"] for c in BENCH["configs"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    layers = harness.metrics_of(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layers and all(m["moves"] in e2e for m in layers)


def _trace_file(tmp_path) -> str:
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.transform", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.sync", "ts": 30, "dur": 60},
        {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20,
         "name": "void (anonymous namespace)::blur_ring_kernel<unsigned char, 8>((anonymous namespace)::Args)"},
        {"ph": "X", "cat": "kernel", "ts": 25, "dur": 25, "name": "void window_kernel<1, 4, 0>(Args<1>)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 70, "dur": 10, "name": "Memcpy DtoH (Device -> Pageable)"},
        {"ph": "X", "cat": "kernel", "ts": 200, "dur": 10, "name": "window_kernel"},  # outside
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 5, "name": "aten::empty"},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_trace_arithmetic(tmp_path):
    tr = devtrace.parse(_trace_file(tmp_path))
    assert tr.window_s == 100e-6
    assert tr.kernel_seconds(["blur_ring_kernel", "blur_direct_kernel"]) == (20e-6, 1)
    assert tr.kernel_seconds(["window_kernel"]) == (25e-6, 1)  # the one at 200 is outside
    assert tr.kernel_seconds(["blur"]) == (0.0, 0)  # whole identifiers only
    assert tr.busy() == [(10, 50), (70, 80)]
    assert tr.busy_s() == pytest.approx(50e-6)
    assert tr.gaps() == [(0, 10), (50, 70), (80, 100)]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["window_kernel", pytest.approx(25e-6)]
    assert dict(b["idle_gaps"]) == pytest.approx({"portbench.transform": 10e-6,
                                                  "portbench.sync": 40e-6})
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_result_line_on_the_cpu(cell):
    run, verdict = harness.run_cell(TINY, tiny_traffic(cell["traffic"]), 2**31 + 99, 0.2, False,
                                    "cpu", time.perf_counter(), log=lambda m: None)
    assert verdict.correct and verdict.judged_frames > 0
    info = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    res = harness.result(BENCH, cell, run, verdict, False, info)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == run.frames
    want = {m["name"] for m in harness.metrics_of(BENCH, cell["name"], False)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(line["check"]) == {"max_lsb", "diff_share"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would measure")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cubemap512_4k.batch128",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_no_module_of_jax_or_the_jax_package():
    mods = sorted(p.stem for p in (ROOT / "portbench").glob("*.py"))
    code = ("import sys, importlib; sys.path.insert(0, '.'); "
            f"[importlib.import_module('portbench.' + m) for m in {mods!r} if m != 'run']; "
            "import transform360_tpu_torch.api; "
            "from portbench import harness; print(harness.forbidden_modules()); "
            "print('transform360_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300).stdout.split("\n")
    assert out[0] == "[]"
    assert out[1] == "True"  # the port's name starts with the JAX package's, and passes


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "transform360_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of a cell on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cubemap512_4k.live1_card",
                        "--seed", str(2**31 + 17), "--seconds", "1", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["busy_s"] > 0
