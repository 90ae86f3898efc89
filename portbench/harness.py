"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Everything a cell is made of is data found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` and each metric's reader in
``metrics/<metric>.py``.  The program is driven only through its public
API: ``transform360_tpu_torch.api.open_filter`` and
``Transform360.transform``.

A traffic mix is a closed loop of calls, each handed the next of
``pool`` input sets of ``batch`` frames:

* ``inputs``: ``card`` (the planes lie on the device, as a hardware
  decoder leaves them) or ``host`` (numpy planes, as a software decoder's);
* ``outputs``: ``card`` (left there, as for a hardware encoder) or
  ``host`` (each plane taken to the host with ``.cpu()``);
* ``wait``: ``end`` (calls back to back, one synchronize after the last:
  throughput) or ``call`` (each call waits for its outputs: latency);
* ``roll_px``: the sideways shift between consecutive frames;
* ``warmup_calls``, ``trace_calls``: calls before the window, and in the
  traced window of a ``--trace 1`` run;
* ``check_calls``, ``check_frames``: calls kept from the window besides
  the last, and frames judged of each (:mod:`.check`).

Each call's outputs are kept until the next call returns, so every call
writes other memory than the last (and a replayed graph re-points its
nodes).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "transform360_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``--trace 1`` its per-layer ones (a metric with no ``workloads`` key
    goes to every cell that reports the metric it moves)."""
    def here(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if here(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (here(m) if "workloads" in m else m["moves"] in names)]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench.metrics." + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    plan: object = None  # the reference's plan (:mod:`.reference.plan`)
    setup_s: float = 0.0
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    plan_build_s: float = 0.0
    calls: int = 0
    window_s: float = 0.0
    latency_s: List[float] = dataclasses.field(default_factory=list)
    issue_s: List[float] = dataclasses.field(default_factory=list)
    trace: object = None  # :class:`.devtrace.Trace`
    trace_calls: int = 0
    memory_peak_bytes: int = 0

    @property
    def frames(self) -> int:
        return self.calls * self.traffic["batch"]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The traffic mix's calls on one engine."""

    def __init__(self, engine, sets, traffic: dict, device):
        self.engine = engine
        self.sets = sets
        self.t = traffic
        self.device = device
        self._i = -1
        self._prev = None

    def call(self, span: Callable = None):
        """One call on the next input set: (input set, outputs as the
        caller holds them, seconds until transform returned, seconds until
        the outputs were where the caller reads them; the last two with
        ``wait: call`` only)."""
        self._i = (self._i + 1) % len(self.sets)
        planes = self.sets[self._i]
        t0 = time.perf_counter()
        if span is None:
            outs = self.engine.transform(*planes)
        else:
            with span("portbench.transform"):
                outs = self.engine.transform(*planes)
        t1 = time.perf_counter()
        outs = outs if isinstance(outs, tuple) else (outs,)
        if self.t["outputs"] == "host":
            if span is None:
                outs = tuple(o.cpu() for o in outs)
            else:
                with span("portbench.to_host"):
                    outs = tuple(o.cpu() for o in outs)
        elif self.t["wait"] == "call":
            if span is None:
                _sync(self.device)
            else:
                with span("portbench.sync"):
                    _sync(self.device)
        t2 = time.perf_counter()
        self._prev = outs  # kept until the next call has returned
        return self._i, outs, t1 - t0, t2 - t0


def make_engine(config: dict, device, run: Run):
    from transform360_tpu_torch import api

    t = time.perf_counter()
    eng = api.open_filter(config["options"], config["in_w"], config["in_h"],
                          pix_fmt=config["pix_fmt"], device=device)
    run.plan_build_s = time.perf_counter() - t
    return eng


def make_sets(config: dict, traffic: dict, seed: int, device):
    from . import inputs

    sets = inputs.input_sets(seed, config["in_w"], config["in_h"], config["pix_fmt"],
                             traffic["batch"], traffic["pool"], traffic["roll_px"], device)
    if traffic["inputs"] == "host":
        sets = inputs.on_host(sets)
    _sync(device)
    return sets


def warm(loop: Loop, calls: int) -> float:
    """The first call's seconds (it builds or loads the kernels' libraries,
    the remap's tile plan, and captures a graph where one replays); then
    ``calls - 1`` more, so that every input set has been seen."""
    t = time.perf_counter()
    loop.call()
    _sync(loop.device)
    first = time.perf_counter() - t
    for _ in range(max(calls, len(loop.sets)) - 1):
        loop.call()
    _sync(loop.device)
    return first


def window(loop: Loop, seconds: float, sampler, run: Run) -> None:
    """The measured window: calls until ``seconds`` have passed, then one
    synchronize; every call is offered to the check's sampler."""
    wait_each = loop.t["wait"] == "call"
    lat, issue = run.latency_s, run.issue_s
    n = 0
    start = time.perf_counter()
    while True:
        i, outs, t_issue, t_done = loop.call()
        sampler.offer(i, outs)
        issue.append(t_issue)
        if wait_each:
            lat.append(t_done)
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    _sync(loop.device)
    run.window_s = time.perf_counter() - start
    run.calls = n


def traced(loop: Loop, run: Run) -> None:
    """The traced window: ``trace_calls`` calls inside the benchmark's
    spans, under the profiler."""
    from torch.profiler import record_function

    from . import devtrace

    n = loop.t["trace_calls"]

    def body():
        for _ in range(n):
            loop.call(span=record_function)

    run.trace = devtrace.record(body, loop.device, first=loop.call)
    run.trace_calls = n


def run_cell(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, log=print) -> tuple:
    """One run: (:class:`Run`, :class:`.check.Verdict`).  ``device`` is
    where the program runs; the command line only ever passes the card."""
    import torch

    from . import check

    run = Run(config, traffic)
    parts = run.setup_parts
    t = time.perf_counter()
    import transform360_tpu_torch  # noqa: F401  (import time is part of set-up)

    parts["import_port_s"] = time.perf_counter() - t
    device = torch.device(device)
    t = time.perf_counter()
    if device.type == "cuda":
        device = torch.device("cuda", 0 if device.index is None else device.index)
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
    parts["cuda_init_s"] = time.perf_counter() - t
    engine = make_engine(config, device, run)
    parts["plan_s"] = run.plan_build_s
    t = time.perf_counter()
    sets = make_sets(config, traffic, seed, device)
    parts["inputs_s"] = time.perf_counter() - t
    loop = Loop(engine, sets, traffic, device)
    t = time.perf_counter()
    parts["first_call_s"] = warm(loop, traffic["warmup_calls"])
    parts["warmup_s"] = time.perf_counter() - t
    nvcc = _nvcc_seconds()
    if nvcc is not None:
        parts["nvcc_s"] = nvcc
    run.setup_s = time.perf_counter() - t0
    log("setup " + " ".join(f"{k}={v!r}" for k, v in parts.items())
        + f" setup_s={run.setup_s!r}")

    sampler = check.Sampler(seed, traffic["check_calls"], traffic["check_frames"],
                            traffic["batch"])
    window(loop, seconds, sampler, run)
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        traced(loop, run)
    kept = sampler.judged()
    del engine, loop, sampler
    t = time.perf_counter()
    judge = check.Judge.for_config(config, device)
    run.plan = judge.plan
    verdict = check.judge(judge, sets, kept, config["limits"])
    log(f"check: {verdict.judged_frames} frames of {len(kept)} calls judged, "
        f"{verdict.wrong_frames} wrong, in {time.perf_counter() - t:.3f} s")
    return run, verdict


def _nvcc_seconds() -> Optional[float]:
    """nvcc's wall time in this process, from the build module's counter
    (0 when every library was already built)."""
    mod = sys.modules.get("transform360_tpu_torch.ops._build")
    secs = getattr(mod, "BUILD_SECONDS", None)
    return None if secs is None else float(sum(secs.values()))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's (whole names: ``transform360_tpu_torch`` passes)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_note() -> str:
    """The card's name, power limit and SM clocks, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def result(bench: dict, cell: dict, run: Run, verdict, trace: bool, device_info: dict) -> dict:
    metrics = {}
    for m in metrics_of(bench, cell["name"], trace):
        v = reader(m["name"])(run)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": verdict.correct, "attempted": run.frames,
           "failed": verdict.wrong_frames, "metrics": metrics, "device": device_info}
    if trace:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["check"] = verdict.as_json()
    return out


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, args.workload)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} found: no result")
        return 2
    log(f"setup import_torch_s={time.perf_counter() - t!r}")
    run, verdict = run_cell(config, traffic, args.seed, args.seconds, bool(args.trace),
                            "cuda", t0, log)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    res = result(bench, cell, run, verdict, bool(args.trace), device_info)
    bad = forbidden_modules()
    if bad:
        log(f"modules of {bad} were loaded in this process: no result")
        return 3
    log(f"card: {card_note()}")
    if run.trace is not None:
        _log_trace(run, log)
    if run.latency_s:
        log(f"latency: {len(run.latency_s)} calls, mean "
            f"{statistics.fmean(run.latency_s) * 1e3!r} ms")
    log(f"window: {run.calls} calls, {run.frames} frames in {run.window_s!r} s; "
        f"peak memory {run.memory_peak_bytes} bytes")
    for line in verdict.lines():
        log(line)
    print(json.dumps(res), flush=True)
    return 0


def _log_trace(run: Run, log) -> None:
    from . import work

    tr = run.trace
    log(f"trace: {run.trace_calls} calls, window {tr.window_s!r} s, busy {tr.busy_s()!r} s, "
        f"{len(tr.kernels)} kernels, {len(tr.copies)} copies; trace file {tr.file_bytes} bytes")
    for name, fn in work.KERNELS.items():
        w = fn(run.plan, run.traffic["batch"])
        if w is not None:
            w = w * run.trace_calls
            log(f"work {name}: {w.bytes!r} bytes, {w.ops!r} float ops over the traced calls; "
                f"bound {w.bound_s() * 1e3!r} ms by {w.bound_by()} "
                f"(peaks {work.PEAK_BYTES_PER_S:g} B/s, {work.PEAK_FP32_PER_S:g} FLOP/s)")
