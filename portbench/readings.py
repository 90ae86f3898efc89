"""The two readings that each limit of the check is set from, for one
cell, in one process on the card:

* the lower reading: the program's sound runs, one short window per seed
  at the cell's own load, each judged as a benchmark run judges its
  window;
* the upper reading: the control, the reference computed in bfloat16
  (the nearest precision below the float32 the filter states) put in the
  program's place, judged on the frames a run would judge.

    python3 portbench/readings.py --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... [--seconds 1]

Prints one line per seed and a summary line; the benchmark's own runs
never run this.
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / ".cache" / "torch_extensions")
sys.path[0:1] = [str(ROOT)]

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import check, harness  # noqa: E402


def program_readings(config, traffic, seeds, seconds, device, judge, engine):
    """Per seed: the verdict of a short window of the program."""
    out = []
    for seed in seeds:
        run = harness.Run(config, traffic)
        sets = harness.make_sets(config, traffic, seed, device)
        loop = harness.Loop(engine, sets, traffic, device)
        harness.warm(loop, traffic["warmup_calls"])
        sampler = check.Sampler(seed, traffic["check_calls"], traffic["check_frames"],
                                traffic["batch"])
        harness.window(loop, seconds, sampler, run)
        judge.forget()
        v = check.judge(judge, sets, sampler.judged(), config["limits"])
        out.append((seed, v, run.calls))
    return out


def control_readings(config, traffic, seeds, calls, device, judge, control):
    """Per seed: the control's outputs on the frames a window of ``calls``
    calls would judge, against the reference."""
    out = []
    for seed in seeds:
        sets = harness.make_sets(config, traffic, seed, device)
        sampler = check.Sampler(seed, traffic["check_calls"], traffic["check_frames"],
                                traffic["batch"])
        for i in range(calls):
            sampler.offer(i % len(sets), ())
        judge.forget()
        control.forget()
        frames = []
        for k in sampler.judged():
            frames += check.frame_readings(control.want(sets, k.input_set, k.frames),
                                           judge.want(sets, k.input_set, k.frames))
        out.append((seed, check.verdict(frames, config["limits"])))
    return out


def main(argv=None, device="cuda"):
    import torch

    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device(device)
    t = time.perf_counter()
    engine = harness.make_engine(config, device, harness.Run(config, traffic))
    judge = check.Judge.for_config(config, device)
    control = check.Judge(judge.plan, judge.tables, torch.bfloat16)
    print(f"set-up {time.perf_counter() - t:.3f} s", flush=True)
    summary = {"workload": args.workload}
    prog = program_readings(config, traffic, args.seeds, args.seconds, device, judge, engine)
    for seed, v, calls in prog:
        print(json.dumps({"program": seed, "calls": calls, "frames": v.judged_frames,
                          "wrong": v.wrong_frames, **v.readings}), flush=True)
    calls = max([c for _, _, c in prog], default=1000)
    ctrl = control_readings(config, traffic, args.control_seeds, calls, device, judge, control)
    for seed, v in ctrl:
        print(json.dumps({"control": seed, "frames": v.judged_frames, "wrong": v.wrong_frames,
                          **v.readings}), flush=True)
    for key in check.NUMBERS:
        summary[f"lower.{key}"] = max((v.readings[key] for _, v, _ in prog), default=None)
        summary[f"upper.{key}"] = min((v.readings[key] for _, v in ctrl), default=None)
    summary["program_correct"] = all(v.correct for _, v, _ in prog)
    summary["control_correct_on_any_seed"] = any(v.correct for _, v in ctrl)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
