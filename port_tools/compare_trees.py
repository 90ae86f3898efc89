"""Time the flagship step of several checkouts of the port, in turns.

    python3 port_tools/compare_trees.py parent=old change=. change=. parent=old
    python3 port_tools/compare_trees.py k2=old:pipeline.WINDOW_MAX_BATCH=64
    python3 port_tools/compare_trees.py --supersampled parent=old change=. change=. parent=old

Run from the root of a checkout on a machine with one NVIDIA GPU.  Each
argument is ``label=DIR`` (a directory holding ``transform360_tpu_torch/``,
for instance an earlier commit unpacked with ``git archive <commit>
transform360_tpu_torch | tar -x -C DIR``), optionally followed by
``:module.ATTR=value`` settings applied to that package's modules before
the run.  Each argument runs in its own process, in the order given, so
``parent change change parent`` interleaves the two trees on one card.
Each process builds its kernels, makes the flagship's video-like frames
(``chip_smoke.py``'s generator), and prints one JSON line: the step's
device median in ms by CUDA events at batch 128 and at batch 1 (one
[H, W] frame; frames 0 and 1 in turn, each output kept until the next
call, so that a graph replayed on the caller's planes pays its node
updates), the sample count, the K1 launches per step, the
frame's device time behind a busy card (``behind_ms``: the call issued
while the card spins, so that events read only its device work), one numpy
frame in to CPU tensors out (``numpy_to_cpu_ms``: the median host wall
of 50 calls, synchronized), the 10-bit flagship's step at batch 128
(``deep_batch128``) and the flagship without its prefilter at batch 128
and 8 (``nopf_batch128``, ``nopf_batch8``, two batches in turn as at
batch 1: there K3 reads U and V), each by CUDA events, the remap
kernel K3 alone at the paths' shapes (16, 1 and 128 luma frames, a
chroma pair, 256 chroma planes): the median by CUDA events around one
call (``k3_ms``: the wrapper's host time before the launch included),
the device time per call (``k3_ms_graph``: 20 calls captured in a CUDA
graph and replayed, so that no host time enters; 20 calls issued back to
back still wait on the host at one frame), the same for each window
class's launch alone at one and 128 luma frames (``k3_class_ms_graph``:
tiles, ms), the host's time to issue one call (``k3_host_ms``: 200 calls
issued, then one synchronize), K3 by CUDA events on 128 10-bit luma
frames and on the supersampled 2x2 plan's 128 luma frames and 256 chroma
planes (``k3_more_ms``), the prefilter kernel K1 alone at the same
shapes, its chroma U and V in place as two sources (``k1_ms``: the
median by CUDA events around one call;
``k1_ms_graph``: the device time per call of 20 calls replayed as a CUDA
graph; ``k1_host_ms``: the host's time to issue one call, the median of
9 rounds of 100 calls issued, each round then synchronized), and the
card's name and power limit.
With ``--supersampled`` each process times the supersampled 2x2
flagship (``chip_smoke.SUPERSAMPLED``) instead: its step's device median
at batch 128 and at batch 1, the batch-128 step's peak memory over what
was allocated before it (``torch.cuda.max_memory_allocated``), and the
INTER_AREA kernel K4 alone on the plan's luma (``k4_ms``: 1 and 16
frames as a replayed CUDA graph of 20 calls, 128 frames by CUDA events;
uint8 and uint16 samples under 1024) and the host's time to issue one
call on one frame (``k4_host_ms``: 200 calls, then one synchronize); no
K3 times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(label: str, settings: list, supersampled: bool = False) -> None:
    import dataclasses
    import importlib
    import importlib.util
    import statistics
    import time

    import torch

    import transform360_tpu_torch as P
    from transform360_tpu_torch.ops import blur, window
    from transform360_tpu_torch.utils.profiling import COUNTERS

    # this checkout's chip_smoke.py, whichever tree's package is timed (a
    # tree's own chip_smoke.py may be older)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    FLAGSHIP, SUPERSAMPLED, alternating, batch_of, behind_ms, cuda_times, host_walls = (
        smoke.FLAGSHIP, smoke.SUPERSAMPLED, smoke.alternating, smoke.batch_of, smoke.behind_ms,
        smoke.cuda_times, smoke.host_walls)
    video_like_planes = smoke.video_like_planes

    remap = window.remap_window_px
    for s in settings:
        name, value = s.split("=", 1)
        mod, attr = name.rsplit(".", 1)
        setattr(importlib.import_module(f"transform360_tpu_torch.{mod}"), attr, int(value))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    eng = P.open_filter(SUPERSAMPLED if supersampled else FLAGSHIP, 3840, 2160, device="cuda")
    y, u, v = video_like_planes(3840, 2160)
    yb, ub, vb = batch_of(y, 128), batch_of(u, 128), batch_of(v, 128)
    res = {"label": label, "package": os.path.dirname(P.__file__), "settings": settings,
           "card": smi}
    # one frame: frames 0 and 1 in turn, each output kept until the next
    # call, so that a replay on the caller's planes re-points its nodes
    one = alternating(eng.transform, *[[t[k] for t in (yb, ub, vb)] for k in (0, 1)])
    for b, reps in ((128, 60), (1, 300)):
        step = (lambda: eng.transform(yb, ub, vb)) if b == 128 else one
        cuda_times(step, 3)
        n0 = COUNTERS["blur.launches"]
        ts = cuda_times(step, reps)
        res[f"batch{b}"] = {"step_ms": statistics.median(ts), "n": len(ts),
                            "k1_launches": (COUNTERS["blur.launches"] - n0) / len(ts)}
    res["batch1"]["behind_ms"] = behind_ms(one, 30)
    from_host = lambda: [o.cpu() for o in eng.transform(y, u, v)]
    host_walls(from_host, 5)
    res["batch1"]["numpy_to_cpu_ms"] = statistics.median(host_walls(from_host, 50))
    if not supersampled:
        deep = P.open_filter(FLAGSHIP, 3840, 2160, pix_fmt="yuv420p10le", device="cuda")
        nopf = P.open_filter(FLAGSHIP.replace("enable_low_pass_filter=1",
                                              "enable_low_pass_filter=0"), 3840, 2160,
                             device="cuda")
        dplanes = [(t.int() * 1023 // 255).to(torch.uint16) for t in (yb, ub, vb)]
        for key, e, planes, reps in (("deep_batch128", deep, dplanes, 30),
                                     ("nopf_batch128", nopf, (yb, ub, vb), 30),
                                     ("nopf_batch8", nopf, None, 60)):
            fn = (lambda: e.transform(*planes)) if planes is not None else alternating(
                e.transform, *[[t[k * 8:(k + 1) * 8] for t in (yb, ub, vb)] for k in (0, 1)])
            cuda_times(fn, 3)
            ts = cuda_times(fn, reps)
            res[key] = {"step_ms": statistics.median(ts), "n": len(ts)}
        del dplanes, deep, nopf
    if supersampled:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng.transform(yb, ub, vb)
        torch.cuda.synchronize()
        res["batch128"]["peak_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2**30
        from chip_smoke import graph_ms
        from transform360_tpu_torch.ops import area

        da = eng.plan.luma.tables("cuda").area
        g = torch.Generator(device="cuda").manual_seed(0)
        res["k4_ms"] = {}
        for dt, mx in ((torch.uint8, 255), (torch.uint16, 1023)):
            for b in (1, 16, 128):
                x = torch.randint(0, mx + 1, (b, da.in_h, da.in_w), dtype=torch.int32,
                                  device="cuda", generator=g).to(dt)
                fn = lambda: area.area_px(da, x, mx)
                if b <= 16:
                    ms = graph_ms(fn, 20, 20)
                else:
                    cuda_times(fn, 3)
                    ms = statistics.median(cuda_times(fn, 20))
                res["k4_ms"][f"u{8 * x.element_size()} b{b}"] = ms
                if b == 1:  # the host's time to issue one call
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(200):
                        fn()
                    res.setdefault("k4_host_ms", {})[f"u{8 * x.element_size()} b1"] = (
                        (time.perf_counter() - t0) * 1e3 / 200)
                    torch.cuda.synchronize()
                del x
        print(json.dumps(res), flush=True)
        return
    lw, cw = (pp.window_tables("cuda") for pp in (eng.plan.luma, eng.plan.chroma))
    cb = torch.cat([ub, vb])
    res["k3_ms"], res["k3_ms_graph"], res["k3_host_ms"], res["k3_class_ms_graph"] = {}, {}, {}, {}

    def graph_fn_ms(fn, reps):
        """Device ms per fn() call: 20 calls captured in a CUDA graph, the
        median of reps replays."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                fn()
        graph.replay()
        ms = statistics.median(cuda_times(graph.replay, reps)) / 20
        del graph
        return ms

    def graph_ms(wt, x, reps):
        return graph_fn_ms(lambda: remap(wt, x), reps)

    for shape, wt, x in (("16 luma", lw, yb[:16].contiguous()), ("1 luma", lw, yb[:1].contiguous()),
                         ("2 chroma", cw, cb[:2].contiguous()), ("128 luma", lw, yb),
                         ("256 chroma", cw, cb)):
        cuda_times(lambda: remap(wt, x), 3)
        ts = cuda_times(lambda: remap(wt, x), 10 if x.shape[0] >= 100 else 40)
        res["k3_ms"][shape] = statistics.median(ts)
        reps = 3 if x.shape[0] >= 100 else 20
        res["k3_ms_graph"][shape] = graph_ms(wt, x, reps)
        if shape in ("1 luma", "128 luma"):
            res["k3_class_ms_graph"][shape] = [
                (g[1], graph_ms(dataclasses.replace(wt, groups=(g,)), x, reps))
                for g in wt.groups]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            remap(wt, x)
        res["k3_host_ms"][shape] = (time.perf_counter() - t0) * 1e3 / 200
        torch.cuda.synchronize()
    # K3 on the deep and the supersampled paths' planes, by CUDA events
    deep = P.open_filter(FLAGSHIP, 3840, 2160, pix_fmt="yuv420p10le", device="cuda").plan
    dw = deep.luma.window_tables("cuda")
    yd = (yb.int() * 1023 // 255).to(torch.uint16)
    sp = P.open_filter(SUPERSAMPLED, 3840, 2160, device="cuda").plan
    slw, scw = sp.luma.window_tables("cuda"), sp.chroma.window_tables("cuda")
    res["k3_more_ms"] = {}
    for shape, fn in (("10-bit 128 luma", lambda: remap(dw, yd, 1023)),
                      ("supersampled 128 luma", lambda: remap(slw, yb)),
                      ("supersampled 256 chroma", lambda: remap(scw, cb))):
        cuda_times(fn, 3)
        res["k3_more_ms"][shape] = statistics.median(cuda_times(fn, 10))
    del yd
    lb, cbt = (pp.tables("cuda").blur for pp in (eng.plan.luma, eng.plan.chroma))
    res["k1_ms"], res["k1_ms_graph"], res["k1_host_ms"] = {}, {}, {}
    for shape, bt, x in (("16 luma", lb, yb[:16].contiguous()), ("1 luma", lb, yb[:1].contiguous()),
                         ("2 chroma", cbt, (ub[:1], vb[:1])), ("128 luma", lb, yb),
                         ("256 chroma", cbt, (ub, vb))):
        big = (x[0].shape[0] if isinstance(x, tuple) else x.shape[0]) >= 100
        fn = lambda: blur.blur_px(bt, x)
        cuda_times(fn, 3)
        res["k1_ms"][shape] = statistics.median(cuda_times(fn, 10 if big else 40))
        res["k1_ms_graph"][shape] = graph_fn_ms(fn, 3 if big else 20)
        rounds = []
        for _ in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            rounds.append((time.perf_counter() - t0) * 1e3 / 100)
        torch.cuda.synchronize()
        res["k1_host_ms"][shape] = statistics.median(rounds)
    print(json.dumps(res), flush=True)


def main(argv) -> int:
    if argv and argv[0] == "--child":
        child(argv[2], argv[3:], argv[1] == "supersampled")
        return 0
    mode = "flagship"
    if argv and argv[0] == "--supersampled":
        mode, argv = "supersampled", argv[1:]
    rc = 0
    for spec in argv:
        label, rest = spec.split("=", 1)
        tree, *settings = rest.split(":")
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", mode, label,
                              *settings], env=env, capture_output=True, text=True)
        if out.returncode:
            print(f"{label}: exit {out.returncode}\n{out.stderr[-3000:]}", flush=True)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
