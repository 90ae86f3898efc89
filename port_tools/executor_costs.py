"""Host issue time of the pieces of a plane executor's call, at one 4K frame.

    python3 port_tools/executor_costs.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  Builds
the flagship engine (``chip_smoke.FLAGSHIP``), captures its batch-1
graphs, and prints one JSON object: microseconds of host time per call
of each piece of a replay on the caller's planes (the planes'
descriptions, the fresh output's allocation, the re-pointing of the
graph's nodes that touch the caller's memory -- K1's, its tensor maps
encoded anew, and K3's per window class -- at another frame's planes and
output each call, and at the same ones, which updates nothing; and the
graph's replay), the
whole luma and chroma executor calls, ``transform_frame_planes`` and
``Transform360.transform`` on ``[H, W]`` planes (two frames in turn, each
output kept until the next call, so that every replay pays its node
updates), and the eager luma program for comparison, each the median of
7 runs of 40 calls issued while the card spins on ``torch.cuda._sleep``,
so that the host never waits for it; the source checks and descriptions
that an eager K1 or K3 call makes (``sources.check_sources``) on the
luma plane and on the U, V pair, memoized and with the memo emptied
before each call, in 4 rounds in turns (memoized, emptied, emptied,
memoized, ...: every round's value is printed); the nodes each graph
re-points; and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def issue_us(fn, n: int = 40, reps: int = 7) -> float:
    """Host microseconds per fn() call, n calls issued behind a spin long
    enough to cover them; the median of reps."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
    return statistics.median(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("executor_costs: a GPU is required", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import FLAGSHIP, alternating, batch_of, video_like_planes

    import transform360_tpu_torch as P
    from transform360_tpu_torch import pipeline
    from transform360_tpu_torch.ops import sources

    eng = P.open_filter(FLAGSHIP, 3840, 2160, device="cuda")
    plan = eng.plan
    y2, u2, v2 = (batch_of(p, 2) for p in video_like_planes(3840, 2160))
    y1, u1, v1 = y2[0], u2[0], v2[0]
    xs = [p[None] for p in (y1, u1, v1)]
    for _ in range(2):  # the first call of the shape captures its graphs
        eng.transform(y1, u1, v1)
    luma, chroma = (pipeline.plane_executor(pp, "cuda") for pp in (plan.luma, plan.chroma))
    g, gc = (next(g for g in ex._by_shape.values() if g is not None) for ex in (luma, chroma))
    # two frames' planes and outputs on the card, for re-pointing in turns
    other = [p[1:2] for p in (y2, u2, v2)]
    pts = [(sources.describe(f[:1]), sources.describe(f[1:]),
            torch.empty(g.out_shape, dtype=g.dtype, device=g.device),
            torch.empty(gc.out_shape, dtype=gc.dtype, device=gc.device)) for f in (xs, other)]
    turn = [0]

    def repoint(graph, which):
        """Re-point graph at the other frame's planes and output."""
        turn[0] ^= 1
        src, csrc, out, cout = pts[turn[0]]
        if which == "luma":
            graph.program.repoint(graph.exec_, src, out.data_ptr())
        else:
            graph.program.repoint(graph.exec_, csrc, cout.data_ptr())

    res = {
        "describe the plane (luma)": issue_us(lambda: sources.describe(xs[:1])),
        "allocate the output (luma)": issue_us(
            lambda: torch.empty(g.out_shape, dtype=g.dtype, device=g.device)),
        "re-point the nodes, new planes and output (luma)": issue_us(lambda: repoint(g, "luma")),
        "re-point the nodes, new planes and output (chroma, U and V)": issue_us(
            lambda: repoint(gc, "chroma")),
        "re-point the nodes, the same planes and output (luma)": issue_us(
            lambda: g.program.repoint(g.exec_, pts[0][0], pts[0][2].data_ptr())),
        "graph replay (luma)": issue_us(g.graph.replay),
        "luma executor call": issue_us(alternating(luma, xs[:1], other[:1])),
        "chroma executor call": issue_us(alternating(chroma, xs[1:], other[1:])),
        "transform_frame_planes": issue_us(alternating(
            lambda *f: pipeline.transform_frame_planes(plan, f), xs, other)),
        "Transform360.transform [H, W]": issue_us(alternating(
            eng.transform, (y1, u1, v1), [p[0] for p in other])),
        "eager luma program": issue_us(lambda: pipeline._plane_program(plan.luma, xs[0])),
    }
    # the source checks of an eager K1 or K3 call, memoized and not, in turns
    checks = {"luma": (xs[0], plan.luma), "U, V": (tuple(xs[1:]), plan.chroma)}
    memo = {}
    for r in range(4):
        for mode in (("memoized", "emptied") if r % 2 == 0 else ("emptied", "memoized")):
            for what, (x, pp) in checks.items():
                args = (x, pp.in_h, pp.in_w, pp.dtype, y1.device, "check")
                if mode == "memoized":
                    fn = lambda: sources.check_sources(*args)
                else:
                    fn = lambda: (sources._MEMO.clear(), sources.check_sources(*args))
                memo.setdefault(f"check_sources {what}, {mode}", []).append(round(issue_us(fn), 2))
    nodes = {"luma": len(g.program.nodes), "chroma": len(gc.program.nodes)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"host_us": {k: round(v, 2) for k, v in res.items()},
                      "check_sources_us_by_round": memo, "nodes_repointed": nodes, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
