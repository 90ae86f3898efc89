"""Host issue time of the pieces of a plane executor's call, at one 4K frame.

    python3 port_tools/executor_costs.py

Run from the root of a checkout on a machine with one NVIDIA GPU.  Builds
the flagship engine (``chip_smoke.FLAGSHIP``), captures its batch-1
graphs, and prints one JSON object: microseconds of host time per call
of each piece (the copy into a static input, the graph's replay, the
output's clone, the whole luma executor call, ``transform_frame_planes``
and ``Transform360.transform`` on ``[H, W]`` planes, and the eager luma
program for comparison), each the median of 7 runs of 40 calls issued
while the card spins on ``torch.cuda._sleep``, so that the host never
waits for it; and the card's name and power limit.
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
    from chip_smoke import FLAGSHIP, batch_of, video_like_planes

    import transform360_tpu_torch as P
    from transform360_tpu_torch import pipeline

    eng = P.open_filter(FLAGSHIP, 3840, 2160, device="cuda")
    plan = eng.plan
    y1, u1, v1 = (batch_of(p, 1)[0] for p in video_like_planes(3840, 2160))
    xs = [p[None] for p in (y1, u1, v1)]
    for _ in range(2):  # the first call of the shape captures its graphs
        eng.transform(y1, u1, v1)
    luma = pipeline.plane_executor(plan.luma, "cuda")
    g = next(g for g in luma._by_shape.values() if g is not None)
    res = {
        "copy_ into the static input (luma)": issue_us(lambda: g.xs[0].copy_(xs[0])),
        "graph replay (luma)": issue_us(g.graph.replay),
        "clone of the static output (luma)": issue_us(g.out.clone),
        "luma executor call": issue_us(lambda: luma(xs[0])),
        "transform_frame_planes": issue_us(lambda: pipeline.transform_frame_planes(plan, xs)),
        "Transform360.transform [H, W]": issue_us(lambda: eng.transform(y1, u1, v1)),
        "eager luma program": issue_us(lambda: pipeline._plane_program(plan.luma, xs[0])),
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"host_us": {k: round(v, 2) for k, v in res.items()}, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
