"""Time variants of K1 (``csrc/blur.cu``) against each other, in turns.

    python3 port_tools/k1_variants.py [--min-blocks 2 3 4] [--strip 16 24]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Each ``--min-blocks`` value rebuilds K1 with the ring kernel's
``__launch_bounds__(256, N)`` (ptxas then caps its registers; its lines
are printed), each ``--strip`` value rebuilds the flagship's tile plans
with ``ops.blur.STRIP_MAX`` rows per warp strip.  Every variant is first
checked against the shipping build on two luma frames (same bytes), then
all are timed by CUDA events in alternating order over four rounds, at
the shapes of the flagship's paths: 16, 1 and 128 luma frames, a chroma
pair and 256 chroma planes.  Prints one JSON line of medians (ms) per
shape.  The builds go to ``transform360_tpu_torch/build/`` (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--strip", type=int, nargs="+", default=[16, 24])
    args = ap.parse_args()

    import torch

    import transform360_tpu_torch as P
    from chip_smoke import FLAGSHIP, batch_of, cuda_times, video_like_planes
    from transform360_tpu_torch.ops import _build, blur

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    shipping = blur._lib()
    src = (_build.CSRC / "blur.cu").read_text()
    bound = "__launch_bounds__(kThreads, 3)"
    assert src.count(bound) == 1, "the ring kernel's launch bounds moved"
    libs, csrc = {}, _build.CSRC
    for mb in args.min_blocks:
        d = _build.BUILD_DIR / "variants" / f"min_blocks_{mb}"
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "blur.cu").write_text(src.replace(bound, f"__launch_bounds__(kThreads, {mb})"))
        _build.CSRC = d
        _build.BUILD_LOG.pop("blur", None)
        try:
            lib = ctypes.CDLL(str(_build._build("blur")))
        finally:
            _build.CSRC = csrc
        # an unchanged source hashes to the shipping library: nothing is rebuilt
        log = _build.BUILD_LOG.get("blur", "(the shipping build: chip_smoke.py prints its lines)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "shipping" in line:
                print(f"min_blocks {mb}: {line.strip()}", flush=True)
        lib.t360_blur.argtypes = shipping.t360_blur.argtypes
        lib.t360_blur.restype = ctypes.c_int
        lib.t360_error_string.argtypes = [ctypes.c_int]
        lib.t360_error_string.restype = ctypes.c_char_p
        libs[mb] = lib

    plan = P.open_filter(FLAGSHIP, 3840, 2160, device="cuda").plan
    y, u, v = video_like_planes(3840, 2160)
    yb, ub, vb = batch_of(y, 128), batch_of(u, 128), batch_of(v, 128)
    cb = torch.cat([ub, vb])
    strip0 = blur.STRIP_MAX
    tabs = {}
    for st in args.strip:
        blur.STRIP_MAX = st
        tabs[st] = tuple(blur.BlurTables.from_plan(pp.blur, pp.in_h, pp.in_w, "cuda")
                         for pp in (plan.luma, plan.chroma))
        print(f"strip {st}: tile rows luma {sorted(set(tabs[st][0].tiles[:, 2].tolist()))}, "
              f"chroma {sorted(set(tabs[st][1].tiles[:, 2].tolist()))}", flush=True)
    blur.STRIP_MAX = strip0

    def run(lib, bt, x):
        blur._lib = lambda: lib
        try:
            return blur.blur_px(bt, x)
        finally:
            blur._lib = lambda: shipping

    want = run(shipping, tabs[args.strip[0]][0], yb[:2].contiguous())
    variants = {f"min_blocks {mb}, strip {st}": (libs[mb], tabs[st])
                for mb in args.min_blocks for st in args.strip}
    for name, (lib, (lt, _)) in variants.items():
        if not torch.equal(run(lib, lt, yb[:2].contiguous()), want):
            raise SystemExit(f"FAIL variant {name} differs from the shipping build")
    shapes = {"16 luma": (0, yb[:16].contiguous()), "1 luma": (0, yb[:1].contiguous()),
              "2 chroma": (1, torch.cat([ub[:1], vb[:1]])), "128 luma": (0, yb),
              "256 chroma": (1, cb)}
    for shape, (plane, x) in shapes.items():
        times = {k: [] for k in variants}
        reps = 3 if x.shape[0] >= 100 else 10
        order = list(variants.items())
        for rnd in range(4):
            for name, (lib, t) in (order if rnd % 2 == 0 else order[::-1]):
                run(lib, t[plane], x)
                times[name] += cuda_times(lambda: run(lib, t[plane], x), reps)
        print(json.dumps({"shape": shape, "card": smi, "n": 4 * reps,
                          "median_ms": {k: statistics.median(v) for k, v in times.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
