"""Time variants of K3 (``csrc/window.cu``) against each other, in turns.

    python3 port_tools/k3_variants.py [--small 3072:8 2048:8:0 6144:4 ...]
        [--frames auto all 1] [--source other=path/to/window.cu ...]
        [--supersampled] [--depth 8] [--shapes "128 luma" ...]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
A variant is a build of K3, a tile plan and the way each launch is issued:

* ``--source label=path`` builds that copy of ``window.cu`` (the same C
  interface; a trial edit, timed against the shipping source in one call)
  beside the shipping one, one nvcc per copy, all at once; a copy without
  ``pass_frames`` (an earlier K3, whose last call field is a flag for two
  frames a pass) is given 1 for two or more frames a pass, else 0;
* ``--small BYTES:FRAMES[:SHARE]``: the plan's small windows, class 0's
  windows of at most BYTES staged FRAMES frames a pass in a range of
  their own where they are SHARE of its tiles or more
  (``build_window_plan``'s ``small``; default the package's
  ``SMALL_BYTES:WIDE_FRAMES:SMALL_SHARE``; SHARE 0 splits any plan that
  has such windows), their launches as the package makes them
  (``ops.window.launches``);
* ``--frames``: the frames of the batch one CTA loops over: ``auto`` is
  the package's (``launches``: frame groups on the grid's y axis for
  launches with few tiles), ``all`` the whole batch (no groups), an
  integer that many (at most the batch).

The plan is the flagship's (``chip_smoke.FLAGSHIP``), or with
``--supersampled`` its 2x2 supersampled twin (K3 to 3072x2048);
``--depth 10`` runs the uint16 instantiations on 10-bit planes, and
``--shapes`` keeps the named shapes below (default: all).

Every combination is a variant.  Printed per variant: the registers,
local bytes, resident CTAs per SM and shared memory of each class launch
at batch 128 and at batch 1.  Every variant is first held against
``remap_plain`` on three luma frames and three chroma planes (same
bytes), then all are timed by CUDA events in alternating order over four
rounds, at the shapes of the flagship's paths: 16, 1 and 128 luma
frames, a chroma pair and 256 chroma planes stacked, and U and V as two
sources (1 + 1, 8 + 8, 63 + 65, 128 + 128); one JSON line of medians
(ms per call) per shape.  Under 100 frames a sample is a replay of 20
calls captured in a CUDA graph (device time: one call, or calls issued
back to back, wait there on the host).  Last, each plan range of
every variant launched alone on one and 128 luma frames and 256 chroma
planes (one JSON line each).
The trial builds go to ``transform360_tpu_torch/build/`` (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", nargs="+", default=None)
    ap.add_argument("--frames", nargs="+", default=["auto"])
    ap.add_argument("--source", nargs="*", default=[])
    ap.add_argument("--supersampled", action="store_true")
    ap.add_argument("--depth", type=int, default=8, choices=[8, 10])
    ap.add_argument("--shapes", nargs="+", default=None)
    args = ap.parse_args()
    for fr in args.frames:
        if fr not in ("auto", "all") and not (fr.isdigit() and int(fr) > 0):
            raise SystemExit(f"--frames takes auto, all or a positive integer, not {fr}")

    import torch

    import transform360_tpu_torch as P
    from chip_smoke import (FLAGSHIP, SUPERSAMPLED, batch_of, cuda_times, to_depth,
                            video_like_planes)
    from transform360_tpu_torch.ops import _build, sources, window
    from transform360_tpu_torch.sampling import remap_plain, round_px

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    shipping = window.KERNEL.library()

    def build(label, path):
        d = _build.BUILD_DIR / "variants" / f"k3_{label}"
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        shutil.copy(path, d / "window.cu")
        lib_path = d / "libwindow.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(lib_path),
               str(d / "window.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{res.stderr}")
        return window.KERNEL.bind(ctypes.CDLL(str(lib_path)))

    trials = [spec.split("=", 1) for spec in args.source]
    libs = {"window.cu": shipping}
    if trials:
        with ThreadPoolExecutor(max_workers=len(trials)) as ex:
            libs.update(zip((lb for lb, _ in trials), ex.map(lambda t: build(*t), trials)))
    # the copies whose kernels take a flag for two frames a pass
    flagged = {lb for lb, path in trials if "pass_frames" not in open(path).read()}

    def per_pass(var, fp):
        """The call's frames a pass for the build of ``var``."""
        return int(fp >= 2) if var[0] in flagged else fp

    opts = SUPERSAMPLED if args.supersampled else FLAGSHIP
    pix_fmt = "yuv420p" if args.depth == 8 else "yuv420p10le"
    plan = P.open_filter(opts, 3840, 2160, pix_fmt=pix_fmt, device="cuda").plan
    maxval = plan.luma.maxval
    smalls = args.small or [f"{window.SMALL_BYTES}:{window.WIDE_FRAMES}:{window.SMALL_SHARE}"]
    tables = {}  # --small setting: (luma, chroma) tables of its plan
    for sm in smalls:
        small = tuple(float(v) if i == 2 else int(v) for i, v in enumerate(sm.split(":")))
        small += (window.SMALL_SHARE,)[len(small) - 2:]
        tables[sm] = tuple(window.WindowTables.from_plan(
            window.build_window_plan(pp.spec, pp.fill, pp.window_plan().sample_bytes, small),
            "cuda") for pp in (plan.luma, plan.chroma))

    def choices(var, counts, wt):
        """(group, frames per CTA, frames a pass) of each launch on sources
        of ``counts`` frames."""
        frames, B = var[2], sum(counts)
        return [((f, n, w), fr if frames == "auto" else B if frames == "all"
                 else min(B, int(frames)), fp)
                for f, n, w, fp, fr in window.launches(wt.groups, B, max(counts))]

    def run(var, x, plane, fresh=False):
        """The variant's launches on x; ``fresh``: into an output filled
        with 90 first (a frame no launch wrote shows)."""
        wt = tables[var[1]][plane]
        xs = sources.as_sources(x)
        B = sources.frames(xs)
        out = torch.empty((B, wt.out_h, wt.out_w), dtype=wt.dtype, device=xs[0].device)
        if fresh:
            out.fill_(90)
        stream = torch.cuda.current_stream(xs[0].device).cuda_stream
        for g, frames, fp in choices(var, [s.shape[0] for s in xs], wt):
            window.launch_class(libs[var[0]], wt, xs, out, g, frames, per_pass(var, fp), stream,
                                maxval)
        return out

    variants = {}
    for var in itertools.product(libs, smalls, args.frames):
        name = f"{var[0]}: small {var[1]}, frames {var[2]}"
        variants[name] = var
        for (plane, pname), B in itertools.product(enumerate(("luma", "chroma")), (128, 1)):
            occ = []
            wt = tables[var[1]][plane]
            for g, _, fp in choices(var, [B], wt):
                out = (ctypes.c_int * 4)()
                err = libs[var[0]].t360_window_attrs(wt.sample_bytes, wt.taps, wt.mode, g[2],
                                                     per_pass(var, fp), out)
                if err:
                    raise SystemExit(f"attrs {name}: {shipping.t360_error_string(err).decode()}")
                occ.append(tuple(out))
            print(f"{name} {pname} batch {B}: (tiles, frames a pass) per launch "
                  f"{[(g[1], fp) for g, _, fp in choices(var, [B], wt)]}, (registers, local "
                  f"bytes, CTAs per SM, smem) per launch {occ}", flush=True)

    yb, ub, vb = (batch_of(p, 128) if args.depth == 8 else to_depth(batch_of(p, 128), args.depth)
                  for p in video_like_planes(3840, 2160))
    cb = torch.cat([ub, vb])
    lt, ct = plan.luma.tables("cuda"), plan.chroma.tables("cuda")
    dt = plan.luma.dtype
    want = (round_px(remap_plain(lt.remap, yb[:3]), maxval, dt),
            round_px(remap_plain(ct.remap, cb[:3]), maxval, dt),
            round_px(remap_plain(ct.remap, torch.cat([ub[:1], vb[:2]])), maxval, dt))
    want17 = round_px(remap_plain(lt.remap, yb[:17]), maxval, dt)
    for name, var in variants.items():
        if not (torch.equal(run(var, yb[:3].contiguous(), 0, True), want[0])
                and torch.equal(run(var, cb[:3].contiguous(), 1, True), want[1])
                and torch.equal(run(var, (ub[:1], vb[:2]), 1, True), want[2])
                and torch.equal(run(var, yb[:17].contiguous(), 0, True), want17)):
            raise SystemExit(f"FAIL variant {name} differs from remap_plain")
    print(f"all {len(variants)} variants equal remap_plain on 3 and 17 luma frames and 3 "
          f"chroma planes, stacked and as two sources", flush=True)
    shapes = {"16 luma": (0, yb[:16].contiguous()), "1 luma": (0, yb[:1].contiguous()),
              "2 chroma": (1, cb[:2].contiguous()), "128 luma": (0, yb),
              "256 chroma": (1, cb), "U, V 1 + 1": (1, (ub[:1], vb[:1])),
              "U, V 8 + 8": (1, (ub[:8], vb[:8])), "U, V 63 + 65": (1, (ub[:63], vb[:65])),
              "U, V 128 + 128": (1, (ub, vb))}
    if args.shapes:
        shapes = {k: shapes[k] for k in args.shapes}
    order = list(variants.items())

    def sampler(var, x, plane, reps):
        """A function returning reps samples of a variant's device ms per
        call: under 100 frames each a replay of 20 calls captured in a CUDA
        graph, else one call."""
        run(var, x, plane)
        if sources.frames(sources.as_sources(x)) >= 100:
            return lambda: cuda_times(lambda: run(var, x, plane), reps)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                run(var, x, plane)
        graph.replay()
        return lambda: [t / 20 for t in cuda_times(graph.replay, reps)]

    for shape, (plane, x) in shapes.items():
        reps = 3 if sources.frames(sources.as_sources(x)) >= 100 else 10
        samplers = {name: sampler(var, x, plane, reps) for name, var in order}
        times = {k: [] for k in variants}
        for rnd in range(4):
            for name, _ in (order if rnd % 2 == 0 else order[::-1]):
                times[name] += samplers[name]()
        del samplers
        print(json.dumps({"shape": shape, "card": smi, "n": 4 * reps,
                          "median_ms": {k: statistics.median(v) for k, v in times.items()}}),
              flush=True)
    for shape in ("1 luma", "128 luma", "256 chroma"):
        if shape not in shapes:
            continue
        plane, x = shapes[shape]
        per_launch = {}
        for name, var in order:
            per_launch[name] = []
            full = tables[var[1]]
            for g in full[plane].groups:
                tables[var[1]] = tuple(dataclasses.replace(t, groups=(g,)) if i == plane else t
                                       for i, t in enumerate(full))
                ts = sampler(var, x, plane, 5)()
                per_launch[name].append((g[1], statistics.median(ts)))
            tables[var[1]] = full
        print(json.dumps({"shape": f"{shape}, each plan range alone: (tiles, median ms)",
                          "card": smi, "n": 5, "launches": per_launch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
