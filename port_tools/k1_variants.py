"""Time variants of K1 (``csrc/blur.cu``) against each other, in turns.

    python3 port_tools/k1_variants.py [--min-blocks 3 4] [--stages 2 3 4]
        [--budget-kb 40 54] [--parts 1 5 9] [--cols 8 16] [--copy]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Each variant changes one choice of the shipping build and launch (the
package's own constants), which is always timed beside them:

* ``--min-blocks``: K1 built with ``kMinBlocks`` at y radius 1 set to N
  in a rewritten copy of its source (the resident CTAs per SM its
  registers must allow; ptxas's lines are printed);
* ``--stages``: the ring's depth (its slab height then follows from the
  budget, ``ops.blur.slab_rows``);
* ``--budget-kb``: a CTA's ring budget (``ops.blur.SMEM_CTA``), so the
  slab height;
* ``--parts``: N parts per tile at every shape (the launch's ``parts``;
  by default ``ops.blur.launch_parts`` picks them by batch);
* ``--cols``: N adjacent columns per thread at every shape (the launch's
  ``cols``; by default ``ops.blur.thread_cols`` picks 8 or 16 by batch);
* ``--copy``: every stage filled by the producer warp's loads
  (``ops.blur.COPY_WARP``) where the shipping launch fills it by TMA.

Every variant is first checked against the shipping launch on two luma
frames (same bytes), then all are timed in alternating order over four
rounds at the shapes of the flagship's paths: 16, 1 and 128 luma frames,
a chroma pair and 256 chroma planes, each call's device time as a
replayed CUDA graph of 20 calls (``chip_smoke.graph_ms``).  Prints one
JSON line of medians (ms) per shape, with the card's name and power
limit.  The builds go to ``transform360_tpu_torch/build/`` (gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-blocks", type=int, nargs="+", default=[])
    ap.add_argument("--stages", type=int, nargs="+", default=[])
    ap.add_argument("--budget-kb", type=int, nargs="+", default=[])
    ap.add_argument("--parts", type=int, nargs="+", default=[])
    ap.add_argument("--cols", type=int, nargs="+", default=[])
    ap.add_argument("--copy", action="store_true")
    args = ap.parse_args()

    import torch

    import transform360_tpu_torch as P
    from chip_smoke import FLAGSHIP, batch_of, graph_ms, video_like_planes
    from transform360_tpu_torch.ops import _build, blur

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    shipping = blur.KERNEL.library()
    src = (_build.CSRC / "blur.cu").read_text()
    mb_line = "constexpr int kMinBlocks = RY == 1 ? 4 : 2;"
    if args.min_blocks and src.count(mb_line) != 1:
        raise SystemExit(f"FAIL {mb_line!r} is not in blur.cu once")
    libs = {}
    for mb in args.min_blocks:
        label = f"min_blocks {mb}"
        text = src.replace(mb_line, f"constexpr int kMinBlocks = RY == 1 ? {mb} : 2;")
        path = _build._build("blur", (), text, label=label)
        libs[label] = blur.KERNEL.bind(ctypes.CDLL(str(path)))
        for line in _build.BUILD_LOG.get(f"blur {label}", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"{label}: {line.strip()}", flush=True)

    plan = P.open_filter(FLAGSHIP, 3840, 2160, device="cuda").plan
    tabs = tuple(pp.tables("cuda").blur for pp in (plan.luma, plan.chroma))
    y, u, v = video_like_planes(3840, 2160)
    yb, ub, vb = batch_of(y, 128), batch_of(u, 128), batch_of(v, 128)
    cb = torch.cat([ub, vb])
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    # label -> (lib, stages, ring budget, parts per tile, columns per thread
    # (0: by batch), copy (-1: by the plane))
    base = (shipping, blur.STAGES, blur.SMEM_CTA, 0, 0, -1)
    variants = {"shipping": base}
    variants.update({k: (lib,) + base[1:] for k, lib in libs.items()})
    variants.update({f"stages {n}": (shipping, n) + base[2:] for n in args.stages})
    variants.update({f"budget {kb} KB": (shipping, base[1], kb * 1024) + base[3:]
                     for kb in args.budget_kb})
    variants.update({f"parts {n}": base[:3] + (n,) + base[4:] for n in args.parts})
    variants.update({f"cols {n}": base[:4] + (n, -1) for n in args.cols})
    if args.copy:
        variants["producer warp's loads"] = base[:5] + (blur.COPY_WARP,)

    def tables(bt, stages, budget):
        return dataclasses.replace(bt, slab=blur.slab_rows(bt.pitch, bt.ring_ry, stages, budget))

    launches = {}  # (variant, plane, B) -> (lib, tables, stages, parts, cols, ctas, copy)

    def run(name, plane, x, out=None):
        key = (name, plane, x.shape[0])
        if key not in launches:  # set up outside any capture
            lib, stages, budget, parts, cols, copy = variants[name]
            bt = tables(tabs[plane], stages, budget)
            cols = cols or blur.launch_cols(lib, bt, x.shape[0], stages)
            resident = blur.kernel_attrs(bt, stages, lib, cols)["ctas_per_sm"] * sms
            parts = parts or blur.launch_parts(bt, x.shape[0], resident)
            launches[key] = (lib, bt, stages, parts, cols,
                             min(resident, bt.tiles.shape[0] * x.shape[0] * parts), copy)
        lib, bt, stages, parts, cols, ctas, copy = launches[key]
        out = torch.empty_like(x) if out is None else out
        blur.launch(lib, bt, x, out, torch.cuda.current_stream().cuda_stream, copy=copy,
                     stages=stages, parts=parts, ctas=ctas, cols=cols)
        return out

    for name, var in variants.items():
        bt = tables(tabs[0], var[1], var[2])
        print(f"{name}: slab {bt.slab} rows, "
              f"{[blur.kernel_attrs(bt, var[1], var[0], v) for v in (8, 16)]}", flush=True)
    want = run("shipping", 0, yb[:2].contiguous())
    for name in variants:
        if not torch.equal(run(name, 0, yb[:2].contiguous()), want):
            raise SystemExit(f"FAIL variant {name} differs from the shipping launch")
    shapes = {"16 luma": (0, yb[:16].contiguous()), "1 luma": (0, yb[:1].contiguous()),
              "2 chroma": (1, cb[:2].contiguous()), "128 luma": (0, yb), "256 chroma": (1, cb)}
    for shape, (plane, x) in shapes.items():
        times = {k: [] for k in variants}
        order = list(variants)
        out = torch.empty_like(x)  # one output for every timed call
        for rnd in range(4):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                times[name].append(graph_ms(lambda: run(name, plane, x, out), 20,
                                            3 if x.shape[0] >= 100 else 10))
        print(json.dumps({"shape": shape, "card": smi, "n": 4,
                          "median_ms": {k: statistics.median(v) for k, v in times.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
