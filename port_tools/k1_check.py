"""Build K1, print its SASS counts, hold it against ``blur_plain``, and time it.

    python3 port_tools/k1_check.py [--quick]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Builds ``csrc/blur.cu`` (and its probe builds at the flagship's x radii,
``chip_smoke.k1_probe_builds``) and prints ptxas's registers and spills, the
SASS counts of each instantiation (``chip_smoke.k1_sass``), the row
loop's instructions per output pixel by pipe (``chip_smoke.loop_counts``)
and each flagship plan's ring, registers and resident CTAs per SM.  Then
K1 against ``blur_plain`` (0 LSB): every raster of tests/test_torch_cuda.py
(both planes, batch 5), tiles at all four plane edges with rx 6 at 8 and
16 bits with an unaligned base, every launch variant (copy, stages,
parts, grid, columns per thread) on the half-size flagship's luma, the flagship's luma and
stacked chroma at batch 1, 2 and 7 with the TF32 switches on and off, its
10-bit planes,
and K1 in a captured CUDA graph.  ``--quick`` stops there.  Then K1
alone at the flagship's shapes (16, 1 and 128 luma frames, a chroma pair,
256 chroma planes): device ms per call as a replayed CUDA graph of 20
calls, and by CUDA events around one call.  Exits 1 if any pixel
differs.  A new kernel's first short check, before ``chip_smoke.py``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import torch

    import transform360_tpu_torch as P
    from chip_smoke import (FLAGSHIP, K1_PROBE_RX, PIPES, batch_of, cuda_times, graph_ms,
                            k1_probe_builds, k1_probe_counts, k1_sass, video_like_planes)
    from transform360_tpu_torch.filtering import blur_plain
    from transform360_tpu_torch.ops import _build, blur
    from transform360_tpu_torch.sampling import round_px

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_cuda import CASES, EDGE_CASES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _build.build_all(["blur"])
    probes = k1_probe_builds(_build.CSRC)
    print(f"built in {time.perf_counter() - t0:.1f} s: {_build.BUILD_SECONDS}", flush=True)
    for line in _build.BUILD_LOG.get("blur", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas", line.strip())
    for k, c in sorted(k1_sass(_build._build("blur")).items()):
        print(f"  SASS {k}: {c}")
    for r in K1_PROBE_RX:
        for (sname, v), c in k1_probe_counts(probes[r]).items():
            print(f"  row loop {sname} {v} columns rx {r}: {c['total']:.3f} instructions per output pixel ("
                  + ", ".join(f"{p} {c[p]:.3f}" for p in PIPES) + "); "
                  + json.dumps({o: round(v, 3) for o, v in c.items() if o.isupper()}), flush=True)

    bad = 0
    g = torch.Generator(device="cuda").manual_seed(0)

    def check(bt, x, what, mx=255):
        nonlocal bad
        got = blur.blur_px(bt, x, mx)
        n = 0
        for f0 in range(0, x.shape[0], 32):
            want = round_px(blur_plain(bt.plan, x[f0:f0 + 32].float()), mx, x.dtype)
            n += int((got[f0:f0 + 32] != want).sum())
        torch.cuda.synchronize()
        bad += n > 0
        print(f"K1 {what}: {n} px differ", flush=True)

    def rand(shape, mx=255):
        x = torch.randint(0, mx + 1, shape, dtype=torch.int32, device="cuda", generator=g)
        return x.to(torch.uint8 if mx == 255 else torch.uint16)

    for name, (cfg, iw, ih, ow, oh) in {**CASES, **EDGE_CASES}.items():
        plan = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p")
        for pp in (plan.luma, plan.chroma):
            t = pp.tables("cuda")
            if t.blur is not None:
                check(t.blur, rand((5, pp.in_h, pp.in_w)),
                      f"{name} {pp.in_w}x{pp.in_h} ring_ry {t.blur.ring_ry}")
    for name in EDGE_CASES:
        cfg, iw, ih, ow, oh = EDGE_CASES[name]
        t = P.build_plan(cfg, iw, ih, ow, oh, "gray16le").luma.tables("cuda")
        x = rand((4, ih, iw), 65535)
        x[1] = 65535
        check(t.blur, x, f"{name} 16-bit", 65535)
        buf = torch.zeros(4 * ih * iw + 1, dtype=torch.uint16, device="cuda")
        xu = buf[1:].view(4, ih, iw)
        xu.copy_(x)
        check(t.blur, xu, f"{name} 16-bit, unaligned base", 65535)

    # the flagship at half size: 1920x1080 luma, TMA-staged edge tiles
    half = FLAGSHIP.replace("=512", "=256")
    t = P.open_filter(half, 1920, 1080, device="cuda").plan.luma.tables("cuda")
    x = rand((7, 1080, 1920))
    want = round_px(blur_plain(t.blur.plan, x.float()), 255, torch.uint8)
    lib, stream = blur.KERNEL.library(), torch.cuda.current_stream().cuda_stream
    n_items = t.blur.tiles.shape[0] * 7
    for copy in (blur.COPY_TMA, blur.COPY_WARP):
        for stages in (2, 3, 8):
            for parts in (1, 2, 5):
                for ctas in (1, 0, n_items * parts):
                    for cols in (8, 16):
                        out = torch.zeros_like(want)
                        blur.launch(lib, t.blur, x, out, stream, copy=copy, stages=stages,
                                    parts=parts, ctas=ctas, cols=cols)
                        torch.cuda.synchronize()
                        if not torch.equal(out, want):
                            bad += 1
                            print(f"K1 variant copy {copy} stages {stages} parts {parts} ctas "
                                  f"{ctas} cols {cols}: {int((out != want).sum())} px differ",
                                  flush=True)
    print("K1 launch variants done", flush=True)

    eng = P.open_filter(FLAGSHIP, 3840, 2160, device="cuda")
    deep = P.open_filter(FLAGSHIP, 3840, 2160, pix_fmt="yuv420p10le", device="cuda")
    for pname, pp in (("luma", eng.plan.luma), ("chroma", eng.plan.chroma)):
        t = pp.tables("cuda")
        print(f"flagship {pname}: {t.blur.tiles.shape[0]} tiles, ring {blur.STAGES} x "
              f"{t.blur.slab} rows x {t.blur.pitch} B; "
              f"{[blur.kernel_attrs(t.blur, cols=v) for v in (8, 16)]}", flush=True)
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for b in (1, 2, 7):
                check(t.blur, rand((b, pp.in_h, pp.in_w)),
                      f"flagship {pname} b={b} tf32={tf32}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for pname, pp in (("luma", deep.plan.luma), ("chroma", deep.plan.chroma)):
        t = pp.tables("cuda")
        print(f"10-bit {pname}: {blur.kernel_attrs(t.blur)}", flush=True)
        check(t.blur, rand((3, pp.in_h, pp.in_w), 1023), f"10-bit flagship {pname} b=3", 1023)
    t = eng.plan.luma.tables("cuda")
    static = rand((2, 2160, 3840))
    blur.blur_px(t.blur, static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = blur.blur_px(t.blur, static)
    static.copy_(rand(static.shape))
    graph.replay()
    torch.cuda.synchronize()
    n = int((out != round_px(blur_plain(t.blur.plan, static.float()), 255, torch.uint8)).sum())
    bad += n > 0
    print(f"K1 in a captured graph: {n} px differ", flush=True)
    del graph, out, static
    if args.quick:
        print("BAD", bad)
        return 1 if bad else 0

    y, u, v = video_like_planes(3840, 2160)
    yb, ub, vb = batch_of(y, 128), batch_of(u, 128), batch_of(v, 128)
    cb = torch.cat([ub, vb])
    lt, ct = eng.plan.luma.tables("cuda").blur, eng.plan.chroma.tables("cuda").blur
    res = {"card": smi}
    for shape, bt, x in (("16 luma", lt, yb[:16].contiguous()), ("1 luma", lt, yb[:1].contiguous()),
                         ("2 chroma", ct, cb[:2].contiguous()), ("128 luma", lt, yb),
                         ("256 chroma", ct, cb)):
        fn = lambda: blur.blur_px(bt, x)
        cuda_times(fn, 3)
        res[shape] = {"events": statistics.median(cuda_times(fn, 20)),
                      "graph": graph_ms(fn, 20, 10 if x.shape[0] >= 100 else 20)}
        print(f"K1 {shape}: {res[shape]}", flush=True)
    print(json.dumps(res))
    print("BAD", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
