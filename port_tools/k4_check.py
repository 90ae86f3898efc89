"""Build K4, hold it against its plain version, and time its variants.

    python3 port_tools/k4_check.py [--parent DIR] [--quick]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Builds ``csrc/area.cu`` and prints ptxas's registers and spills; holds K4
against ``area_plain`` (0 LSB) at uint8 and uint16 on the 2x2 flagship's
luma (3072x2048 -> 1536x1024, batch 1, 128 and 129) and stacked chroma
(1536x1024 -> 768x512, batch 256), with the TF32 switches on and off,
and at 4x4, 1.5x2, the upscale branch and 8x (direct tiles) at batch 7,
printing each plan's modes, stage boxes, registers, resident CTAs per SM
and ring stages.  ``--quick`` stops there.

Then the variant table on the flagship's luma at 1 and 16 frames (device
time of a replayed CUDA graph of 20 calls) and 128 frames (CUDA events),
uint8 and uint16 (10-bit samples): each variant's median ms and its share
of the byte bound (``chip_smoke.area_bound``), with its registers, CTAs
per SM and ring stages.  The variants are launches of the shipping
kernel with other choices (``ops.area.launch``'s keywords: the grid, the
copy, the ring's depth, the packed path), and builds of the same source
with another ``T360_AREA_MIN_BLOCKS`` (the resident CTAs its registers
must allow; the source's defaults are the shipping build):

* ``item grid``: one CTA per run of up to 16 frames of one tile, while
  4096 CTAs remain (the grid of the double-buffered kernel this design
  replaced), two stages, cp.async by the producer warp, per-column taps;
* ``item grid + packed``: the same with packed taps;
* ``persistent, cp.async``, ``persistent, TMA``: a persistent grid with
  per-column taps, the ring filled by cp.async or TMA;
* ``persistent, TMA, packed``: the shipping design, at ring depths 2, 3,
  4 and 6, at ``ops.area.RING`` stages in each other build, and with the
  other walk of the items (``ops.area.work_list``'s order 1).

Then ``area_px`` on a 3000x2000 -> 1500x1000 plan, whose uint8 rows are
not 16-byte aligned (staged by every thread) and whose uint16 rows are
not whole 128-byte lines (walk order 1); and each copy (TMA, cp.async,
every thread) at each walk on the flagship's luma (16 and 128 frames),
its stacked chroma (32 and 256 planes) and that plan.  ``--parent DIR``
also times ``area_px`` of the port in DIR (another commit's
``transform360_tpu_torch/``, for instance the parent's) on the luma and
the 3000x2000 plans, in its own process.  Exits 1 if any pixel differs.
"""
import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LUMA = (3072, 2048, 1536, 1024)  # the 2x2 flagship's luma: scaled w, h -> out w, h
CHROMA = (1536, 1024, 768, 512)  # its chroma, U and V stacked: twice the frames
RAGGED = (3000, 2000, 1500, 1000)  # 2x2 whose uint8 rows are not 16-byte aligned
BATCHES = (1, 16, 128)


def make_input(torch, b, sb, g, sizes=LUMA):
    hi = 256 if sb == 1 else 1024
    x = torch.randint(0, hi, (b, sizes[1], sizes[0]), dtype=torch.int32, device="cuda",
                      generator=g)
    return x.to(torch.uint8 if sb == 1 else torch.uint16)


def time_call(fn, b):
    """Device ms per call: a replayed CUDA graph of 20 calls up to 16
    frames (events around one short call also read the host's issue
    time), else the median by CUDA events."""
    from chip_smoke import cuda_times, graph_ms

    if b <= 16:
        return graph_ms(fn, 20, 20)
    fn()
    cuda_times(fn, 3)
    return statistics.median(cuda_times(fn, 10))


def area_times(sizes):
    """{"u8 b1": ms, ...}: this PYTHONPATH's ``area_px`` on a ``sizes``
    plan at the table's batches, uint8 and uint16."""
    import torch

    from transform360_tpu_torch.ops import area
    from transform360_tpu_torch.sampling import AreaTables, DeviceArea

    da = DeviceArea.from_tables(AreaTables.build(*sizes), "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for sb, mx in ((1, 255), (2, 1023)):
        for b in BATCHES:
            x = make_input(torch, b, sb, g, sizes)
            res[f"u{8 * sb} b{b}"] = time_call(lambda: area.area_px(da, x, mx), b)
            del x
    return res


def child_times() -> None:
    """This PYTHONPATH's ``area_px`` on the flagship's luma and on the
    ragged plan: one JSON line."""
    sys.path.append(ROOT)
    print(json.dumps({"luma": area_times(LUMA), "ragged": area_times(RAGGED)}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--child-times", action="store_true")
    args = ap.parse_args()
    if args.child_times:
        child_times()
        return 0

    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import area_bound, k4_sass
    from transform360_tpu_torch.ops import _build, area
    from transform360_tpu_torch.sampling import AreaTables, DeviceArea

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    default_mb = int(re.search(r"#define T360_AREA_MIN_BLOCKS (\d+)",
                               (_build.CSRC / "area.cu").read_text()).group(1))
    ship = f"min{default_mb}"  # the shipping build: the source's defaults
    builds = {ship: []}
    if not args.quick:
        builds.update({f"min{mb}": [f"-DT360_AREA_MIN_BLOCKS={mb}"] for mb in (2, 3, 4, 6)
                       if mb != default_mb})

    def build(label):
        if label == ship:  # built first
            return (area.KERNEL.library(), _build.BUILD_LOG.get("area", ""),
                    _build.BUILD_SECONDS.get("area", 0.0))
        d = _build.BUILD_DIR / "variants" / f"k4_{label.replace(' ', '_')}"
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        shutil.copy(_build.CSRC / "area.cu", d / "area.cu")
        lib_path = d / "libarea.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *builds[label], "-I", str(d), "-o",
               str(lib_path), str(d / "area.cu")]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{res.stderr}")
        import ctypes

        lib = area.KERNEL.bind(ctypes.CDLL(str(lib_path)))
        return lib, res.stdout + res.stderr, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(builds)) as ex:
        libs = dict(zip(builds, ex.map(build, builds)))
    for label, (lib, log, secs) in libs.items():
        print(f"built area.cu as {label} {builds[label]} in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {label}", line.strip())
        for (sname, k), c in sorted(k4_sass(lib._name).items()):
            print(f"  SASS {label} {sname} taps {k}: {c}", flush=True)

    shapes = {  # (scaled w, h), (out w, h), batches
        "flagship luma 2x2": ((3072, 2048), (1536, 1024), (1, 128, 129)),
        "flagship chroma 2x2": ((1536, 1024), (768, 512), (256,)),
        "4x4": ((1536, 1024), (384, 256), (7,)),
        "1.5x2": ((2304, 2048), (1536, 1024), (7,)),
        "upscale": ((480, 320), (1536, 1024), (7,)),
        "8x direct": ((3072, 2048), (384, 256), (7,)),
    }
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for name, ((sw, sh), (ow, oh), batches) in shapes.items():
        da = DeviceArea.from_tables(AreaTables.build(sw, sh, ow, oh), "cuda")
        modes = torch.bincount(da.tiles[:, 7].long(), minlength=3).tolist()
        for sb, mx in ((1, 255), (2, 1023)):
            at = area.kernel_attrs(da, sb)
            for b in batches:
                x = torch.randint(0, 256 if sb == 1 else 65536, (b, sh, sw), dtype=torch.int32,
                                  device="cuda", generator=g)
                x = x.to(torch.uint8 if sb == 1 else torch.uint16)
                for tf32 in (True, False):
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    got = area.area_px(da, x, mx)
                    torch.cuda.synchronize()
                    d = 0
                    for f0 in range(0, b, 32):
                        want = area.area_plain(da, x[f0:f0 + 32], mx)
                        d = max(d, int((got[f0:f0 + 32].int() - want.int()).abs().max()))
                    bad += d > 0
                    print(f"K4 {name} u{8 * sb} b={b} tf32={tf32}: max |diff| {d} LSB; tiles "
                          f"direct/staged/packed {modes}, boxes {da.box}; {at}", flush=True)
                del x, got
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.quick:
        return 1 if bad else 0

    # -- the variant table ------------------------------------------------
    da = DeviceArea.from_tables(AreaTables.build(*LUMA), "cuda")
    rda = DeviceArea.from_tables(AreaTables.build(*RAGGED), "cuda")
    n_tiles = da.tiles.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def item_grid(B):  # up to 16 frames of a tile per CTA while 4096 CTAs remain
        f = max(1, min(16, B * n_tiles // 4096))
        return -(-n_tiles * B // f)

    variants = [  # label, build, launch keywords, grid (None: persistent)
        ("item grid, cp.async, 2 stages", ship,
         dict(copy=area.COPY_ASYNC, stages=2, packed=False), item_grid),
        ("item grid, cp.async, 2 stages, packed", ship,
         dict(copy=area.COPY_ASYNC, stages=2, packed=True), item_grid),
        ("persistent, cp.async, 4 stages", ship,
         dict(copy=area.COPY_ASYNC, stages=4, packed=False), None),
        ("persistent, TMA, 4 stages", ship, dict(copy=area.COPY_TMA, stages=4, packed=False),
         None),
    ] + [(f"persistent, TMA, {st} stages, packed", label,
          dict(copy=area.COPY_TMA, stages=st, packed=True), None)
         for label in libs for st in (2, 3, 4, 6) if label == ship or st == area.RING] + [
        ("persistent, TMA, 4 stages, packed, walk order 1", ship,
         dict(copy=area.COPY_TMA, stages=4, packed=True, order=1), None)]
    xs = {}
    want = {}
    for sb in (1, 2):
        for b in BATCHES:
            xs[sb, b] = make_input(torch, b, sb, g)
            want[sb, b] = area.area_px(da, xs[sb, b], 255 if sb == 1 else 1023)
    rows = []
    for label, build_label, kw, grid in variants:
        lib = libs[build_label][0]
        row = {"variant": label, "build": build_label}
        for sb in (1, 2):
            at = area.kernel_attrs(da, sb, kw["stages"], lib)
            row[f"u{8 * sb} registers"], row[f"u{8 * sb} ctas_per_sm"] = (
                at["registers"], at["ctas_per_sm"])
            row["stages"] = kw["stages"]
            for b in BATCHES:
                x, mx = xs[sb, b], 255 if sb == 1 else 1023
                out = torch.empty_like(want[sb, b])
                ctas = grid(b) if grid else min(n_tiles * b, at["ctas_per_sm"] * sms)
                fn = lambda: area.launch(lib, da, x, out, torch.cuda.current_stream().cuda_stream,
                                         mx, ctas=ctas, **kw)
                fn()
                torch.cuda.synchronize()
                bad += not torch.equal(out, want[sb, b])
                ms = time_call(fn, b)
                bnd = area_bound(da, b, sb)[0]
                row[f"u{8 * sb} b{b}"] = (ms, bnd / ms)
                del out
        rows.append(row)
        print("variant " + json.dumps(row), flush=True)
    # the ragged plan: its uint8 rows are not 16-byte aligned (every thread
    # stages); its uint16 rows are, but not 128-byte aligned
    rows.append({"variant": f"area_px, {RAGGED[0]}x{RAGGED[1]} plan", **{
        k: (v, area_bound(rda, int(k.split("b")[-1]), 1 if k.startswith("u8") else 2)[0] / v)
        for k, v in area_times(RAGGED).items()}})
    print("variant " + json.dumps(rows[-1]), flush=True)
    # each copy and walk on the three plans (the ragged plan's uint8 rows
    # take only the copy by every thread)
    lib = libs[ship][0]
    cda = DeviceArea.from_tables(AreaTables.build(*CHROMA), "cuda")
    for cname, kw in (("TMA, order 0", dict(copy=area.COPY_TMA, order=0)),
                      ("TMA, order 1", dict(copy=area.COPY_TMA, order=1)),
                      ("cp.async", dict(copy=area.COPY_ASYNC)),
                      ("every thread, order 0", dict(copy=area.COPY_SCALAR, order=0)),
                      ("every thread, order 1", dict(copy=area.COPY_SCALAR, order=1))):
        copy = kw["copy"]
        for pname, d, sizes, batches in (
                ("luma", da, LUMA, BATCHES[1:]), ("stacked chroma", cda, CHROMA, (32, 256)),
                (f"{RAGGED[0]}x{RAGGED[1]}", rda, RAGGED, BATCHES[1:])):
            row = {"variant": f"{pname}, staged by {cname}"}
            for sb in (1, 2):
                if d is rda and sb == 1 and copy != area.COPY_SCALAR:
                    continue
                for b in batches:
                    x = make_input(torch, b, sb, g, sizes)
                    mx = 255 if sb == 1 else 1023
                    want = area.area_px(d, x, mx)
                    out = torch.empty_like(want)
                    fn = lambda: area.launch(lib, d, x, out,
                                             torch.cuda.current_stream().cuda_stream, mx, **kw)
                    fn()
                    torch.cuda.synchronize()
                    bad += not torch.equal(out, want)
                    ms = time_call(fn, b)
                    row[f"u{8 * sb} b{b}"] = (ms, area_bound(d, b, sb)[0] / ms)
                    del x, want, out
            rows.append(row)
            print("variant " + json.dumps(row), flush=True)
    if args.parent:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.parent))
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child-times"], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            print(f"parent: exit {res.returncode}\n{res.stderr[-3000:]}", flush=True)
            bad += 1
        else:
            par = json.loads(res.stdout.strip().splitlines()[-1])
            for key, d, what in (("luma", da, ""),
                                 ("ragged", rda, f", {RAGGED[0]}x{RAGGED[1]} plan")):
                rows.append({"variant": f"area_px of {args.parent}{what}", **{
                    k: (v, area_bound(d, int(k.split("b")[-1]),
                                      1 if k.startswith("u8") else 2)[0] / v)
                    for k, v in par[key].items()}})
                print("variant " + json.dumps(rows[-1]), flush=True)
    print(f"K4 variants on the flagship's 2x2 luma {LUMA[0]}x{LUMA[1]} -> {LUMA[2]}x{LUMA[3]}: "
          f"ms (share of the byte bound) at 1 and 16 frames (graphs) and 128 frames  ({smi})")
    for r in rows:
        cells = []
        for sb in (1, 2):
            cells += [f"u{8 * sb} {k.split('b')[-1]}: {v[0]:.4f} ({v[1]:.1%})"
                      for k, v in r.items() if k.startswith(f"u{8 * sb} b")]
        meta = (f"{r['build']}, {r['u8 registers']}/{r['u16 registers']} regs, "
                f"{r['u8 ctas_per_sm']}/{r['u16 ctas_per_sm']} CTAs/SM, {r['stages']} stages"
                if "stages" in r else "")
        print(f"  {r['variant']:<42} {meta:<60} " + "; ".join(cells), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
