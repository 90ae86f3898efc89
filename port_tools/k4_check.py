"""Build K4, hold it against its plain version, and time it.

    python3 port_tools/k4_check.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Builds ``csrc/area.cu`` and prints ptxas's registers and spills and each
instantiation's resident CTAs per SM at the flagship's 2x2 plan; holds K4
against ``area_plain`` (0 LSB) at uint8 and uint16 on the 2x2 flagship's
luma (3072x2048 -> 1536x1024, batch 128) and stacked chroma (1536x1024
-> 768x512, batch 256), with the TF32 switches on and off, and at 4x4,
1.5x2, the upscale branch and 8x (direct tiles) at batch 7; then times,
by CUDA events, K4, ``area_plain`` and ``avg_pool2d`` on a float32 copy
at the flagship's luma at batch 16 and 128, beside K4's byte bound; then
K4 alone with 4, 8, 16 and 32 frames per CTA (``ops.area.CTA_FRAMES``)
on the flagship's luma and chroma.  Exits 1 if any pixel differs.  A short first check of
the kernel, before ``chip_smoke.py`` measures it."""
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from chip_smoke import HBM_BYTES_PER_MS, cuda_times
from transform360_tpu_torch.ops import _build, area
from transform360_tpu_torch.sampling import AreaTables, DeviceArea

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(smi, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
_build.build_all(["area"])
print("built", time.perf_counter() - t0, _build.BUILD_SECONDS, flush=True)
for line in _build.BUILD_LOG["area"].splitlines():
    if "registers" in line or "spill" in line:
        print("  ptxas area", line.strip())

SHAPES = {  # (scaled w, h), (out w, h), batch
    "flagship luma 2x2": ((3072, 2048), (1536, 1024), 128),
    "flagship chroma 2x2": ((1536, 1024), (768, 512), 256),
    "4x4": ((1536, 1024), (384, 256), 7),
    "1.5x2": ((2304, 2048), (1536, 1024), 7),
    "upscale": ((480, 320), (1536, 1024), 7),
    "8x direct": ((3072, 2048), (384, 256), 7),
}
g = torch.Generator(device="cuda").manual_seed(0)
bad = 0
das = {}
for name, ((sw, sh), (ow, oh), b) in SHAPES.items():
    da = das[name] = DeviceArea.from_tables(AreaTables.build(sw, sh, ow, oh), "cuda")
    for sb, mx in ((1, 255), (2, 1023)):
        at = area.kernel_attrs(da, sb)
        x = torch.randint(0, 256 if sb == 1 else 65536, (b, sh, sw), dtype=torch.int32,
                          device="cuda", generator=g).to(torch.uint8 if sb == 1 else torch.uint16)
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
            print(f"K4 {name} u{8 * sb} b={b} tf32={tf32}: max |diff| {d} LSB; "
                  f"{int((da.tiles[:, 7] == 0).sum())} direct of {da.tiles.shape[0]} tiles; "
                  f"{at}", flush=True)
        del x, got
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

da = das["flagship luma 2x2"]
for b in (16, 128):
    x = torch.randint(0, 256, (b, 2048, 3072), dtype=torch.uint8, device="cuda", generator=g)
    xf = x.float()
    row = {}
    for what, fn in (("K4", lambda: area.area_px(da, x)),
                     ("area_plain", lambda: area.area_plain(da, x)),
                     ("avg_pool2d f32", lambda: torch.nn.functional.avg_pool2d(xf, 2))):
        cuda_times(fn, 2)
        row[what] = statistics.median(cuda_times(fn, 10))
    bnd = b * (3072 * 2048 + 1536 * 1024) / HBM_BYTES_PER_MS
    print(f"b={b} flagship luma 2x2: " + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
          + f"; byte bound {bnd:.4f} ms, K4 at {bnd / row['K4']:.1%} of it  ({smi})", flush=True)
    del x, xf

for (pname, b, dt), da in ((("luma", 128, torch.uint8), das["flagship luma 2x2"]),
                           (("chroma", 256, torch.uint8), das["flagship chroma 2x2"]),
                           (("luma", 128, torch.uint16), das["flagship luma 2x2"])):
    x = torch.randint(0, 256, (b, da.in_h, da.in_w), dtype=torch.int32, device="cuda",
                      generator=g).to(dt)
    want = area.area_px(da, x)
    out = torch.empty_like(want)
    stream = torch.cuda.current_stream().cuda_stream
    row = []
    for fr in (4, 8, 16, 32):
        fn = lambda: area.launch(area._lib(), da, x, out, fr, stream)
        fn()
        torch.cuda.synchronize()
        bad += not torch.equal(out.int(), want.int())
        cuda_times(fn, 2)
        row.append(f"{fr} {statistics.median(cuda_times(fn, 10)):.4f}")
    print(f"K4 {pname} b={b} {dt}: frames per CTA, ms: " + ", ".join(row), flush=True)
    del x, want, out
sys.exit(1 if bad else 0)
