"""Build K1 and K3, hold them against their plain versions, and time K1.

    python3 port_tools/k1_check.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
K1 against ``blur_plain`` and K3 against ``remap_plain`` on every case of
tests/test_torch_cuda.py (both planes; K3 at batch 1 and 5), K1 over an
odd number of frames with 8-frame CTA loops, K1 on the flagship planes
with the TF32 switches on and off, K3 on the flagship luma at batch 128
and chroma at 256; then K1 alone by CUDA events on 16 luma frames, one
luma frame and one chroma pair.  Exits 1 if any pixel differs.  A short
first check of a kernel, before ``chip_smoke.py`` measures it."""
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, Layout, StereoFormat, TransformConfig
from transform360_tpu_torch.filtering import blur_plain
from transform360_tpu_torch.ops import _build, blur, window
from transform360_tpu_torch.sampling import remap_plain, round_u8

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(smi, torch.__version__, torch.version.cuda, flush=True)
t0 = time.perf_counter()
_build.build_all(["blur", "window"])
print("built", time.perf_counter() - t0, _build.BUILD_SECONDS, flush=True)
for name, log in _build.BUILD_LOG.items():
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas", name, line.strip())

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
CASES = {
    "cubic-cubemap": (TransformConfig(**MONO), 512, 256, 192, 128),
    "linear-barrel": (TransformConfig(output_layout=Layout.BARREL, interpolation_alg=Interpolation.LINEAR, **MONO), 256, 128, 160, 64),
    "lanczos4-barrel": (TransformConfig(output_layout=Layout.BARREL_SPLIT, interpolation_alg=Interpolation.LANCZOS4, **MONO), 256, 128, 192, 64),
    "nearest-barrel": (TransformConfig(output_layout=Layout.BARREL, interpolation_alg=Interpolation.NEAREST, **MONO), 256, 128, 160, 64),
    "lanczos4-eac": (TransformConfig(output_layout=Layout.EAC_32, interpolation_alg=Interpolation.LANCZOS4, **MONO), 256, 128, 96, 64),
    "tb-odd": (TransformConfig(input_stereo_format=StereoFormat.TB, output_stereo_format=StereoFormat.TB), 256, 161, 96, 128),
    "lr-odd": (TransformConfig(input_stereo_format=StereoFormat.LR, output_stereo_format=StereoFormat.LR), 513, 80, 192, 64),
    "adaptive-32x15": (TransformConfig(num_vertical_segments=32, num_horizontal_segments=15, **MONO), 960, 480, 240, 160),
    "adaptive-32x15-small": (TransformConfig(num_vertical_segments=32, num_horizontal_segments=15, **MONO), 512, 128, 96, 64),
    "offcenter-3seg": (TransformConfig(num_horizontal_segments=3, fixed_cube_offcenter_z=0.5, **MONO), 256, 80, 96, 64),
    "big-ry-direct": (TransformConfig(min_kernel_half_height=5, **MONO), 256, 80, 96, 64),
}
g = torch.Generator(device="cuda").manual_seed(0)
bad = 0
for name, (cfg, iw, ih, ow, oh) in CASES.items():
    plan = P.build_plan(cfg, iw, ih, ow, oh, "yuv420p")
    for pp in (plan.luma, plan.chroma):
        t = pp.tables("cuda")
        x = torch.randint(0, 256, (5, pp.in_h, pp.in_w), dtype=torch.uint8, device="cuda", generator=g)
        if t.blur is not None:
            got = blur.blur_px(t.blur, x)
            want = round_u8(blur_plain(t.blur.plan, x.float()))
            torch.cuda.synchronize()
            d = int((got.int() - want.int()).abs().max())
            n = int((got != want).sum())
            bad += n > 0
            print(f"K1 {name} {pp.in_w}x{pp.in_h} ring_ry {t.blur.ring_ry}: max {d} LSB, {n} px differ", flush=True)
        wt = pp.window_tables("cuda")
        for B in (1, 5):
            got = window.remap_window_px(wt, x[:B].contiguous())
            want = round_u8(remap_plain(t.remap, x[:B]))
            torch.cuda.synchronize()
            n = int((got != want).sum())
            bad += n > 0
            print(f"K3 {name} {pp.in_w}x{pp.in_h} B={B}: {n} px differ", flush=True)

# frame loops of a CTA: odd remainder, same bytes as one frame at a time
cfg, iw, ih, ow, oh = CASES["cubic-cubemap"]
t = P.build_plan(cfg, iw, ih, ow, oh, "gray").luma.tables("cuda")
x = torch.randint(0, 256, (19, ih, iw), dtype=torch.uint8, device="cuda", generator=g)
one = torch.cat([blur.blur_px(t.blur, x[i:i + 1].contiguous()) for i in range(19)])
blur.CTAS_TARGET = 1
print("fpc", blur.frames_per_cta(19, t.blur.tiles.shape[0]))
many = blur.blur_px(t.blur, x)
blur.CTAS_TARGET = 4096
torch.cuda.synchronize()
print("frame loops equal:", torch.equal(one, many), flush=True)
bad += not torch.equal(one, many)

# flagship
FLAG = "cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:input_stereo_format=mono"
eng = P.open_filter(FLAG, 3840, 2160, device="cuda")
plan = eng.plan
for tf32 in (True, False):
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    for pp, B in ((plan.luma, 4), (plan.chroma, 8)):
        t = pp.tables("cuda")
        x = torch.randint(0, 256, (B, pp.in_h, pp.in_w), dtype=torch.uint8, device="cuda", generator=g)
        got = blur.blur_px(t.blur, x)
        want = round_u8(blur_plain(t.blur.plan, x.float()))
        torch.cuda.synchronize()
        n = int((got != want).sum())
        bad += n > 0
        print(f"K1 flagship {pp.in_w}x{pp.in_h} tf32={tf32}: {n} px differ", flush=True)
for pp, B in ((plan.luma, 128), (plan.chroma, 256)):
    t = pp.tables("cuda")
    x = torch.randint(0, 256, (B, pp.in_h, pp.in_w), dtype=torch.uint8, device="cuda", generator=g)
    got = window.remap_window_px(pp.window_tables("cuda"), x)
    for i in range(0, B, 32):
        want = round_u8(remap_plain(t.remap, x[i:i + 32]))
        n = int((got[i:i + 32] != want).sum())
        bad += n > 0
    print(f"K3 flagship {pp.in_w}x{pp.in_h} B={B}: last chunk {n} px differ", flush=True)
    del x, got

# K1 time per 16 luma frames, quick
t = plan.luma.tables("cuda")
x = torch.randint(0, 256, (16, 2160, 3840), dtype=torch.uint8, device="cuda", generator=g)
for _ in range(3):
    blur.blur_px(t.blur, x)
ts = []
for _ in range(30):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record(); blur.blur_px(t.blur, x); b.record(); b.synchronize()
    ts.append(a.elapsed_time(b))
print(f"K1 16 luma frames: median {statistics.median(ts):.4f} ms min {min(ts):.4f}  ({smi})")
c = plan.chroma.tables("cuda")
x1 = x[:1].contiguous()
xc = torch.randint(0, 256, (2, 1080, 1920), dtype=torch.uint8, device="cuda", generator=g)
for nm, fn in (("luma b1", lambda: blur.blur_px(t.blur, x1)), ("chroma b2", lambda: blur.blur_px(c.blur, xc))):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(50):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    print(f"K1 {nm}: median {statistics.median(ts):.4f} ms")
print("BAD", bad)
sys.exit(1 if bad else 0)
