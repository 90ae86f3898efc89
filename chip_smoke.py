#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU,
nvcc and CUDA PyTorch (no jax needed).  Phases, one line each:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build both kernels from ``transform360_tpu_torch/csrc`` with nvcc;
3. K1 (prefilter) against ``blur_plain`` and K2 (remap) against
   ``remap_plain`` on the card, at the flagship's luma and chroma shapes,
   with the TF32 switches on and off (nothing here may depend on them);
4. the main path: ``open_filter(<flagship>, 3840, 2160, device="cuda")
   .transform(y, u, v)`` on 128 video-like frames, with both kernels'
   launch counters reset just before it; its output against the plain
   functions on the same tensors, and a small size against the CPU engine;
5. times with CUDA events after warm-up (medians, with a tail percentile
   and the sample count): each kernel beside its plain version, in turns,
   and the whole flagship step at batch 128.

Bound for kernel vs plain: at most 1 LSB on under 0.5% of the pixels
(the kernels are built to be bit-identical, so 0 is expected).  The
second-to-last line is a JSON object with each kernel's numbers; the last
is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a GPU the script exits non-zero before printing a
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAGSHIP = (
    "cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:"
    "input_stereo_format=mono"
)
IN_W, IN_H = 3840, 2160
BATCH = 128
MAX_WRONG = 0.005  # fraction of pixels allowed to differ, by 1 LSB at most


def say(msg: str) -> None:
    print(msg, flush=True)


def video_like_planes(in_w: int, in_h: int):
    """Smooth, video-like yuv420p planes (the synthetic generator of the
    JAX package's fidelity gate, ``fidelity._video_like_planes``)."""
    import numpy as np

    from transform360_tpu_torch.config import chroma_dims

    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:in_h, 0:in_w]
    y = np.clip(
        128 + 70 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
        + 40 * np.sin((xx + 2 * yy) / 5.0) + rng.normal(0, 6, (in_h, in_w)),
        0, 255,
    ).astype(np.uint8)
    cw, ch = chroma_dims(in_w, in_h)
    u = np.clip(128 + 50 * np.sin(np.mgrid[0:ch, 0:cw][1] / 9.0), 0, 255).astype(np.uint8)
    v = np.clip(128 + 50 * np.cos(np.mgrid[0:ch, 0:cw][0] / 7.0), 0, 255).astype(np.uint8)
    return y, u, v


def batch_of(plane, n: int):
    """n distinct frames on the card: the plane rolled by 7 px per frame."""
    import torch

    base = torch.from_numpy(plane).cuda()
    return torch.stack([torch.roll(base, 7 * k, dims=1) for k in range(n)]).contiguous()


def compare(got, want, what: str) -> int:
    """Max |got - want| in LSB; raises beyond the stated bound."""
    d = (got.int() - want.int()).abs()
    mx = int(d.max())
    frac = float((d > 0).float().mean())
    if mx > 1 or frac >= MAX_WRONG:
        raise SystemExit(
            f"FAIL {what}: max |diff| {mx} LSB, {frac:.6f} of pixels differ "
            f"(bound: <=1 LSB on <{MAX_WRONG})"
        )
    return mx


def cuda_times(fn, reps: int) -> list:
    """Milliseconds of each of reps runs of fn(), by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def pct(xs, q: float) -> float:
    """The q-quantile of xs (nearest rank)."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a GPU is required",
              file=sys.stderr)
        return 2

    from transform360_tpu_torch import open_filter
    from transform360_tpu_torch.filtering import blur_plain
    from transform360_tpu_torch.ops import _build, blur, remap
    from transform360_tpu_torch.sampling import remap_plain, round_u8

    # -- 1. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    say(smi)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library("blur")
    _build.library("remap")
    say(f"[2] built blur.cu + remap.cu for sm_90a in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: {_build.BUILD_SECONDS})")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"    ptxas {name}: {line.strip()}")

    # -- plan (CPU) ------------------------------------------------------
    t0 = time.perf_counter()
    eng = open_filter(FLAGSHIP, IN_W, IN_H, device="cuda")
    plan = eng.plan
    luma_t = plan.luma.tables("cuda")
    chroma_t = plan.chroma.tables("cuda")
    say(f"    plan {IN_W}x{IN_H} -> {plan.out_w}x{plan.out_h} built and moved in "
        f"{time.perf_counter() - t0:.2f} s")

    y, u, v = video_like_planes(IN_W, IN_H)
    err = {"blur": 0, "remap": 0}

    # -- 3. kernels vs plain on the card -----------------------------------
    rng = torch.Generator(device="cuda").manual_seed(0)
    cases = (("luma", luma_t, plan.luma, 4), ("chroma", chroma_t, plan.chroma, 8))
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for pname, t, pp, n in cases:
            x = torch.randint(0, 256, (n, pp.in_h, pp.in_w), dtype=torch.uint8,
                              device="cuda", generator=rng)
            got = blur.blur_u8(t.blur, x)
            want = round_u8(blur_plain(t.blur.plan, x.float()))
            torch.cuda.synchronize()
            err["blur"] = max(err["blur"], compare(got, want, f"K1 {pname}"))
            got = remap.remap_u8(t.remap, x)
            want = round_u8(remap_plain(t.remap, x))
            torch.cuda.synchronize()
            err["remap"] = max(err["remap"], compare(got, want, f"K2 {pname}"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[3] K1 vs blur_plain, K2 vs remap_plain at luma {plan.luma.in_h}x{plan.luma.in_w}"
        f" and chroma {plan.chroma.in_h}x{plan.chroma.in_w}, TF32 on and off: "
        f"max |diff| blur {err['blur']} LSB, remap {err['remap']} LSB")

    # -- 4. main path ------------------------------------------------------
    yb, ub, vb = batch_of(y, BATCH), batch_of(u, BATCH), batch_of(v, BATCH)
    torch.cuda.synchronize()
    blur.LAUNCHES = 0
    remap.LAUNCHES = 0
    oy, ou, ov = eng.transform(yb, ub, vb)
    torch.cuda.synchronize()
    launches = {"blur": blur.LAUNCHES, "remap": remap.LAUNCHES}
    if min(launches.values()) <= 0:
        raise SystemExit(f"FAIL main path did not launch every kernel: {launches}")
    want_shapes = [(BATCH, plan.out_h, plan.out_w)] + 2 * [
        (BATCH, plan.chroma.out_h, plan.chroma.out_w)
    ]
    if [tuple(o.shape) for o in (oy, ou, ov)] != want_shapes or (plan.out_w, plan.out_h) != (1536, 1024):
        raise SystemExit(f"FAIL output shapes {[tuple(o.shape) for o in (oy, ou, ov)]}")
    frames = [0, BATCH - 1]
    for pname, xin, o, pp, t in (
        ("Y", yb, oy, plan.luma, luma_t),
        ("U", ub, ou, plan.chroma, chroma_t),
        ("V", vb, ov, plan.chroma, chroma_t),
    ):
        x = xin[frames]
        want = round_u8(remap_plain(t.remap, round_u8(blur_plain(t.blur.plan, x.float()))))
        compare(o[frames], want, f"main path {pname} vs plain")
    small = FLAGSHIP.replace("=512", "=64")
    sy, su, sv = video_like_planes(512, 256)
    g = open_filter(small, 512, 256, device="cuda").transform(sy, su, sv)
    c = open_filter(small, 512, 256, device="cpu").transform(sy, su, sv)
    for a, b, pname in zip(g, c, "YUV"):
        compare(a.cpu(), b, f"small {pname} cuda vs cpu engine")
    say(f"[4] main path {IN_W}x{IN_H} -> {plan.out_w}x{plan.out_h} yuv420p, batch {BATCH}: "
        f"shapes ok, frames {frames} match the plain path, 512x256 matches the CPU "
        f"engine; launches {launches}")

    # -- 5. times ----------------------------------------------------------
    tb = 16
    xl = yb[:tb].contiguous()
    xlf = xl.float()
    bl = xl.clone()
    times = {}
    runs = {
        "blur": (lambda: blur.blur_u8(luma_t.blur, xl),
                 lambda: round_u8(blur_plain(luma_t.blur.plan, xlf))),
        "remap": (lambda: remap.remap_u8(luma_t.remap, bl),
                  lambda: round_u8(remap_plain(luma_t.remap, bl))),
    }
    for name, (kern, plain) in runs.items():
        kern(), plain()  # warm-up
        ks, ps = [], []
        for _ in range(10):  # in turns: plain, kernel x4, plain, kernel x4, ...
            ps += cuda_times(plain, 1)
            ks += cuda_times(kern, 4)
        times[name] = (statistics.median(ks), statistics.median(ps))
        say(f"[5] {name}: kernel median {times[name][0]:.3f} ms (p75 {pct(ks, 0.75):.3f}, "
            f"n={len(ks)}), plain median {times[name][1]:.3f} ms (n={len(ps)}) per call on "
            f"{tb} luma frames {IN_W}x{IN_H}  ({smi})")
    cuda_times(lambda: eng.transform(yb, ub, vb), 2)  # warm-up
    steps = cuda_times(lambda: eng.transform(yb, ub, vb), 100)
    step = statistics.median(steps)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.transform(yb, ub, vb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    say(f"[5] flagship step, batch {BATCH}: device median {step:.3f} ms "
        f"(p90 {pct(steps, 0.9):.3f}, n={len(steps)}) = {BATCH / step * 1e3:.1f} frames/s; "
        f"host wall incl. sync median {statistics.median(walls):.3f} ms (n={len(walls)})  "
        f"({smi})")

    kernels = [
        {"name": "blur", "route": "cuda", "source": "transform360_tpu_torch/csrc/blur.cu",
         "replaces": "transform360_tpu/ops/blur_lane.py:269", "launches": launches["blur"],
         "max_abs_err": err["blur"], "ms": times["blur"][0], "plain_ms": times["blur"][1]},
        {"name": "remap", "route": "cuda", "source": "transform360_tpu_torch/csrc/remap.cu",
         "replaces": "transform360_tpu/ops/remap_lane.py:906", "launches": launches["remap"],
         "max_abs_err": err["remap"], "ms": times["remap"][0], "plain_ms": times["remap"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
