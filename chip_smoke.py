#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check its kernels.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU,
nvcc and CUDA PyTorch (no jax needed).  Phases:

1. the device, and ``nvidia-smi``'s name and power limit;
2. build the three kernels (K1, K3, K4) from
   ``transform360_tpu_torch/csrc`` with nvcc, one process per source, all
   at once, and print ptxas's registers, spills and shared memory, and
   K4's SASS counts (instructions, shared, generic and local loads and
   stores) per instantiation; for every instantiation of K3 (uint8 and
   uint16 samples, one or two frames a pass and WIDE) its registers and
   local (spill) bytes as the runtime reports them, its resident CTAs per
   SM at class 0's window bytes (WIDE: at ``SMALL_BYTES``), and
   the counts of int-to-float conversions
   (``I2F``, ``I2FP``), float64 products (``DMUL``) and float64-to-float32
   conversions (``F2F.F32.F64``) in its SASS (``cuobjdump -sass``; K3
   must have none of them, and its uint8 instantiations with T <= 4 no
   spill), its frame loop's SASS per output pixel by pipe (its copy loops
   apart) from a loop build with every tile staged (``k3_loop_source``,
   ``k3_loop_counts``), which phases 5 and 9 turn into K3's issue bound,
   and
   the same counts for K1's instantiations (its uint16 ones may hold no
   more than its uint8 ones; its ring kernels no ``F2I``, and the
   flagship's, uint8 at y radius 1, no ``LDL`` or ``STL``); K1's row loop
   per output pixel by pipe at the flagship's x radii 1, 2 and 6, from
   probe builds with the radius fixed (``k1_probe_source``,
   ``loop_counts``), which phases 5 and 9 turn into K1's issue bound at the
   card's largest SM clock; both kernels' tile plans, at 8 bits and at the
   10-bit flagship, K1's ring, registers and resident CTAs per SM, and
   the resident CTAs per SM of each K3 class launch;
3. each kernel against its plain version on the card, with the TF32
   switches on and off (nothing here may depend on them): K1 (prefilter)
   against ``blur_plain`` at the flagship's luma and chroma shapes and on
   small TB-odd, LR-odd, adaptive 32x15 and wide-y-radius planes (the
   last one K1's direct kernel), and on the main path's own frames at
   the batches it gives K1 (16 and 128 luma frames, 256 stacked chroma
   planes), where a launch takes the 16-column kernel, with the 8-column
   kernel on the same frames beside it; K3 (remap) against ``remap_plain`` at
   the flagship's shapes at batch 1, 2 and 7, on small barrel cases for
   the clamp-with-fill (linear) and REFLECT_101 (lanczos4) rules and a
   cubemap whose width is not a multiple of the tile's, on the main
   path's frames at the batches it gives K3 (flagship luma at 1, 16 and
   128, through the JAX package's B2-B4 range 8 ... 128, and the stacked
   chroma at 2 and 256) and at the 2x2 supersampled plan's scaled size
   (128 luma frames, 256 chroma planes), TF32 on and off, failing on any
   difference; the uint16 instantiations of K1 and K3
   against the same plain versions, TF32 on and off: the 10-bit
   flagship's luma at batch 1, 7 and 128 and stacked chroma at 256, 16-bit
   planes with samples at 65535, and a 10-bit barrel chroma plane whose
   corners hold the neutral 512 (K3 failing on any difference); K4
   (INTER_AREA + round) against
   ``area_plain`` at 0 LSB, uint8 and uint16, TF32 on and off, on the 2x2
   flagship's luma (128 frames) and stacked chroma (256), at 1.5x2, 4x4,
   the upscale branch and one latency band's rows, with its tile plans
   (packed, staged and direct tiles, the stage's boxes), registers,
   resident CTAs per SM and ring stages;
4. the batch path: ``open_filter(<flagship>, 3840, 2160, device="cuda")
   .transform(y, u, v)`` on 128 video-like frames, with every launch
   counter set to 0 just before it and read just after (K1 once per
   plane batch, K3; no other remap exists; no K4 at scale factor 1); its
   output against the plain functions on the same tensors, and a small
   size against the CPU
   engine;
5. times with CUDA events after warm-up (medians, with a tail percentile
   and the sample count): K1 and K3 beside their plain versions on 16
   luma frames, and K3 on the 256 stacked chroma planes of the batch
   path, in turns, each with its bound; K1's and K3's issue bounds there
   and per batch-128 step, beside their byte and float-operation bounds;
   the whole flagship step at batch
   128 (with the SM clock and power draw read while it runs), and its
   stages one by one;
6. the latency path: ``transform(y, u, v)`` with ``[H, W]`` planes, the
   counters set to 0 just before it and read just after (K1 and K3),
   its output against the plain path; device time and host wall, numpy
   in to CPU tensors out beside the pageable host-to-device rate; its
   stages; K3 beside its plain version on one luma frame;
7. the batch ladder 1 ... 128: whole-step device ms, frames/s and host
   wall;
8. the CLI (``transform360_tpu_torch.cli.main``) on a raw yuv420p file of
   8 frames at 3840x2160, ``--batch 1`` and ``--batch 8``: its output
   bytes equal the API's; wall time per frame;
9. the deep path: ``open_filter(<flagship>, 3840, 2160,
   pix_fmt="yuv420p10le", device="cuda")`` on 128 video-like 10-bit
   frames and on one ``[H, W]`` frame, the counters set to 0 just before
   each and read just after (only K1's and K3's uint16 instantiations
   launch); its output against the plain functions; the step's device
   median, frames/s and its stages;
10. supersampling: the flagship with ``width_scale_factor=2:
    height_scale_factor=2`` (K3 remaps to 3072x2048 luma, K4 resizes it
    with INTER_AREA and rounds to 1536x1024) at batch 128 and 1, counted
    the same way (K4 twice per step, uint8), and at 10 bits on 128 frames
    (K4's uint16 instantiation only); its output against the plain path;
    the step's device time and its peak memory over what was allocated
    before it; the stages K1, K3 (with its bound at the scaled size) and
    K4, beside them ``area_plain`` and
    ``torch.nn.functional.avg_pool2d`` on float32 copies (the PyTorch call
    that computes the same function at 2x2; timed only) and K4's byte
    bound; one frame's step and K4 as replayed CUDA graphs beside K4's
    bound; K4 beside its plain version on 16 luma frames, at 8 and 10
    bits (K4 as a replayed CUDA graph and by events in turns);
11. plan files: ``build_plan`` and the remap's tile plans against
    ``save_plan`` + ``load_plan`` and the tile plans (a restarted
    transcoder's cold start), the loaded plan's output bytes against the
    built plan's on the card, and the CLI with ``--save-plan`` and then
    ``--load-plan`` against the API's bytes;
12. the fidelity gate: ``fidelity.bench_fidelity(device="cuda")`` at its
    size (1920x960 -> 480x320, the flagship and its seven parity cases)
    at batch 12 and 1, the counters set to 0 just before each and read
    just after (K1 and K3 uint8 only); each case's bytes on the card
    against the plain path on the host's CPU on the same plan, every
    frame of the batch equal to frame 0, and each case's PSNR against the
    committed oracle fixture beside the JAX package's from the fixture
    (fails under 50 dB, or more than 0.1 dB under the JAX value); the
    flagship also runs in two latency bands with cost-model edges;
13. the drop-in wrapper: ``transform360_tpu_torch.ffmpeg.main`` with the
    reference's own argv (``-y -i in.mp4 -vf transform360="<flagship>"
    out.mp4``) on 8 raw 4K frames at ``--t360-batch 1`` and ``8``, and on
    8 yuv420p10le frames, through ``ffmpeg``/``ffprobe`` stub scripts put
    first on ``PATH`` (they serve only the wrapper's probe, rawvideo
    decode and encode); the output bytes equal the API's, and only K1
    and K3 (uint16 for the 10-bit stream) launch;
14. batch sharding: ``transform_batch_sharded`` over ``make_mesh()`` (every
    visible card) and over ``["cuda:0"] * 2`` at batch 128, and
    ``open_filter(mesh=...)``: every shard equals its frames of phase 4's
    unsharded batch, K1 launches 2 and K3 once per launch of
    ``ops.window.launches`` per shard; the
    step's device time beside phase 5's;
15. latency bands: ``parallel.latency.transform_frame_banded`` on phase
    6's [H, W] frame at n = 2, 4 and 8 with uniform and cost-model edges:
    bytes equal the unbanded frame, K1 2n launches and K3 one per launch
    of each band (one per class at one frame); each band's device time,
    K3 alone per band, max(band),
    the whole banded frame and the first call's wall (band plans built),
    and the device memory the bands'
    graphs hold once captured (allocated, and the graph pool's reserve); the pinned host-to-device rate of one 4K
    frame (the host term of ``broadcast_ms``) and the one-card projection
    of N-card banded latency; the supersampled 2x2 flagship in 3 bands (K4 twice per band)
    and the 10-bit one in 2 equal their unbanded frames;
16. two processes on the one card: the CLI with ``--distributed
    127.0.0.1:PORT,2,PID`` (gloo; both ranks on cuda:0) in batch mode and
    with ``--latency-bands 2``, 8 frames 1920x960: the ranks' outputs
    stitched equal one process's bytes;
17. the native C++ engine on the host's CPU: the CPU's model name and
    core count, ``native/t360.cpp`` built with the host's C++ compiler
    (its seconds), phase 4's first 8 frames copied to the host through
    ``open_filter(<flagship>, 3840, 2160, backend="native")`` as a batch
    (the frame pool) and as one ``[H, W]`` frame, against the card's
    bytes from phase 4 (fails under 50 dB on the worst plane or with more
    than 1% of pixels differing; prints each plane's PSNR, the share
    that differs and the largest difference), its luma warp map against
    the port's (under 1/32 + 1e-3 px), its wall per frame, and a 10-bit
    native engine refused with ``ValueError``;
18. profiling the card: ``utils.profiling.device_trace`` (torch.profiler,
    CPU and CUDA activity) around one batch-128 flagship step, whose
    trace must hold K1's kernels exactly 2 times and K3's once per launch
    of ``ops.window.launches`` (4: one per window class, luma and chroma),
    as the launch counters read them, with their summed device times
    beside phase 5's stages; ``time_frame_step`` (the chain-difference timer) at batch
    128 and 1 beside phase 5's step median, phase 6's events time and
    the frame's replayed CUDA graph (phase 15);
19. the plane executors (``pipeline.plane_executor``): their replayed
    CUDA graphs against the eager program (``GRAPH_MAX_BATCH`` 0), 0 LSB,
    on the flagship, the 10-bit and the supersampled 2x2 flagship at
    batch 1, 2, 8 and ``GRAPH_MAX_BATCH`` and on phase 6's frame in 2, 4
    and 8 bands, each replayed three times on two sets of planes in turn
    with every output kept, so that every replay re-points every node of
    its graphs that touches the caller's memory (the counter ``nodes.updates``;
    fails otherwise); then, eager and executor in turns, each measure
    calling on two sets of planes in turn with each output kept until the
    next call (:func:`alternating`: the replays pay their node updates,
    whose count per call is printed): batch 1 by CUDA events, behind a busy
    card (the call issued while the card spins, so that only its device
    time is read), host wall and numpy in to CPU tensors out; the ladder
    1 ... 32; max(band) and the host's issue per banded frame; the CLI's
    wall per frame at ``--batch 1`` and ``8``; the batch-128 step; the
    memory a capture takes at batch 1 and at ``GRAPH_MAX_BATCH`` on planes
    on the card, what stays allocated after it (fails if as much as its
    planes: a replay reads the caller's planes where they lie and writes
    a fresh output, so no static input or output stays) and what the
    graph pool reserves for the intermediates.  Phase
    6's numpy-in-to-CPU-out measure is repeated beside the pageable
    host-to-device rate, and three CLI runs that each build the flagship's
    plan anew must add no executor and no device memory.

Bound for kernel vs plain: at most 1 LSB on under 0.5% of the pixels
(the kernels are built to be bit-identical, so 0 is expected).  A
kernel's ``bound_ms`` is the larger of its compulsory bytes at 3.35 TB/s
and its float operations (each product and sum, never fused) at 33.45e12
a second; K1's and K3's lines add ``issue_bound_ms`` from their SASS.  Every
timing line carries ``nvidia-smi``'s name and power limit.  The
second-to-last line is a JSON object with each kernel's numbers; the last
is ``{"ok": true, "device": {...}}``.  The kernels line lists each kernel's
uint8 instantiation (``blur``, ``window``, launches from phase 4;
``area``, launches from phase 10's supersampled batch) and its uint16 one
(``blur_u16``, ``window_u16``, launches from phase 9; ``area_u16``, from
phase 10's 10-bit supersampled batch); K4's ``ms`` is the device time of
a replayed CUDA graph (a call on 16 frames is as short as the host's
issue of it), its time by events in turns beside it as ``ms_events``.  Any failure raises and exits
non-zero; without a GPU the script exits non-zero before printing a
result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

FLAGSHIP = (
    "cube_edge_length=512:interpolation_alg=cubic:enable_low_pass_filter=1:"
    "input_stereo_format=mono"
)
SUPERSAMPLED = FLAGSHIP + ":width_scale_factor=2:height_scale_factor=2"
IN_W, IN_H = 3840, 2160
BATCH = 128
LADDER = (1, 2, 4, 7, 8, 16, 32, 64, 128)
MAX_WRONG = 0.005  # fraction of pixels allowed to differ, by 1 LSB at most
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
# H100 SXM, float32 outside the tensor cores: 67 TFLOP/s counts an FMA as
# two operations.  The kernels are built with -fmad=false, so each product
# and each sum is its own FMUL or FADD at the FMA's issue rate: 132 SMs x
# 128 lanes x 1.98 GHz = 33.45e12 operations/s.
FP32_OPS_PER_MS = 33.45e9
SMS, LANES_PER_SM = 132, 4 * 32  # a warp instruction per scheduler per clock, 4 schedulers


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


def to_depth(x, depth: int):
    """uint8 samples scaled to a deeper format's range (x * max // 255), as
    uint16 on x's device."""
    import torch

    return (x.int() * ((1 << depth) - 1) // 255).to(torch.uint16)


def frames_of(x, idx):
    """x[idx] for a list of frame indices, as slices joined by torch.cat
    (CUDA has no indexing kernel for uint16)."""
    import torch

    return torch.cat([x[i:i + 1] for i in idx])


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


def host_walls(fn, reps: int) -> list:
    """Milliseconds of host wall of each of reps runs of fn() + synchronize."""
    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def h2d_gbps(planes) -> float:
    """GB/s of one copy of these host tensors to the card (the median of
    30, by CUDA events)."""
    import torch

    fn = lambda: [p.to("cuda", non_blocking=True) for p in planes]
    cuda_times(fn, 3)
    return tensor_bytes(*planes) / statistics.median(cuda_times(fn, 30)) / 1e6


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Device milliseconds of one fn() call: ``calls`` calls captured in a
    CUDA graph, the median of ``reps`` replays over ``calls``, so that no
    host time enters (at one frame, calls issued back to back wait on the
    host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = statistics.median(cuda_times(graph.replay, reps)) / calls
    del graph
    return ms


def issue_ms(fn, calls: int = 100) -> float:
    """Host milliseconds per fn() call issued back to back, then one
    synchronize: the host's issue time where it exceeds the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


SPIN_CYCLES = 8_000_000  # about 4 ms of torch.cuda._sleep at the H100's 1980 MHz


def behind_ms(fn, reps: int = 30) -> float:
    """Device milliseconds of one fn() call issued while the card still
    spins on ``torch.cuda._sleep``: the host's issue of the call is hidden
    behind the spin (if it takes less), so CUDA events around it read the
    device's own time for the call's work, copies and graph replays
    included.  The median of reps."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def alternating(call, *sets):
    """fn() calling call(*sets[0]), call(*sets[1]), ... in turn, and
    keeping each result until the next call has returned: a plane
    executor's replay then reads other planes than its last replay and
    writes another output block, so that it re-points its graph's nodes
    (the same planes again, or an output dropped and its block handed back
    by the caching allocator, would update none)."""
    state = {"i": -1, "out": None}

    def fn():
        state["i"] = (state["i"] + 1) % len(sets)
        state["out"] = call(*sets[state["i"]])
        return state["out"]

    return fn


def pct(xs, q: float) -> float:
    """The q-quantile of xs (nearest rank)."""
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def in_turns(kern, plain, rounds=10, per_round=4):
    """(kernel median, plain median, kernel samples) timed in turns."""
    kern(), plain()  # warm-up
    ks, ps = [], []
    for _ in range(rounds):  # plain, kernel x per_round, plain, ...
        ps += cuda_times(plain, 1)
        ks += cuda_times(kern, per_round)
    return statistics.median(ks), statistics.median(ps), ks


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations (products and sums, never fused) over the card's
    rate for them (FP32_OPS_PER_MS)."""
    tb, to = nbytes / HBM_BYTES_PER_MS, ops / FP32_OPS_PER_MS
    return (tb, "bytes") if tb >= to else (to, "operations")


_REMAP_REFS: dict = {}


def remap_ref(pp, device="cuda"):
    """The reference remap's input for the plane plan ``pp``
    (``remap_plain``: its sample spec on ``device``), built once per plan."""
    from transform360_tpu_torch.sampling import DeviceSpec

    key = (id(pp), str(device))
    if key not in _REMAP_REFS:  # the plan is kept with it: its id stays its own
        _REMAP_REFS[key] = pp, DeviceSpec.from_spec(pp.spec, pp.fill, device)
    return _REMAP_REFS[key][1]


def remap_bound(ds, B: int, plan_bytes: int, sample_bytes: int = 1):
    """The remap's compulsory bytes (plane in, plane out, its plan once)
    and its multiply-adds (T*T taps per output pixel and frame)."""
    n = ds.out_shape[0] * ds.out_shape[1]
    nbytes = sample_bytes * (B * ds.in_h * ds.in_w + B * n) + plan_bytes
    return bound(nbytes, 2.0 * ds.taps * ds.taps * n * B)


def blur_pixels(bt, B: int) -> dict:
    """{x radius: output pixels} of B frames of bt's tiles (zero tiles
    apart)."""
    import numpy as np

    tl = bt.tiles.cpu().numpy().astype(np.int64)
    t = tl[tl[:, 4] >= 0]
    rx = bt.rx.cpu().numpy()[t[:, 4]]
    return {int(r): float(np.sum(t[rx == r, 2] * t[rx == r, 3])) * B for r in np.unique(rx)}


def blur_work(bt, B: int):
    """(bytes, operations) of the prefilter on B frames: its compulsory
    bytes (plane in, plane out, its tables) and its float operations:
    each output pixel of a tile takes its band's 2*rx sums of x products
    and 2*ry sums of y products (the plan's own radii, not the ring
    kernel's padding), and 2*rx+1 and 2*ry+1 products, or rx+1 and ry+1
    where the taps are Gaussian (symmetric, bit for bit: a sample's
    product with k[u] and with k[2r - u] is one product, so each sample
    needs one per distinct tap).  Samples are bt.sample_bytes each."""
    import numpy as np

    from transform360_tpu_torch.ops.blur import gaussian_taps

    tl = bt.tiles.cpu().numpy().astype(np.int64)
    rx, ry = bt.rx.cpu().numpy(), bt.ry.cpu().numpy()
    t = tl[tl[:, 4] >= 0]
    gx, gy = rx[t[:, 4]], ry[t[:, 4]]
    if gaussian_taps(bt.kx.cpu().numpy(), bt.ky.cpu().numpy()):
        ops = (3 * gx + 1) + (3 * gy + 1)
    else:
        ops = (4 * gx + 1) + (4 * gy + 1)
    tables = tensor_bytes(bt.tiles, bt.kx, bt.rx, bt.ky, bt.ry)
    return (2 * bt.sample_bytes * B * bt.H * bt.W + tables,
            float(np.sum(ops * t[:, 2] * t[:, 3])) * B)


def blur_bound(bt, B: int):
    """The prefilter's bound on B frames (``blur_work``)."""
    return bound(*blur_work(bt, B))


def issue_bound(per_px: dict, pixels: dict, sm_mhz: float):
    """The least time for the card to issue a kernel's instructions:
    sum over x radii of its SASS instructions per output pixel times the
    pixels, over SMS x 4 schedulers x 32 lanes at sm_mhz (one warp
    instruction per scheduler per clock); None if a radius was not
    counted."""
    if any(r not in per_px for r in pixels):
        return None
    instr = sum(per_px[r] * n for r, n in pixels.items())
    return instr / (SMS * LANES_PER_SM * sm_mhz * 1e3)


def area_bound(da, B: int, sample_bytes: int):
    """INTER_AREA's compulsory bytes (plane in, plane out, its tables) and
    its float operations over the nonzero taps: per output pixel, a row
    sum (nr products, nr - 1 additions) per column tap, and the column sum
    (nc products, nc - 1 additions)."""
    oh, ow = da.out_shape
    nr = (da.row_w != 0).sum(dim=1).double()
    nc = (da.col_w != 0).sum(dim=1).double()
    per_px = nc[None, :] * (2 * nr[:, None] - 1) + 2 * nc[None, :] - 1
    tables = tensor_bytes(da.row_first, da.row_w, da.col_first, da.col_w, da.tiles)
    return bound(sample_bytes * B * (da.in_h * da.in_w + oh * ow) + tables,
                 float(per_px.sum()) * B)


def cuobjdump_path() -> str:
    """cuobjdump beside nvcc, on PATH, or the copy in Triton's package."""
    from transform360_tpu_torch.ops import _build

    cands = [os.path.join(os.path.dirname(os.path.realpath(_build.nvcc_path())), "cuobjdump"),
             shutil.which("cuobjdump") or ""]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                                  "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise SystemExit("FAIL cuobjdump not found: K3's SASS cannot be read")


SAMPLE = {"h": "u8", "t": "u16"}  # the Itanium-ABI codes of uint8_t and uint16_t


def sass_counts(lib_path, pattern: str) -> dict:
    """{key: counts} for each kernel function of the library's SASS whose
    mangled name matches ``pattern`` (its groups make the key):
    instructions, int-to-float conversions (I2F, I2FP), LDS, generic loads
    (LD), local loads and stores (LDL, STL: spills), float-to-int
    conversions (F2I), float64 products (DMUL) and float64-to-float32
    conversions (F2F.F32.F64, as ``F2F64``)."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    res, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            cur = m.groups() if m else None
            if cur:
                res[cur] = {"instructions": 0, "I2F": 0, "LDS": 0, "LD": 0, "LDL": 0,
                            "STL": 0, "F2I": 0, "DMUL": 0, "F2F64": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)",
                      line)
        if cur and m:
            op = m.group(1)
            c = res[cur]
            c["instructions"] += 1
            if op in ("I2F", "I2FP"):
                c["I2F"] += 1
            elif op in ("LDS", "LD", "LDL", "STL", "F2I", "DMUL"):
                c[op] += 1
            elif op == "F2F" and m.group(2).startswith(".F32.F64"):
                c["F2F64"] += 1
    if not res:
        raise SystemExit(f"FAIL no function matching {pattern} in the SASS of {lib_path}")
    return res


def k3_launches(plan, B: int) -> int:
    """K3's launches in a plan's step of B frames: luma's, and chroma's on
    U and V as two sources of B (``ops.window.launches``)."""
    from transform360_tpu_torch.ops import window

    return (len(window.launches(plan.luma.window_plan().groups, B))
            + len(window.launches(plan.chroma.window_plan().groups, 2 * B, B)))


# K3's kernels by sample, T and MODE, and its WIDE flag (an earlier K3 has
# none): keys (sample, T, MODE), and (sample, T, MODE, "wide") for the
# instantiations of more than two frames a pass
K3_NAME = r"window_kernelI([ht])Li(\d+)ELi(\d+)E(Lb1E)?"


def _k3_key(s, t, m, wide):
    return (SAMPLE[s], int(t), int(m)) + (("wide",) if wide else ())


def k3_sass(lib_path) -> dict:
    """{(sample, T, MODE[, "wide"]): counts} for each K3 instantiation."""
    return {_k3_key(*k): c for k, c in sass_counts(lib_path, K3_NAME).items()}


def k4_sass(lib_path) -> dict:
    """{(sample, taps): counts} for each K4 instantiation."""
    raw = sass_counts(lib_path, r"area_kernelI([ht])Li(\d+)E")
    return {(SAMPLE[s], int(k)): c for (s, k), c in raw.items()}


# SASS opcodes (before the first '.') by the pipe that issues them
PIPES = {"float": ("FMUL", "FADD", "FMNMX"),
         "integer and logic": ("PRMT", "LOP3", "SHF", "IMNMX", "IADD", "IADD3"),
         "conversion": ("F2I", "I2F", "I2FP"),
         "memory": ("LDS", "LDG", "STG")}
STORE_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def loop_counts(lib_path, pattern: str, sample_bytes: dict, innermost: bool = True) -> dict:
    """{key: counts per output pixel} of the innermost loop with the most
    FMULs in each kernel function of the library's SASS whose mangled name
    matches ``pattern`` (its groups make the key): every opcode and each
    PIPES group, and ``total``, divided by the loop's output pixels per
    iteration (its stores' bytes over sample_bytes[key[0]]), with
    ``px_per_iteration``.  A loop is the range from a backward branch's
    target to the branch, innermost if it holds no other; built with one x
    radius (a probe build), that radius's row loop is the one with the most
    FMULs.  With ``innermost`` False the loop is the one with the most
    FMULs of its own (outside the loops it holds: K3's frame loop holds
    its copy loops), and the loops it holds are counted once,
    as if each ran one iteration; ``nested`` is their share of
    ``total``."""
    out = subprocess.run([cuobjdump_path(), "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(pattern, line)
            cur = m.groups() if m else None
            if cur:
                funcs[cur] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if cur and m:
            funcs[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    res = {}
    for key, ins in funcs.items():
        loops = []  # (first, last) address of each backward branch's range
        for addr, op, arg in ins:
            t = re.search(r"0x([0-9a-f]+)", arg)
            if op.split(".")[0] == "BRA" and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        best = None
        for lo, hi in loops:
            inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
            if innermost and inner:
                continue
            body = [o for a, o, _ in ins if lo <= a <= hi]
            own = [o for a, o, _ in ins
                   if lo <= a <= hi and not any(x <= a <= y for x, y in inner)]
            n_fmul = sum(o.split(".")[0] == "FMUL" for o in own)
            if best is None or n_fmul > best[0]:
                best = (n_fmul, body, len(body) - len(own))
        if best is None:
            continue
        body = best[1]
        stored = sum(STORE_BYTES.get(o.split(".")[-1], 4) for o in body
                     if o.split(".")[0] == "STG")
        px = stored / sample_bytes[key[0]]
        if px <= 0:
            continue
        ops = {}
        for o in body:
            ops[o.split(".")[0]] = ops.get(o.split(".")[0], 0) + 1
        c = {k: v / px for k, v in sorted(ops.items())}
        for pipe, names in PIPES.items():
            c[pipe] = sum(ops.get(n, 0) for n in names) / px
        c["total"] = len(body) / px
        c["nested"] = best[2] / px
        c["px_per_iteration"] = px
        res[key] = c
    return res


def k1_probe_counts(lib_path) -> dict:
    """{(sample, columns per thread): counts per output pixel} of each
    y-radius-1 ring kernel's row loop in a probe build of K1 (one x
    radius; ``loop_counts``); columns None for a kernel without that
    template argument (an earlier K1's)."""
    raw = loop_counts(lib_path, r"blur_ring_kernelI([ht])Li1E(?:Li(\d+)E)?E", {"h": 1, "t": 2})
    return {(SAMPLE[k[0]], int(k[1]) if k[1] else None): c for k, c in raw.items()}


def k1_cols(bt, B: int) -> int:
    """K1's columns per thread on a launch of B frames of bt."""
    from transform360_tpu_torch.ops import blur

    return blur.launch_cols(blur.KERNEL.library(), bt, B)


K1_PROBE_RX = (1, 2, 6)  # the flagship's x radii
# What a probe build rewrites in K1's source, once each: its x-radius
# switch, fixed to one radius so that its row loop alone is in the SASS,
# and the test for a thread's whole-group store, made true so that the
# scalar stores of partial groups drop out of the loop.  The second entry
# is an earlier K1's (for port_tools/k1_sass.py on older trees).
K1_PROBE_EDITS = ((("switch (rx) {", "switch ({r}) {"), ("if (cl.whole) {", "if (true) {")),
                  (("switch (t.rx) {", "switch ({r}) {"), ("if (vec_store) {", "if (true) {")))


def k1_probe_source(src: str, r: int) -> str:
    """K1's source ``src`` with its ring kernel fixed to x radius r
    (``K1_PROBE_EDITS``)."""
    for edits in K1_PROBE_EDITS:
        if all(src.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new.replace("{r}", str(r)))
            return src
    raise SystemExit("FAIL cannot fix the x radius of this blur.cu: no probe edit matches it")


def k1_probe_builds(csrc, tag: str = "") -> dict:
    """{x radius: library} of K1's probe builds at ``K1_PROBE_RX`` from the
    ``blur.cu`` and headers in the directory ``csrc``, one nvcc each, all
    at once (``_build._build`` with the rewritten source)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from transform360_tpu_torch.ops import _build

    src = (Path(csrc) / "blur.cu").read_text()
    with ThreadPoolExecutor(max_workers=len(K1_PROBE_RX)) as ex:
        futs = {r: ex.submit(_build._build, "blur", (), k1_probe_source(src, r), Path(csrc),
                             f"probe {tag}rx {r}") for r in K1_PROBE_RX}
        return {r: f.result() for r, f in futs.items()}


def k1_sass(lib_path) -> dict:
    """{(sample, kernel): counts} for each K1 instantiation (ring kernels
    by y radius and columns per thread, and the direct kernel)."""
    raw = sass_counts(lib_path, r"blur_(ring|direct)_kernelI([ht])(?:Li(\d+)ELi(\d+)E)?E")
    return {(SAMPLE[s], f"ring y radius {ry}, {v} columns" if k == "ring" else "direct"): c
            for (k, s, ry, v), c in raw.items()}


# What K3's loop build rewrites in its source, once: the test for a
# staged tile, made true, so that the global path drops out of the frame
# loop and the loop with the most FMULs of its own is the staged one.
K3_LOOP_EDIT = ("const bool staged = pitch > 0;", "const bool staged = true;")


def k3_loop_source(src: str) -> str:
    """K3's source ``src`` with every tile staged (``K3_LOOP_EDIT``)."""
    old, new = K3_LOOP_EDIT
    if src.count(old) != 1:
        raise SystemExit("FAIL cannot drop the global path of this window.cu: no loop edit matches")
    return src.replace(old, new)


def k3_loop_counts(lib_path) -> dict:
    """{(sample, T, MODE[, "wide"]): counts per output pixel} of each K3
    instantiation's frame loop in a loop build (``k3_loop_source``;
    ``loop_counts`` with ``innermost`` False), with ``own``: ``total``
    without the loops the frame loop holds (its copy loops, whose trips
    per frame follow the window, about 0.6 chunks a thread at the
    flagship)."""
    raw = loop_counts(lib_path, K3_NAME, {"h": 1, "t": 2}, innermost=False)
    return {_k3_key(*k): dict(c, own=c["total"] - c["nested"]) for k, c in raw.items()}


STUB_FFPROBE = """import os, sys
print(f"3840,2160,30/1,{os.environ.get('T360_STUB_PIX_FMT', 'yuv420p')}")
"""

STUB_FFMPEG = """import shutil, sys
a = sys.argv[1:]
ins = [a[i + 1] for i, x in enumerate(a[:-1]) if x == "-i"]
if a[-1] == "-" and "rawvideo" in a and "-" not in ins:  # decode: the raw file to stdout
    with open(ins[0], "rb") as f:
        shutil.copyfileobj(f, sys.stdout.buffer, 1 << 22)
elif "-" in ins:  # encode: stdin to the output file
    with open(a[-1], "wb") as f:
        shutil.copyfileobj(sys.stdin.buffer, f, 1 << 22)
else:
    sys.exit("ffmpeg stub: only the wrapper's rawvideo decode and encode are served: " + " ".join(a))
"""


def write_stubs(bindir: str) -> None:
    """``ffmpeg`` and ``ffprobe`` scripts for phase 13: the probe prints a
    3840x2160 stream in ``$T360_STUB_PIX_FMT`` (default yuv420p); the
    decode copies its raw input file to stdout, the encode its stdin to
    its last argument."""
    os.makedirs(bindir)
    for name, body in (("ffmpeg", STUB_FFMPEG), ("ffprobe", STUB_FFPROBE)):
        path = os.path.join(bindir, name)
        with open(path, "w") as f:
            f.write(f"#!{sys.executable}\n{body}")
        os.chmod(path, 0o755)


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``, with its vendor,
    family and model numbers (a virtualized kernel may report the name as
    ``unknown``), or ``platform.machine()`` where there is no cpuinfo."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                info.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    if "model name" not in info:
        import platform

        return platform.machine()
    return (f"{info['model name']} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')})")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a GPU is required",
              file=sys.stderr)
        return 2

    import numpy as np

    from transform360_tpu_torch import build_plan, cli, open_filter, pipeline
    from transform360_tpu_torch.config import (
        Interpolation, Layout, StereoFormat, TransformConfig,
    )
    from transform360_tpu_torch.filtering import blur_plain
    from transform360_tpu_torch.ops import _build, area, blur, sources, window
    from transform360_tpu_torch.utils.profiling import COUNTERS
    from transform360_tpu_torch.parallel import latency
    from transform360_tpu_torch.sampling import AreaTables, DeviceArea, remap_plain, round_px, round_u8
    from transform360_tpu_torch.utils.yuv import write_yuv420_batch

    u16 = torch.uint16

    # each kernel's uint8 and uint16 instantiations count their launches
    # apart; beside them the planes the executors copied by .contiguous()
    counters = {"blur": "blur.launches", "window": "window.launches", "area": "area.launches",
                "blur_u16": "blur.launches_u16", "window_u16": "window.launches_u16",
                "area_u16": "area.launches_u16", "plane_copies": "pipeline.plane_copies"}

    def reset_counts():
        for name in counters.values():
            COUNTERS[name] = 0

    def read_counts():
        """The counters since reset_counts(), read just after a main path
        ran: a plane copied by .contiguous() there fails (every path's
        planes have packed rows, so the kernels read them where they lie)."""
        c = {k: COUNTERS[name] for k, name in counters.items()}
        if c["plane_copies"]:
            raise SystemExit(f"FAIL {c['plane_copies']} plane(s) copied by .contiguous() on a "
                             f"main path: {c}")
        return c

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
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as ex:  # the probes' nvccs beside the kernels'
        probe_builds = ex.submit(k1_probe_builds, _build.CSRC)
        k3_loop_build = ex.submit(_build._build, "window", (),
                                  k3_loop_source((_build.CSRC / "window.cu").read_text()),
                                  _build.CSRC, "loop build")
        _build.build_all(["blur", "window", "area"])
        probes = probe_builds.result()
        k3_loop_lib = k3_loop_build.result()
    say(f"[2] built blur.cu + window.cu + area.cu for sm_90a, K1's probe builds at x "
        f"radius {K1_PROBE_RX} and K3's loop build, in {time.perf_counter() - t0:.2f} s, one "
        f"nvcc each in parallel (nvcc: {_build.BUILD_SECONDS})")
    for name, log in _build.BUILD_LOG.items():
        if "probe" in name or "loop build" in name:
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"    ptxas {name}: {line.strip()}")
    say(f"    K3 dynamic shared memory per CTA: 2 x the frames a pass ({window.WIDE_FRAMES} for "
        f"class 0's windows up to {window.SMALL_BYTES} B, 2 for its others, 1 for the larger "
        f"class) x the launch's window bytes + a 4-byte chunk-table entry per 16 of them "
        f"(classes {window.CLASS_BYTES} B)")
    sass = k3_sass(_build._build("window"))
    modes = ("wrap", "fill", "reflect")
    spills = []
    win0, wins = window.CLASS_BYTES[0], window.SMALL_BYTES
    for sb, sname in ((1, "u8"), (2, "u16")):
        for taps in (1, 2, 4, 8):
            parts = []
            for mode, mname in enumerate(modes):
                for key, win, fp in (((sname, taps, mode), win0, 2),
                                     ((sname, taps, mode, "wide"), wins, window.WIDE_FRAMES)):
                    at = window.kernel_attrs(taps, mode, win, fp, sb)
                    c = sass[key]
                    if sb == 1 and taps <= 4 and (at["local_bytes"] or c["LDL"] or c["STL"]):
                        spills.append(key)
                    parts.append(f"{mname} ({fp} frames a pass) {at['registers']} registers, "
                                 f"{at['local_bytes']} B local, {at['ctas_per_sm']} CTAs per SM "
                                 f"at {win} B windows; {c['instructions']} instructions, "
                                 f"{c['LDS']} LDS, {c['I2F']} I2F, {c['F2I']} F2I, {c['DMUL']} "
                                 f"DMUL, {c['F2F64']} F2F.F32.F64, {c['LDL']} LDL, {c['STL']} STL")
            say(f"    K3 {sname} T={taps}: " + "; ".join(parts))
    n_bad = {k: sum(c[k] for c in sass.values()) for k in ("I2F", "DMUL", "F2F64")}
    say(f"    K3 SASS: {n_bad['I2F']} int-to-float conversions (I2F, I2FP), {n_bad['DMUL']} "
        f"DMUL and {n_bad['F2F64']} F2F.F32.F64 in {len(sass)} instantiations (uint8 and "
        f"uint16); spills in the uint8 instantiations with T <= 4: {spills}")
    if any(n_bad.values()) or len(sass) != 48 or spills:
        raise SystemExit(f"FAIL K3's SASS holds {n_bad} in {len(sass)} instantiations, or "
                         f"its uint8 instantiations with T <= 4 spill: {spills}")
    # {(sample, T, MODE[, "wide"]): counts per output pixel}
    k3_px = k3_loop_counts(k3_loop_lib)
    for key, c in sorted(k3_px.items()):
        sname, taps, mode = key[:3]
        if taps == 4 or mode == 0:
            say(f"    K3 {sname} T={taps} {modes[mode]}{' wide' if len(key) > 3 else ''}, "
                f"frame loop per output pixel "
                f"({c['px_per_iteration']:.0f} pixels an iteration): {c['own']:.3f} "
                f"instructions without the copy loops it holds ({c['total']:.3f} with them, "
                f"counted once); "
                + ", ".join(f"{pipe} {c[pipe]:.3f}" for pipe in PIPES)
                + "; " + ", ".join(f"{o} {c[o]:.3f}" for o in sorted(c)
                                   if o.isupper() and c[o] >= 0.1))
    # T = 1 has no product to find its frame loop by
    want_px = {(sn, taps, mode) + wide for sn in ("u8", "u16") for taps in (2, 4, 8)
               for mode in range(3) for wide in ((), ("wide",))}
    if not want_px <= set(k3_px):
        raise SystemExit(f"FAIL K3's loop build gave no frame loop for {sorted(want_px - set(k3_px))}")
    k1 = k1_sass(_build._build("blur"))
    for (sname, kname), c in sorted(k1.items()):
        say(f"    K1 {sname} {kname}: {c['instructions']} instructions, {c['I2F']} I2F, "
            f"{c['F2I']} F2I, {c['LDL']} LDL and {c['STL']} STL (spills)")
    # K1 converts its samples by PRMT at either size: the uint16
    # instantiations add no int-to-float conversion to the uint8 ones';
    # the ring kernels round with no F2I, and the flagship's (uint8, y
    # radius 1) spills nothing
    ring = {k: c for k, c in k1.items() if k[1].startswith("ring")}
    flagship = [k1[("u8", f"ring y radius 1, {v} columns")] for v in (8, 16)]
    if (len(k1) != 7 or any(c["I2F"] > k1[("u8", kname)]["I2F"]
                            for (sname, kname), c in k1.items() if sname == "u16")
            or any(c["F2I"] for c in ring.values()) or any(c["LDL"] or c["STL"] for c in flagship)):
        raise SystemExit(f"FAIL K1's SASS: uint16 I2F over uint8's, F2I in a ring kernel, or "
                         f"spills in the flagship's: {k1}")
    k1_px = {}  # {(sample, columns, x radius): counts per output pixel of the ring row loop}
    for r in K1_PROBE_RX:
        for (sname, v), c in k1_probe_counts(probes[r]).items():
            k1_px[(sname, v, r)] = c
            say(f"    K1 {sname} ring y radius 1, {v} columns a thread, x radius {r}, row loop per "
                f"output pixel ({c['px_per_iteration']:.0f} pixels an iteration): "
                f"{c['total']:.3f} instructions; "
                + ", ".join(f"{pipe} {c[pipe]:.3f}" for pipe in PIPES)
                + "; " + ", ".join(f"{o} {c[o]:.3f}" for o in sorted(c)
                                   if o.isupper() and c[o] >= 0.1))
    if len(k1_px) != 3 * len(K1_PROBE_RX):
        raise SystemExit(f"FAIL K1's probe builds gave no row loop for {k1_px.keys()}")
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])

    for (sname, k), c in sorted(k4_sass(_build._build("area")).items()):
        say(f"    K4 {sname} {k} register taps: {c['instructions']} instructions, {c['LDS']} "
            f"LDS, {c['LD']} generic loads, {c['LDL']} LDL and {c['STL']} STL (spills)")

    # -- plan (CPU) ------------------------------------------------------
    t0 = time.perf_counter()
    eng = open_filter(FLAGSHIP, IN_W, IN_H, device="cuda")
    plan = eng.plan
    luma_t = plan.luma.tables("cuda")
    chroma_t = plan.chroma.tables("cuda")
    say(f"    plan {IN_W}x{IN_H} -> {plan.out_w}x{plan.out_h} built and moved in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    wplans = [window.build_window_plan(pp.spec, pp.fill) for pp in (plan.luma, plan.chroma)]
    t_wplan = time.perf_counter() - t0
    t0 = time.perf_counter()
    luma_w = plan.luma.window_tables("cuda")
    chroma_w = plan.chroma.window_tables("cuda")
    torch.cuda.synchronize()
    t_wmove = time.perf_counter() - t0
    for pname, wp in zip(("luma", "chroma"), wplans):
        staged = wp.meta[:, 5] > 0
        halo = float((wp.meta[:, 4] * wp.meta[:, 5])[staged].sum()) / (wp.in_h * wp.in_w)
        occ = [window.kernel_attrs(wp.taps, wp.mode, win, fp) for _, _, win, fp in wp.groups]
        say(f"    K3 tile plan {pname}: {wp.meta.shape[0]} tiles of {window.TH}x{window.TW}, "
            f"per class "
            f"{[int((wp.tile_class == c).sum()) for c in range(len(window.CLASS_BYTES))]}"
            f", {int((~staged).sum())} global-path tiles; launches (first, tiles, window "
            f"bytes, frames a pass) {wp.groups}, resident CTAs per SM "
            f"{[a['ctas_per_sm'] for a in occ]} at {[a['smem_bytes'] for a in occ]} B of "
            f"shared memory and {occ[0]['registers']} registers; windows stage "
            f"{halo:.3f}x the plane's bytes per frame")
    say(f"    K3 tile plans built in {t_wplan:.3f} s (numpy, luma + chroma), "
        f"built again and moved by window_tables in {t_wmove:.3f} s")
    deep = open_filter(FLAGSHIP, IN_W, IN_H, pix_fmt="yuv420p10le", device="cuda")
    for pname, pp in (("luma", deep.plan.luma), ("chroma", deep.plan.chroma)):
        wp = window.build_window_plan(pp.spec, pp.fill, 2)
        occ = [window.kernel_attrs(wp.taps, wp.mode, win, fp, 2) for _, _, win, fp in wp.groups]
        say(f"    K3 uint16 tile plan, 10-bit {pname}: per class "
            f"{[int((wp.tile_class == c).sum()) for c in range(len(window.CLASS_BYTES))]}, "
            f"{int((wp.meta[:, 5] == 0).sum())} global-path tiles; launches {wp.groups}, "
            f"resident CTAs per SM {[a['ctas_per_sm'] for a in occ]}")
    for pname, t, b in (("luma", luma_t, BATCH), ("chroma", chroma_t, 2 * BATCH),
                        ("10-bit luma", deep.plan.luma.tables("cuda"), BATCH),
                        ("10-bit chroma", deep.plan.chroma.tables("cuda"), 2 * BATCH)):
        tl = t.blur.tiles.cpu().numpy()
        cols = k1_cols(t.blur, b)
        at = blur.kernel_attrs(t.blur, cols=cols)
        resident = blur.resident_ctas(blur.KERNEL.library(), t.blur, cols=cols)
        say(f"    K1 tile plan {pname}: {tl.shape[0]} tiles of {sorted(set(tl[:, 2].tolist()))} "
            f"rows x {sorted(set(tl[:, 3].tolist()))} columns, x radii "
            f"{sorted(set(t.blur.rx.cpu().tolist()))}, ring kernel y radius {t.blur.ring_ry} "
            f"(plan: {sorted(set(t.blur.ry.cpu().tolist()))}); a ring of {blur.STAGES} stages "
            f"of {t.blur.slab} rows of {t.blur.row_bytes} B, {t.blur.pitch} B apart: "
            f"{at['smem_bytes']} B of shared memory, {at['threads']} threads, "
            f"{at['registers']} registers, {at['local_bytes']} B local, {at['ctas_per_sm']} "
            f"resident CTAs per SM ({resident} on the card) at batch {b}, {cols} columns a "
            f"thread, {blur.launch_parts(t.blur, b, resident)} parts per tile; batch 1: "
            f"{k1_cols(t.blur, 1)} columns")

    y, u, v = video_like_planes(IN_W, IN_H)
    err = {"blur": 0, "window": 0, "area": 0, "blur_u16": 0, "window_u16": 0, "area_u16": 0}

    # -- 3. kernels vs plain on the card -----------------------------------
    rng = torch.Generator(device="cuda").manual_seed(0)
    mono = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)
    blur_cases = [("flagship luma", luma_t.blur, 4), ("flagship chroma", chroma_t.blur, 8)]
    for what, cfg, iw, ih, ow, oh in (
        ("TB odd", TransformConfig(input_stereo_format=StereoFormat.TB,
                                   output_stereo_format=StereoFormat.TB), 256, 161, 96, 128),
        ("LR odd", TransformConfig(input_stereo_format=StereoFormat.LR,
                                   output_stereo_format=StereoFormat.LR), 513, 80, 192, 64),
        ("adaptive 32x15", TransformConfig(num_vertical_segments=32,
                                           num_horizontal_segments=15, **mono), 960, 480, 240, 160),
        ("y radius 5", TransformConfig(min_kernel_half_height=5, **mono), 256, 80, 96, 64),
    ):
        sp = build_plan(cfg, iw, ih, ow, oh, "yuv420p")
        blur_cases += [(f"{what} {pp.in_w}x{pp.in_h}", pp.tables("cuda").blur, 3)
                       for pp in (sp.luma, sp.chroma)]
    yb, ub, vb = batch_of(y, BATCH), batch_of(u, BATCH), batch_of(v, BATCH)
    # the chroma batch of the batch path stacked: K3's input shape (K1's
    # output) and the plain versions' reference; the path never makes it
    cb = torch.cat([ub, vb])
    # K1 on the main path's frames at the batches it is given there (phase
    # 5's 16 luma frames, the step's luma, and U and V in place as two
    # sources), where a uint8 launch takes the 16-column kernel: the
    # wrapper's own launch, and the 8-column kernel's on the same frames
    path_cases = [("luma", luma_t.blur, (yb[:16],)), ("luma", luma_t.blur, (yb,)),
                  ("chroma U, V in place", chroma_t.blur, (ub, vb))]
    for what, bt, xs in path_cases:
        b = sources.frames(xs)
        if k1_cols(bt, b) != 16:
            raise SystemExit(f"FAIL K1 takes {k1_cols(bt, b)} columns a thread on {b} flagship "
                             f"{what} planes, not 16")

    def k1_cols8(bt, xs):
        out = torch.empty((sources.frames(xs), bt.H, bt.W), dtype=bt.dtype, device="cuda")
        blur.launch(blur.KERNEL.library(), bt, xs, out, torch.cuda.current_stream().cuda_stream,
                    cols=8)
        return out

    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for what, bt, n in blur_cases:
            x = torch.randint(0, 256, (n, bt.H, bt.W), dtype=torch.uint8, device="cuda",
                              generator=rng)
            got = blur.blur_px(bt, x)
            want = round_u8(blur_plain(bt.plan, x.float()))
            torch.cuda.synchronize()
            err["blur"] = max(err["blur"], compare(got, want, f"K1 {what}"))
        for what, bt, xs in path_cases:
            b, ref = sources.frames(xs), sources.stacked(xs)
            for ncols, got in ((16, blur.blur_px(bt, xs)), (8, k1_cols8(bt, xs))):
                for f0 in range(0, b, 32):  # the plain version in slices of 32 frames
                    want = round_u8(blur_plain(bt.plan, ref[f0:f0 + 32].float()))
                    err["blur"] = max(err["blur"], compare(
                        got[f0:f0 + 32], want, f"K1 flagship {what} b={b}, {ncols} columns"))
                del got, want
            del ref
        for pname, pp in (("luma", plan.luma), ("chroma", plan.chroma)):
            x = torch.randint(0, 256, (7, pp.in_h, pp.in_w), dtype=torch.uint8,
                              device="cuda", generator=rng)
            for b in (1, 2, 7):
                got = window.remap_window_px(pp.window_tables("cuda"), x[:b].contiguous())
                want = round_u8(remap_plain(remap_ref(pp), x[:b]))
                torch.cuda.synchronize()
                err["window"] = max(err["window"], compare(got, want, f"K3 {pname} b={b}"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[3] K1 vs blur_plain, TF32 on and off, on "
        + ", ".join(f"{w} (ring y radius {bt.ring_ry})" for w, bt, _ in blur_cases)
        + ", and on the main path's video-like frames, "
        + ", ".join(f"{sources.frames(xs)} flagship {w}" for w, _, xs in path_cases)
        + f", with 16 columns a thread (the path's launch) and 8: max |diff| {err['blur']} LSB")
    if err["blur"]:
        raise SystemExit(f"FAIL K1 differs from blur_plain by {err['blur']} LSB")
    say(f"[3] K3 vs remap_plain at luma {plan.luma.in_h}x{plan.luma.in_w} and chroma "
        f"{plan.chroma.in_h}x{plan.chroma.in_w}, batch 1, 2 and 7, TF32 on and off: "
        f"max |diff| {err['window']} LSB")
    small = (
        ("barrel+linear (clamp-with-fill)", TransformConfig(
            output_layout=Layout.BARREL, interpolation_alg=Interpolation.LINEAR, **mono),
         1024, 512, 640, 256),
        ("barrel+lanczos4 (REFLECT_101)", TransformConfig(
            output_layout=Layout.BARREL_SPLIT, interpolation_alg=Interpolation.LANCZOS4,
            **mono), 1024, 512, 768, 256),
        ("cubemap+cubic, ragged tiles (wrap)", TransformConfig(**mono), 1024, 512, 390, 260),
    )
    for what, cfg, iw, ih, ow, oh in small:
        sp = build_plan(cfg, iw, ih, ow, oh, "yuv420p")
        for pp in (sp.luma, sp.chroma):
            for b in (1, 3):
                x = torch.randint(0, 256, (b, pp.in_h, pp.in_w), dtype=torch.uint8,
                                  device="cuda", generator=rng)
                got = window.remap_window_px(pp.window_tables("cuda"), x)
                want = round_u8(remap_plain(remap_ref(pp), x))
                torch.cuda.synchronize()
                err["window"] = max(err["window"], compare(got, want, f"K3 {what}"))
        say(f"[3] K3 vs remap_plain, {what} {iw}x{ih} -> {ow}x{oh}, luma and chroma, "
            f"batch 1 and 3: max |diff| {err['window']} LSB")
    # K3 on the main path's frames at the batches it is given there (1, 16
    # and 128 luma frames, 2 and 256 stacked chroma planes) and through the
    # JAX package's B2-B4 range (8 ... 128)
    k3_path = (("luma", yb, plan.luma, luma_w, (1, 8, 16, 32, 64, 128)),
               ("chroma", cb, plan.chroma, chroma_w, (2, 2 * BATCH)))
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for pname, xs, pp, wt, sizes in k3_path:
            for b in sizes:
                got = window.remap_window_px(wt, xs[:b])
                for f0 in range(0, b, 32):  # the plain version in slices of 32 frames
                    want = round_u8(remap_plain(remap_ref(pp), xs[f0:min(b, f0 + 32)]))
                    err["window"] = max(err["window"], compare(
                        got[f0:f0 + 32], want, f"K3 {pname} b={b}"))
                del got, want
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[3] K3 vs remap_plain on the main path's video-like frames, flagship luma at batch "
        f"1, 8, 16, 32, 64, 128 and the stacked chroma at 2 and {2 * BATCH}, TF32 on and off: "
        f"max |diff| {err['window']} LSB")
    if err["window"]:
        raise SystemExit(f"FAIL K3 differs from remap_plain by {err['window']} LSB")

    def check_u16(pp, x, what, tf32s=(True, False)):
        """K1 then K3, uint16, against their plain versions on the same
        inputs (in slices of 32 frames); returns K3's output."""
        t, wt = pp.tables("cuda"), pp.window_tables("cuda")
        for tf32 in tf32s:
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            b = x if t.blur is None else blur.blur_px(t.blur, x, pp.maxval)
            got = window.remap_window_px(wt, b, pp.maxval)
            for f0 in range(0, x.shape[0], 32):
                sl = slice(f0, f0 + 32)
                if t.blur is not None:
                    want = round_px(blur_plain(t.blur.plan, x[sl].float()), pp.maxval, u16)
                    err["blur_u16"] = max(err["blur_u16"], compare(b[sl], want, f"K1 u16 {what}"))
                want = round_px(remap_plain(remap_ref(pp), b[sl]), pp.maxval, u16)
                err["window_u16"] = max(err["window_u16"],
                                        compare(got[sl], want, f"K3 u16 {what}"))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return got

    ydb, udb, vdb = (to_depth(t, 10) for t in (yb, ub, vb))  # 10-bit video-like frames
    cdb = torch.cat([udb, vdb])
    if not torch.equal(cdb[BATCH:].int(), vdb.int()):
        raise SystemExit("FAIL torch.cat of uint16 planes on the card")
    for b in (1, 7, BATCH):
        check_u16(deep.plan.luma, ydb[:b], f"10-bit luma b={b}")
    check_u16(deep.plan.chroma, cdb, f"10-bit chroma b={2 * BATCH}")
    say(f"[3] K1 and K3 uint16 vs blur_plain and remap_plain at the 10-bit flagship, luma "
        f"batch 1, 7 and {BATCH}, stacked chroma {2 * BATCH}, TF32 on and off: max |diff| "
        f"K1 {err['blur_u16']}, K3 {err['window_u16']} LSB")
    sat = open_filter(FLAGSHIP, IN_W, IN_H, pix_fmt="yuv420p16le", device="cuda").plan
    g16 = torch.Generator(device="cuda").manual_seed(16)
    for pp in (sat.luma, sat.chroma):
        x = torch.randint(0, 65536, (4, pp.in_h, pp.in_w), dtype=torch.int32, device="cuda",
                          generator=g16)
        x[0] = 65535
        blocks = torch.arange(pp.in_w, device="cuda") // 64 % 2  # hard edges: the taps overshoot
        x[2] = 65535 * blocks[None, :]
        check_u16(pp, x.to(u16), f"16-bit saturated {pp.in_w}x{pp.in_h}")
    barrel = build_plan(TransformConfig(output_layout=Layout.BARREL, **mono), 1024, 512, 640,
                        256, "yuv420p10le").chroma
    x = torch.randint(0, 1024, (3, barrel.in_h, barrel.in_w), dtype=torch.int32, device="cuda",
                      generator=g16).to(u16)
    bo = check_u16(barrel, x, "10-bit barrel chroma").int()
    corners = bo[:, [0, -1], [-1, -1]]  # outside the pole discs on the right
    if not (corners == 512).all():
        raise SystemExit(f"FAIL 10-bit barrel chroma corners {corners.tolist()}, not 512")
    say(f"[3] K1 and K3 uint16 on 16-bit planes with samples at 65535 (flagship luma and "
        f"chroma) and a 10-bit barrel chroma plane (corners {sorted(set(corners.flatten().tolist()))}"
        f"), TF32 on and off: max |diff| K1 {err['blur_u16']}, K3 {err['window_u16']} LSB")
    if err["window_u16"]:
        raise SystemExit(f"FAIL K3 uint16 differs from remap_plain by {err['window_u16']} LSB")

    # K1 and K3 reading a batch where it lies, as two sources (U and V) or
    # one strided source, against their plain versions on the same frames
    # stacked, at 0 LSB, TF32 on and off: the main path's own U and V
    # (128 + 128), strided views of packed yuv420p frames, b0 odd (K3's
    # frame groups straddle the two), a frame stride that is not 16-byte
    # aligned (K1 takes the producer's loads, K3 its sample copies), at
    # uint8 and uint16; then the flagship without its prefilter (K3 reads
    # U and V where they lie) through the main entry point
    def packed_yuv(ys, us, vs, pad=0):
        """Views Y, U, V of one buffer of packed yuv420p frames (each
        frame Y, U, V, then pad samples), as a raw reader hands them over."""
        n, nc = ys[0].numel(), us[0].numel()
        buf = torch.empty((ys.shape[0], n + 2 * nc + pad), dtype=ys.dtype, device="cuda")
        views = (buf[:, :n].unflatten(1, ys.shape[1:]),
                 buf[:, n:n + nc].unflatten(1, us.shape[1:]),
                 buf[:, n + nc:n + 2 * nc].unflatten(1, vs.shape[1:]))
        for dst, src in zip(views, (ys, us, vs)):
            dst.copy_(src)
        return views

    def hold_sources(pp, xs, what, k1=True):
        """K1 (if k1 and the plan has a prefilter) and K3 on the sources
        xs against blur_plain and remap_plain on the frames stacked, in
        slices of 32; fails on any difference."""
        t, wt = pp.tables("cuda"), pp.window_tables("cuda")
        names = ("blur", "window") if pp.dtype == torch.uint8 else ("blur_u16", "window_u16")
        ref = sources.stacked(xs)
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs = [(names[1], window.remap_window_px(wt, xs, pp.maxval),
                     lambda x: remap_plain(remap_ref(pp), x))]
            if k1 and t.blur is not None:
                outs.append((names[0], blur.blur_px(t.blur, xs, pp.maxval),
                             lambda x: blur_plain(t.blur.plan, x.float())))
            for name, got, plain_fn in outs:
                for f0 in range(0, ref.shape[0], 32):
                    want = round_px(plain_fn(ref[f0:f0 + 32]), pp.maxval, pp.dtype)
                    d = int((got[f0:f0 + 32].int() - want.int()).abs().max())
                    err[name] = max(err[name], d)
                    if d:
                        raise SystemExit(f"FAIL {name} on {what} differs from its plain version "
                                         f"by {d} LSB (TF32 {tf32})")
            del outs
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    src_cases = []
    pyv, puv, pvv = packed_yuv(yb, ub, vb)
    qyv, quv, qvv = packed_yuv(yb[:16], ub[:16], vb[:16], pad=8)  # frames 8 bytes off 16
    for what, pp, xs in (
        ("U, V of the main path (128 + 128)", plan.chroma, (ub, vb)),
        ("U, V as views of packed yuv420p frames", plan.chroma, (puv, pvv)),
        ("Y as a view of packed yuv420p frames", plan.luma, (pyv,)),
        ("U, V views, b0 odd (63 + 65)", plan.chroma, (puv[:63], pvv[:65])),
        ("U, V views, frame stride not 16-byte aligned (16 + 16)", plan.chroma, (quv, qvv)),
        ("10-bit U, V (128 + 128)", deep.plan.chroma, (udb, vdb)),
    ):
        src = sources.describe(xs)
        copy = "TMA" if blur.copy_mode(pp.tables("cuda").blur, xs) == blur.COPY_TMA else "loads"
        if (copy == "TMA") != all(s_.aligned for s_ in src):
            raise SystemExit(f"FAIL K1 copies {what} by {copy}, with sources {src}")
        hold_sources(pp, xs, what)
        src_cases.append(f"{what}: frame strides {[s_.stride for s_ in src]}, aligned "
                         f"{[s_.aligned for s_ in src]}, K1 by {copy}")
    dp16 = packed_yuv(ydb[:16], udb[:16], vdb[:16], pad=4)  # 10-bit, frames 8 bytes off 16
    hold_sources(deep.plan.chroma, (dp16[1][:7], dp16[2][:9]),
                 "10-bit U, V views, b0 odd, frame stride not 16-byte aligned")
    src_cases.append("10-bit U, V views, b0 odd (7 + 9), frame stride not 16-byte aligned: K1 by "
                     + ("TMA" if blur.copy_mode(deep.plan.chroma.tables("cuda").blur,
                                                (dp16[1], dp16[2])) == blur.COPY_TMA else "loads"))
    del qyv, quv, qvv, dp16
    nopf = open_filter(FLAGSHIP.replace("enable_low_pass_filter=1", "enable_low_pass_filter=0"),
                       IN_W, IN_H, device="cuda")
    for what, planes in (("separate planes", (yb, ub, vb)), ("packed yuv420p views", (pyv, puv, pvv))):
        torch.cuda.synchronize()
        reset_counts()
        outs = nopf.transform(*planes)
        torch.cuda.synchronize()
        nl = read_counts()
        if nl["blur"] or nl["window"] != k3_launches(nopf.plan, BATCH):
            raise SystemExit(f"FAIL the flagship without a prefilter launched {nl}")
        for o, xin, pp in zip(outs, planes, (nopf.plan.luma, nopf.plan.chroma, nopf.plan.chroma)):
            for f0 in range(0, BATCH, 32):
                want = round_u8(remap_plain(remap_ref(pp), xin[f0:f0 + 32]))
                d = int((o[f0:f0 + 32].int() - want.int()).abs().max())
                err["window"] = max(err["window"], d)
                if d:
                    raise SystemExit(f"FAIL the flagship without a prefilter, {what}, differs "
                                     f"from remap_plain by {d} LSB")
        src_cases.append(f"the flagship without a prefilter on {what} through open_filter("
                         f").transform at batch {BATCH}: launches {nl}")
        del outs
    del pyv, puv, pvv
    say("[3] K1 and K3 on batches read where they lie, TF32 on and off, 0 LSB against "
        "blur_plain and remap_plain: " + "; ".join(src_cases)
        + f"; max |diff| K1 {err['blur']}/{err['blur_u16']}, K3 {err['window']}/"
        f"{err['window_u16']} LSB (uint8/uint16)")

    # K4 against area_plain: the 2x2 flagship's luma and stacked chroma, 1.5x2,
    # 4x4, the upscale branch and a latency band's rows, uint8 and uint16
    ss = open_filter(SUPERSAMPLED, IN_W, IN_H, device="cuda")
    sp = ss.plan
    # K3 at the supersampled plan's scaled size, on the path's batches
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        for pp, xs in ((sp.luma, yb), (sp.chroma, cb)):
            got = window.remap_window_px(pp.window_tables("cuda"), xs)
            for f0 in range(0, xs.shape[0], 16):
                want = round_u8(remap_plain(remap_ref(pp), xs[f0:f0 + 16]))
                err["window"] = max(err["window"], compare(
                    got[f0:f0 + 16], want, f"K3 supersampled b={xs.shape[0]}"))
            del got, want
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sw = [pp.window_tables("cuda") for pp in (sp.luma, sp.chroma)]
    say(f"[3] K3 vs remap_plain at the 2x2 supersampled plan's scaled size ("
        f"{sw[0].out_w}x{sw[0].out_h} luma, {BATCH} frames; {sw[1].out_w}x{sw[1].out_h} "
        f"stacked chroma, {2 * BATCH} planes), TF32 on and off: max |diff| {err['window']} LSB")
    if err["window"]:
        raise SystemExit(f"FAIL K3 differs from remap_plain by {err['window']} LSB")
    area_cases = [("2x2 flagship luma", sp.luma.tables("cuda").area, BATCH),
                  ("2x2 flagship chroma (U+V)", sp.chroma.tables("cuda").area, 2 * BATCH)]
    for what, sizes, b in (("1.5x2", (2304, 2048, 1536, 1024), 7),
                           ("4x4", (6144, 4096, 1536, 1024), 3),
                           ("upscale", (768, 512, 1536, 1024), 7)):
        area_cases.append((f"{what} {sizes[0]}x{sizes[1]} -> {sizes[2]}x{sizes[3]}",
                           DeviceArea.from_tables(AreaTables.build(*sizes), "cuda"), b))
    band = latency.band_plans(sp, 3)[1].luma
    area_cases.append((f"band 2 of 3, luma rows {band.out_h}", band.tables("cuda").area, 7))
    ga = torch.Generator(device="cuda").manual_seed(4)
    for what, da, b in area_cases:
        for name, dt, mx in (("area", torch.uint8, 255), ("area_u16", u16, 1023)):
            x = torch.randint(0, mx + 1, (b, da.in_h, da.in_w), dtype=torch.int32,
                              device="cuda", generator=ga).to(dt)
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got = area.area_px(da, x, mx)
                for f0 in range(0, b, 32):  # the plain version in slices of 32 frames
                    want = area.area_plain(da, x[f0:f0 + 32], mx)
                    err[name] = max(err[name], compare(got[f0:f0 + 32], want,
                                                       f"K4 {name} {what}"))
                    if err[name]:
                        raise SystemExit(f"FAIL K4 {name} {what} differs from area_plain")
                del got, want
            del x
        attrs = [area.kernel_attrs(da, sb) for sb in (1, 2)]
        modes = da.tiles[:, 7]
        say(f"[3] K4 vs area_plain, {what} ({da.in_w}x{da.in_h} -> {da.out_shape[1]}x"
            f"{da.out_shape[0]}, batch {b}, {da.row_w.shape[1]}x{da.col_w.shape[1]} taps, "
            f"{da.tiles.shape[0]} tiles: {int((modes == area.PACKED).sum())} packed, "
            f"{int((modes == area.STAGED).sum())} staged per column, "
            f"{int((modes == area.DIRECT).sum())} direct; stage boxes {da.box}; uint8 "
            f"{attrs[0]['registers']} registers, {attrs[0]['local_bytes']} B local, "
            f"{attrs[0]['ctas_per_sm']} CTAs per SM, a ring of {attrs[0]['stages']} stages in "
            f"{attrs[0]['smem_bytes']} B; uint16 {attrs[1]['ctas_per_sm']} CTAs per SM, "
            f"{attrs[1]['stages']} stages in {attrs[1]['smem_bytes']} B), uint8 and uint16, "
            f"TF32 on and off: max |diff| {err['area']} and {err['area_u16']} LSB")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 4. batch path -----------------------------------------------------
    torch.cuda.synchronize()
    reset_counts()
    oy, ou, ov = eng.transform(yb, ub, vb)
    torch.cuda.synchronize()
    launches = read_counts()
    if (launches["blur"] != 2 or launches["window"] <= 0 or launches["blur_u16"]
            or launches["window_u16"] or launches["area"] or launches["area_u16"]):
        raise SystemExit(f"FAIL batch path did not launch K1 once per plane batch and K3 "
                         f"(uint8 only, no K4 at scale factor 1): {launches}")
    if "transform360_tpu_torch.ops.remap" in sys.modules or (_build.CSRC / "remap.cu").exists():
        raise SystemExit("FAIL the retired batch remap K2 is still present")
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
        want = round_u8(remap_plain(remap_ref(pp), round_u8(blur_plain(t.blur.plan, x.float()))))
        compare(o[frames], want, f"batch path {pname} vs plain")
    small_opts = FLAGSHIP.replace("=512", "=64")
    sy, su, sv = video_like_planes(512, 256)
    g = open_filter(small_opts, 512, 256, device="cuda").transform(sy, su, sv)
    c = open_filter(small_opts, 512, 256, device="cpu").transform(sy, su, sv)
    for a, b, pname in zip(g, c, "YUV"):
        compare(a.cpu(), b, f"small {pname} cuda vs cpu engine")
    say(f"[4] batch path {IN_W}x{IN_H} -> {plan.out_w}x{plan.out_h} yuv420p, batch {BATCH}: "
        f"shapes ok, frames {frames} match the plain path, 512x256 matches the CPU "
        f"engine; launches {launches}")

    # -- 5. times ----------------------------------------------------------
    tb = 16
    xl = yb[:tb].contiguous()
    xlf = xl.float()
    bl = xl.clone()
    times = {}
    runs = {
        "blur": (lambda: blur.blur_px(luma_t.blur, xl),
                 lambda: round_u8(blur_plain(luma_t.blur.plan, xlf))),
        "window": (lambda: window.remap_window_px(luma_w, bl),
                   lambda: round_u8(remap_plain(remap_ref(plan.luma), bl))),
    }
    wplan_bytes = tensor_bytes(luma_w.meta, luma_w.pos, luma_w.fy, luma_w.fx, luma_w.wtab)
    bounds = {"blur": blur_bound(luma_t.blur, tb),
              "window": remap_bound(remap_ref(plan.luma), tb, wplan_bytes)}
    for name, (kern, plain_fn) in runs.items():
        km, pm, ks = in_turns(kern, plain_fn)
        times[name] = (km, pm)
        say(f"[5] {name}: kernel median {km:.4f} ms (p75 {pct(ks, 0.75):.4f}, "
            f"n={len(ks)}), plain median {pm:.4f} ms per call on {tb} luma frames "
            f"{IN_W}x{IN_H}; bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
            f"{bounds[name][0] / km:.1%} of it reached  ({smi})")
    # K1's issue bound from its SASS row loop (phase 2's probe builds), at
    # the columns per thread each launch takes
    def k1_per_px(sname, bt, B):
        v = k1_cols(bt, B)
        return v, {r: k1_px[(sname, v, r)]["total"] for r in K1_PROBE_RX}

    v_tb, px_tb = k1_per_px("u8", luma_t.blur, tb)
    k1_issue = {"blur": issue_bound(px_tb, blur_pixels(luma_t.blur, tb), sm_mhz)}
    vl, pxl = k1_per_px("u8", luma_t.blur, BATCH)
    vc, pxc = k1_per_px("u8", chroma_t.blur, 2 * BATCH)
    wl, wc = blur_work(luma_t.blur, BATCH), blur_work(chroma_t.blur, 2 * BATCH)
    k1_step = {"issue_bound_ms": issue_bound(pxl, blur_pixels(luma_t.blur, BATCH), sm_mhz)
               + issue_bound(pxc, blur_pixels(chroma_t.blur, 2 * BATCH), sm_mhz),
               "bytes_bound_ms": (wl[0] + wc[0]) / HBM_BYTES_PER_MS,
               "operations_bound_ms": (wl[1] + wc[1]) / FP32_OPS_PER_MS}
    say(f"[5] K1's issue bound: its row loop's SASS instructions per output pixel at x radius "
        f"{K1_PROBE_RX}, over {SMS} SMs x {LANES_PER_SM} lanes at {sm_mhz:.0f} MHz: "
        f"{k1_issue['blur']:.4f} ms on {tb} luma frames ({v_tb} columns a thread: "
        f"{ {r: round(v, 3) for r, v in px_tb.items()} }; bytes "
        f"{blur_work(luma_t.blur, tb)[0] / HBM_BYTES_PER_MS:.4f}, float operations "
        f"{blur_work(luma_t.blur, tb)[1] / FP32_OPS_PER_MS:.4f}); per batch-{BATCH} step (luma "
        f"{vl} and stacked chroma {vc} columns a thread: "
        f"{ {r: round(v, 3) for r, v in pxl.items()} }): issue "
        f"{k1_step['issue_bound_ms']:.4f} ms, bytes {k1_step['bytes_bound_ms']:.4f}, float "
        f"operations {k1_step['operations_bound_ms']:.4f}  ({smi})")
    # K3's issue bound from its frame loop's SASS (phase 2's loop build):
    # its instructions per output pixel and frame (the copy loops apart)
    # times the pixel-frames
    def k3_issue_bound(sname, wb):
        per_px = k3_px[(sname, wb[0][0].taps, wb[0][0].mode)]["own"]
        return issue_bound({0: per_px}, {0: float(sum(b * w.out_h * w.out_w for w, b in wb))},
                           sm_mhz)

    k3_issue = {"window": k3_issue_bound("u8", [(luma_w, tb)])}
    k3_step = {"issue_bound_ms": k3_issue_bound("u8", [(luma_w, BATCH), (chroma_w, 2 * BATCH)]),
               "bound_ms": remap_bound(remap_ref(plan.luma), BATCH, 0)[0] + remap_bound(
                   remap_ref(plan.chroma), 2 * BATCH, 0)[0]}
    say(f"[5] K3's issue bound: its frame loop's SASS instructions per output pixel "
        f"({k3_px[('u8', luma_w.taps, luma_w.mode)]['own']:.3f}, uint8 T={luma_w.taps}, the copy "
        f"loops apart), "
        f"over {SMS} SMs x {LANES_PER_SM} lanes at {sm_mhz:.0f} MHz: {k3_issue['window']:.4f} "
        f"ms on {tb} luma frames (bytes {bounds['window'][0]:.4f}); per batch-{BATCH} step "
        f"(luma and stacked chroma): issue {k3_step['issue_bound_ms']:.4f} ms, bytes or "
        f"float operations {k3_step['bound_ms']:.4f}  ({smi})")
    cplan_bytes = tensor_bytes(chroma_w.meta, chroma_w.pos, chroma_w.fy, chroma_w.fx, chroma_w.wtab)
    cbound = remap_bound(remap_ref(plan.chroma), 2 * BATCH, cplan_bytes)
    km, pm, ks = in_turns(lambda: window.remap_window_px(chroma_w, cb),
                          lambda: round_u8(remap_plain(remap_ref(plan.chroma), cb)), rounds=5,
                          per_round=4)
    chroma_k3 = {"shape": f"{2 * BATCH} chroma planes", "ms": km, "plain_ms": pm,
                 "bound_ms": cbound[0], "bound_by": cbound[1]}
    say(f"[5] window chroma: kernel median {km:.4f} ms (p75 {pct(ks, 0.75):.4f}, "
        f"n={len(ks)}), plain median {pm:.4f} ms per call on {2 * BATCH} chroma planes "
        f"{plan.chroma.in_w}x{plan.chroma.in_h}; bound {cbound[0]:.4f} ms ({cbound[1]}), "
        f"{cbound[0] / km:.1%} of it reached  ({smi})")
    cuda_times(lambda: eng.transform(yb, ub, vb), 2)  # warm-up
    steps = cuda_times(lambda: eng.transform(yb, ub, vb), 100)
    step = statistics.median(steps)
    for _ in range(20):  # keep the card busy while its clock and power are read
        eng.transform(yb, ub, vb)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    walls = host_walls(lambda: eng.transform(yb, ub, vb), 10)
    say(f"[5] flagship step, batch {BATCH}: device median {step:.4f} ms "
        f"(p90 {pct(steps, 0.9):.4f}, n={len(steps)}) = {BATCH / step * 1e3:.1f} frames/s; "
        f"host wall incl. sync median {statistics.median(walls):.4f} ms "
        f"(p90 {pct(walls, 0.9):.4f}, n={len(walls)}); SM clock, its maximum and power draw "
        f"under the step: {clock}  ({smi})")
    yl = blur.blur_px(luma_t.blur, yb)  # the remaps' inputs on the batch path
    cl = blur.blur_px(chroma_t.blur, (ub, vb))
    parts = {}
    for name, fn in {
        "K1 luma": lambda: blur.blur_px(luma_t.blur, yb),
        "K1 chroma (U, V in place)": lambda: blur.blur_px(chroma_t.blur, (ub, vb)),
        "K3 luma": lambda: window.remap_window_px(luma_w, yl),
        "K3 chroma (U+V)": lambda: window.remap_window_px(chroma_w, cl),
    }.items():
        cuda_times(fn, 2)
        parts[name] = statistics.median(cuda_times(fn, 20))
    cuda_times(lambda: torch.cat([ub, vb]), 2)
    cat_ms = statistics.median(cuda_times(lambda: torch.cat([ub, vb]), 20))
    say(f"[5] batch-{BATCH} stages, device medians of 20 by CUDA events: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f} ms against the step's {step:.4f}; off the path, "
        f"for the record: torch.cat of U and V {cat_ms:.4f} ms  ({smi})")
    stages_b128 = parts  # phase 18 sets the trace's kernel times beside them
    del yl, cl

    # -- 6. latency path ---------------------------------------------------
    y1, u1, v1 = yb[0], ub[0], vb[0]  # [H, W] planes on the card
    torch.cuda.synchronize()
    reset_counts()
    ly, lu, lv = eng.transform(y1, u1, v1)
    torch.cuda.synchronize()
    lat_launches = read_counts()
    if lat_launches["blur"] != 2 or lat_launches["window"] <= 0:
        raise SystemExit(f"FAIL latency path did not launch K1 and K3: {lat_launches}")
    for pname, xin, o, pp in (("Y", y1, ly, plan.luma), ("U", u1, lu, plan.chroma),
                              ("V", v1, lv, plan.chroma)):
        pre = round_u8(blur_plain(pp.tables("cuda").blur.plan, xin[None].float()))
        want = round_u8(remap_plain(remap_ref(pp), pre))
        if tuple(o.shape) != tuple(want.shape[1:]):
            raise SystemExit(f"FAIL latency path {pname} shape {tuple(o.shape)}")
        compare(o[None], want, f"latency path {pname} vs plain")
        compare(o, oy[0] if pname == "Y" else (ou[0] if pname == "U" else ov[0]),
                f"latency path {pname} vs the same frame in the batch")
    say(f"[6] latency path, one [H, W] frame {IN_W}x{IN_H}: output matches the plain "
        f"path and frame 0 of the batch; launches {lat_launches}")
    lat = cuda_times(lambda: eng.transform(y1, u1, v1), 5)
    lat = cuda_times(lambda: eng.transform(y1, u1, v1), 200)
    frame_ms = statistics.median(lat)  # phase 15 sets its bands beside it
    lat_walls = host_walls(lambda: eng.transform(y1, u1, v1), 200)
    yn, un, vn = y, u, v  # numpy planes: host to device and back included

    def from_host():
        return [o.cpu() for o in eng.transform(yn, un, vn)]

    e2e = host_walls(from_host, 50)
    pageable6 = h2d_gbps([torch.from_numpy(p) for p in (yn, un, vn)])
    say(f"[6] latency, batch 1: device median {statistics.median(lat):.4f} ms "
        f"(p90 {pct(lat, 0.9):.4f}, n={len(lat)}); host wall incl. sync, planes on the "
        f"card, median {statistics.median(lat_walls):.4f} ms (p90 {pct(lat_walls, 0.9):.4f}, "
        f"n={len(lat_walls)}); numpy in to CPU tensors out median "
        f"{statistics.median(e2e):.4f} ms (p90 {pct(e2e, 0.9):.4f}, n={len(e2e)}); pageable "
        f"host to device {pageable6:.2f} GB/s  ({smi})")
    x1 = yb[:1].contiguous()
    c2 = torch.cat([ub[:1], vb[:1]])  # K1's stacked chroma output's shape, K3's input
    stages = {
        "K1 luma": lambda: blur.blur_px(luma_t.blur, x1),
        "K1 chroma (U, V in place)": lambda: blur.blur_px(chroma_t.blur, (ub[:1], vb[:1])),
        "K3 luma": lambda: window.remap_window_px(luma_w, x1),
        "K3 chroma (U+V)": lambda: window.remap_window_px(chroma_w, c2),
    }
    parts = {}
    for name, fn in stages.items():
        cuda_times(fn, 3)
        parts[name] = statistics.median(cuda_times(fn, 50))
    say(f"[6] batch-1 stages, device medians of 50 by CUDA events: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f} ms  ({smi})")
    for name, kern, plain_fn, bnd in (
        ("blur", lambda: blur.blur_px(luma_t.blur, x1),
         lambda: round_u8(blur_plain(luma_t.blur.plan, x1.float())), blur_bound(luma_t.blur, 1)),
        ("window", lambda: window.remap_window_px(luma_w, x1),
         lambda: round_u8(remap_plain(remap_ref(plan.luma), x1)),
         remap_bound(remap_ref(plan.luma), 1, wplan_bytes)),
    ):
        km, pm, ks = in_turns(kern, plain_fn, rounds=20)
        say(f"[6] {name}: kernel median {km:.4f} ms (p75 {pct(ks, 0.75):.4f}, n={len(ks)}), "
            f"plain median {pm:.4f} ms per call on 1 luma frame {IN_W}x{IN_H}; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})  ({smi})")

    # -- 7. ladder ---------------------------------------------------------
    for b in LADDER:
        ys, us, vs = yb[:b], ub[:b], vb[:b]
        cuda_times(lambda: eng.transform(ys, us, vs), 3)
        reps = max(10, 400 // b)
        dev = cuda_times(lambda: eng.transform(ys, us, vs), reps)
        hw = host_walls(lambda: eng.transform(ys, us, vs), max(5, reps // 4))
        med = statistics.median(dev)
        say(f"[7] batch {b:3d}: step device median {med:.4f} ms (p90 {pct(dev, 0.9):.4f}, "
            f"n={len(dev)}) = {b / med * 1e3:.1f} frames/s, host wall "
            f"{statistics.median(hw):.4f} ms (n={len(hw)})  ({smi})")

    # -- 8. CLI ------------------------------------------------------------
    n_cli = 8
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.yuv")
        write_yuv420_batch(src, *(t[:n_cli].cpu().numpy() for t in (yb, ub, vb)))
        api = eng.transform(yb[:n_cli], ub[:n_cli], vb[:n_cli])
        api = [o.cpu().numpy() for o in api]
        want = b"".join(api[p][k].tobytes() for k in range(n_cli) for p in range(3))
        for b in (1, 8):
            out = os.path.join(tmp, f"out{b}.yuv")
            t0 = time.perf_counter()
            rc = cli.main(["--vf", FLAGSHIP, "--input-size", f"{IN_W}x{IN_H}", "-i", src,
                           "-o", out, "--batch", str(b), "--device", "cuda"])
            dt = time.perf_counter() - t0
            with open(out, "rb") as f:
                got = f.read()
            if rc != 0 or got != want:
                raise SystemExit(f"FAIL CLI --batch {b}: rc {rc}, output "
                                 f"{'equals' if got == want else 'differs from'} the API's")
            say(f"[8] CLI --batch {b}: {n_cli} frames {IN_W}x{IN_H} raw yuv420p, output "
                f"bytes equal the API's; wall {dt * 1e3 / n_cli:.2f} ms per frame "
                f"(file IO included)  ({smi})")

    # -- 9. deep path ----------------------------------------------------
    dp = deep.plan
    torch.cuda.synchronize()
    reset_counts()
    dy, du, dv = deep.transform(ydb, udb, vdb)
    torch.cuda.synchronize()
    deep_launches = read_counts()
    if (deep_launches["blur"] or deep_launches["window"] or deep_launches["blur_u16"] != 2
            or deep_launches["window_u16"] <= 0):
        raise SystemExit(f"FAIL the 10-bit batch path did not launch only K1 and K3 uint16: "
                         f"{deep_launches}")
    for pname, xin, o, pp in (("Y", ydb, dy, dp.luma), ("U", udb, du, dp.chroma),
                              ("V", vdb, dv, dp.chroma)):
        if o.dtype != u16 or tuple(o.shape) != (BATCH, pp.out_h, pp.out_w):
            raise SystemExit(f"FAIL 10-bit {pname}: {o.dtype} {tuple(o.shape)}")
        t = pp.tables("cuda")
        x = frames_of(xin, frames)
        pre = round_px(blur_plain(t.blur.plan, x.float()), 1023, u16)
        want = round_px(remap_plain(remap_ref(pp), pre), 1023, u16)
        compare(frames_of(o, frames), want, f"10-bit batch path {pname} vs plain")
    reset_counts()
    one = deep.transform(ydb[0], udb[0], vdb[0])
    torch.cuda.synchronize()
    deep_one = read_counts()
    if deep_one["blur"] or deep_one["window"] or deep_one["blur_u16"] != 2:
        raise SystemExit(f"FAIL the 10-bit latency path's launches {deep_one}")
    for o, ob, pname in zip(one, (dy, du, dv), "YUV"):
        compare(o, ob[0], f"10-bit [H, W] frame {pname} vs frame 0 of the batch")
    say(f"[9] 10-bit batch path {IN_W}x{IN_H} -> {dp.out_w}x{dp.out_h} yuv420p10le, batch "
        f"{BATCH}: uint16 out, frames {frames} match the plain path; launches {deep_launches}; "
        f"one [H, W] frame matches frame 0, launches {deep_one}")
    cuda_times(lambda: deep.transform(ydb, udb, vdb), 2)
    steps = cuda_times(lambda: deep.transform(ydb, udb, vdb), 30)
    dstep = statistics.median(steps)
    lat = cuda_times(lambda: deep.transform(ydb[0], udb[0], vdb[0]), 50)
    say(f"[9] 10-bit flagship step, batch {BATCH}: device median {dstep:.4f} ms (p90 "
        f"{pct(steps, 0.9):.4f}, n={len(steps)}) = {BATCH / dstep * 1e3:.1f} frames/s; one "
        f"[H, W] frame {statistics.median(lat):.4f} ms (p90 {pct(lat, 0.9):.4f}, "
        f"n={len(lat)})  ({smi})")
    dlt, dct = dp.luma.tables("cuda"), dp.chroma.tables("cuda")
    dlw, dcw = dp.luma.window_tables("cuda"), dp.chroma.window_tables("cuda")
    yl = blur.blur_px(dlt.blur, ydb, 1023)
    cl = blur.blur_px(dct.blur, (udb, vdb), 1023)
    parts = {}
    for name, fn in {
        "K1 luma": lambda: blur.blur_px(dlt.blur, ydb, 1023),
        "K1 chroma (U, V in place)": lambda: blur.blur_px(dct.blur, (udb, vdb), 1023),
        "K3 luma": lambda: window.remap_window_px(dlw, yl, 1023),
        "K3 chroma (U+V)": lambda: window.remap_window_px(dcw, cl, 1023),
    }.items():
        cuda_times(fn, 2)
        parts[name] = statistics.median(cuda_times(fn, 10))
    say(f"[9] 10-bit batch-{BATCH} stages, device medians of 10: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f} ms against the step's {dstep:.4f}  ({smi})")
    del yl, cl
    xd = ydb[:tb].contiguous()
    xdf = xd.float()
    dplan_bytes = tensor_bytes(dlw.meta, dlw.pos, dlw.fy, dlw.fx, dlw.wtab)
    for name, kern, plain_fn, bnd in (
        ("blur_u16", lambda: blur.blur_px(dlt.blur, xd, 1023),
         lambda: round_px(blur_plain(dlt.blur.plan, xdf), 1023, u16), blur_bound(dlt.blur, tb)),
        ("window_u16", lambda: window.remap_window_px(dlw, xd, 1023),
         lambda: round_px(remap_plain(remap_ref(dp.luma), xd), 1023, u16),
         remap_bound(remap_ref(dp.luma), tb, dplan_bytes, 2)),
    ):
        km, pm, ks = in_turns(kern, plain_fn, rounds=5)
        times[name] = (km, pm)
        bounds[name] = bnd
        if name == "blur_u16":
            k1_issue[name] = issue_bound(k1_per_px("u16", dlt.blur, tb)[1],
                                         blur_pixels(dlt.blur, tb), sm_mhz)
        else:
            k3_issue[name] = k3_issue_bound("u16", [(dlw, tb)])
        say(f"[9] {name}: kernel median {km:.4f} ms (p75 {pct(ks, 0.75):.4f}, n={len(ks)}), "
            f"plain median {pm:.4f} ms per call on {tb} 10-bit luma frames {IN_W}x{IN_H}; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / km:.1%} of it reached; issue bound "
            f"{(k1_issue if name == 'blur_u16' else k3_issue)[name]:.4f} ms  ({smi})")
    del xd, xdf, dy, du, dv

    # -- 10. supersampling + INTER_AREA -------------------------------------
    if ((sp.luma.scaled_w, sp.luma.scaled_h, sp.out_w, sp.out_h) != (3072, 2048, 1536, 1024)
            or sp.luma.area is None):
        raise SystemExit(f"FAIL supersampled plan {sp.luma.scaled_w}x{sp.luma.scaled_h} -> "
                         f"{sp.out_w}x{sp.out_h}")
    torch.cuda.synchronize()
    reset_counts()
    sy, su, sv = ss.transform(yb, ub, vb)
    torch.cuda.synchronize()
    ss_launches = read_counts()
    if (ss_launches["blur"] != 2 or ss_launches["window"] <= 0 or ss_launches["area"] != 2
            or ss_launches["blur_u16"] or ss_launches["window_u16"] or ss_launches["area_u16"]):
        raise SystemExit(f"FAIL the supersampled batch path's launches {ss_launches} (K1 2, "
                         f"K3, K4 2, uint8 only)")
    for pname, xin, o, pp in (("Y", yb, sy, sp.luma), ("U", ub, su, sp.chroma),
                              ("V", vb, sv, sp.chroma)):
        if tuple(o.shape) != (BATCH, pp.out_h, pp.out_w):
            raise SystemExit(f"FAIL supersampled {pname} shape {tuple(o.shape)}")
        t = pp.tables("cuda")
        x = xin[frames]
        k3 = round_u8(remap_plain(remap_ref(pp), round_u8(blur_plain(t.blur.plan, x.float()))))
        compare(o[frames], area.area_plain(t.area, k3), f"supersampled {pname} vs plain")
    reset_counts()
    one = ss.transform(yb[0], ub[0], vb[0])
    torch.cuda.synchronize()
    ss_one = read_counts()
    if ss_one["blur"] != 2 or ss_one["area"] != 2 or ss_one["area_u16"]:
        raise SystemExit(f"FAIL the supersampled [H, W] frame's launches {ss_one}")
    for o, ob, pname in zip(one, (sy, su, sv), "YUV"):
        compare(o, ob[0], f"supersampled [H, W] frame {pname} vs frame 0 of the batch")
    say(f"[10] supersampled 2x2 {IN_W}x{IN_H} -> K3 at {sp.luma.scaled_w}x{sp.luma.scaled_h} "
        f"-> K4 (INTER_AREA) {sp.out_w}x{sp.out_h}, batch {BATCH}: frames {frames} match the "
        f"plain path; launches {ss_launches}; one [H, W] frame matches frame 0, launches "
        f"{ss_one}")
    ssd = open_filter(SUPERSAMPLED, IN_W, IN_H, pix_fmt="yuv420p10le", device="cuda")
    dsp = ssd.plan
    torch.cuda.synchronize()
    reset_counts()
    dso = ssd.transform(ydb, udb, vdb)
    torch.cuda.synchronize()
    ssd_launches = read_counts()
    if (ssd_launches["area_u16"] != 2 or ssd_launches["blur_u16"] != 2
            or ssd_launches["window_u16"] <= 0
            or any(ssd_launches[k] for k in ("blur", "window", "area"))):
        raise SystemExit(f"FAIL the 10-bit supersampled batch path's launches {ssd_launches} "
                         f"(K1 2, K3, K4 2, uint16 only)")
    for pname, xin, o, pp in (("Y", ydb, dso[0], dsp.luma), ("U", udb, dso[1], dsp.chroma),
                              ("V", vdb, dso[2], dsp.chroma)):
        t = pp.tables("cuda")
        x = frames_of(xin, frames)
        pre = round_px(blur_plain(t.blur.plan, x.float()), 1023, u16)
        k3 = round_px(remap_plain(remap_ref(pp), pre), 1023, u16)
        compare(frames_of(o, frames), area.area_plain(t.area, k3, 1023),
                f"10-bit supersampled {pname} vs plain")
    del dso
    cuda_times(lambda: ss.transform(yb, ub, vb), 2)
    steps = cuda_times(lambda: ss.transform(yb, ub, vb), 20)
    sstep = statistics.median(steps)
    lat = cuda_times(lambda: ss.transform(yb[0], ub[0], vb[0]), 50)
    cuda_times(lambda: ssd.transform(ydb, udb, vdb), 2)
    dsteps = cuda_times(lambda: ssd.transform(ydb, udb, vdb), 10)
    del sy, su, sv, one
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ss.transform(yb, ub, vb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    say(f"[10] supersampled step, batch {BATCH}: device median {sstep:.4f} ms (p90 "
        f"{pct(steps, 0.9):.4f}, n={len(steps)}) = {BATCH / sstep * 1e3:.1f} frames/s; one "
        f"[H, W] frame {statistics.median(lat):.4f} ms (p90 {pct(lat, 0.9):.4f}, "
        f"n={len(lat)}); the step's peak memory over what was allocated before it "
        f"(torch.cuda.max_memory_allocated) {peak / 2**30:.3f} GiB; 10-bit supersampled "
        f"step {statistics.median(dsteps):.4f} ms (n={len(dsteps)}), launches {ssd_launches}"
        f"  ({smi})")
    slt, sct = sp.luma.tables("cuda"), sp.chroma.tables("cuda")
    slw, scw = sp.luma.window_tables("cuda"), sp.chroma.window_tables("cuda")
    avg_pool2d = torch.nn.functional.avg_pool2d  # timed only: the port never calls it
    from transform360_tpu_torch import pipeline as pipeline_mod
    for b in (BATCH, 1):
        ys, cs = yb[:b], (ub[:b], vb[:b])
        yl, cl = blur.blur_px(slt.blur, ys), blur.blur_px(sct.blur, cs)
        yr, cr = window.remap_window_px(slw, yl), window.remap_window_px(scw, cl)
        yrf, crf = yr.float(), cr.float()  # avg_pool2d's pre-converted float32 copies
        parts, aside = {}, {}
        for d, name, fn in (
            (parts, "K1 luma", lambda: blur.blur_px(slt.blur, ys)),
            (parts, "K1 chroma (U, V in place)", lambda: blur.blur_px(sct.blur, cs)),
            (parts, "K3 luma (to the scaled size)", lambda: window.remap_window_px(slw, yl)),
            (parts, "K3 chroma (U+V)", lambda: window.remap_window_px(scw, cl)),
            (parts, "K4 luma", lambda: area.area_px(slt.area, yr)),
            (parts, "K4 chroma (U+V)", lambda: area.area_px(sct.area, cr)),
            (aside, "area_plain luma", lambda: area.area_plain(slt.area, yr)),
            (aside, "area_plain chroma (U+V)", lambda: area.area_plain(sct.area, cr)),
            (aside, "avg_pool2d luma", lambda: avg_pool2d(yrf, 2)),
            (aside, "avg_pool2d chroma (U+V)", lambda: avg_pool2d(crf, 2)),
        ):
            cuda_times(fn, 2)
            d[name] = statistics.median(cuda_times(fn, 10 if b > 1 else 50))
        k4b = area_bound(slt.area, b, 1)[0] + area_bound(sct.area, 2 * b, 1)[0]
        k4 = parts["K4 luma"] + parts["K4 chroma (U+V)"]
        k3b = [remap_bound(remap_ref(pp), n, tensor_bytes(w.meta, w.pos, w.fy, w.fx, w.wtab))
               for pp, w, n in ((sp.luma, slw, b), (sp.chroma, scw, 2 * b))]
        k3 = parts["K3 luma (to the scaled size)"] + parts["K3 chroma (U+V)"]
        say(f"[10] supersampled batch-{b} stages, device medians: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
            + f"; sum {sum(parts.values()):.4f} ms; K3 luma + chroma at the scaled size "
            f"{k3:.4f} ms against their bound {k3b[0][0]:.4f} + {k3b[1][0]:.4f} ms "
            f"({k3b[0][1]}, {k3b[1][1]}; {(k3b[0][0] + k3b[1][0]) / k3:.1%}); "
            f"K4 luma + chroma {k4:.4f} ms against their "
            f"byte bound {k4b:.4f} ms ({k4b / k4:.1%}); beside them, not on the path: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in aside.items())
            + f"  ({smi})")
        if b == 1:  # one frame: events read the host's issue, a replayed graph the card
            k4g = graph_ms(lambda: (area.area_px(slt.area, yr), area.area_px(sct.area, cr)), 20)
            k4lg = graph_ms(lambda: area.area_px(slt.area, yr), 20)
            x1 = [yb[:1], ub[:1], vb[:1]]
            fg = graph_ms(lambda: pipeline_mod.transform_frame_planes(sp, x1))
            say(f"[10] one supersampled frame as a replayed CUDA graph: the step {fg:.4f} ms; "
                f"K4 luma {k4lg:.4f} ms, luma + chroma {k4g:.4f} ms against their byte bound "
                f"{k4b:.4f} ms ({k4b / k4g:.1%})  ({smi})")
        del yl, cl, yr, cr, yrf, crf
    # K4 alone on 16 luma frames at the scaled size, as K1 and K3 in phase 5
    xs8 = window.remap_window_px(slw, blur.blur_px(slt.blur, yb[:tb].contiguous()))
    dslt = dsp.luma.tables("cuda")
    xs16 = window.remap_window_px(dsp.luma.window_tables("cuda"),
                                  blur.blur_px(dslt.blur, ydb[:tb].contiguous(), 1023), 1023)
    library, events_ms = {}, {}
    for name, da, xa, mx in (("area", slt.area, xs8, 255), ("area_u16", dslt.area, xs16, 1023)):
        xaf = xa.float()
        km, pm, ks = in_turns(lambda: area.area_px(da, xa, mx),
                              lambda: area.area_plain(da, xa, mx), rounds=5)
        # a call of K4 here is as short as the host's issue of it: the
        # kernels line takes its device time, 20 calls in a replayed graph
        kg = graph_ms(lambda: area.area_px(da, xa, mx), 20)
        cuda_times(lambda: avg_pool2d(xaf, 2), 2)
        library[name] = statistics.median(cuda_times(lambda: avg_pool2d(xaf, 2), 20))
        times[name] = (kg, pm)
        events_ms[name] = km
        bounds[name] = area_bound(da, tb, xa.element_size())
        say(f"[10] {name}: kernel {kg:.4f} ms as a replayed CUDA graph, {bounds[name][0] / kg:.1%} "
            f"of the bound; by events in turns median {km:.4f} ms (p75 {pct(ks, 0.75):.4f}, "
            f"n={len(ks)}), plain median {pm:.4f} ms, avg_pool2d on a float32 copy "
            f"{library[name]:.4f} ms, "
            f"per call on {tb} {'10-bit ' if mx > 255 else ''}luma frames {da.in_w}x{da.in_h} -> "
            f"{da.out_shape[1]}x{da.out_shape[0]}; bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}), {bounds[name][0] / km:.1%} of it reached  ({smi})")
        del xaf
    del xs8, xs16

    # -- 11. plan files ----------------------------------------------------
    from transform360_tpu_torch import plan as tplan
    from transform360_tpu_torch.pipeline import transform_batch

    def cold_plan(make):
        """(plan, seconds): ``make()`` and the remap's tile plans and
        tables on the card, from a cleared plan cache."""
        tplan.clear_plan_cache()
        t0 = time.perf_counter()
        p = make()
        for pp in (p.luma, p.chroma):
            pp.tables("cuda")
            pp.window_tables("cuda")
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.npz")
        built, t_build = cold_plan(lambda: build_plan(plan.cfg, IN_W, IN_H, plan.out_w,
                                                      plan.out_h, "yuv420p"))
        t0 = time.perf_counter()
        tplan.save_plan(built, path)
        t_save = time.perf_counter() - t0
        loaded, t_load = cold_plan(lambda: tplan.load_plan(path))
        a = transform_batch(built, yb[:8], ub[:8], vb[:8])
        b = transform_batch(loaded, yb[:8], ub[:8], vb[:8])
        if not all(torch.equal(x, z) for x, z in zip(a, b)):
            raise SystemExit("FAIL the loaded plan's output differs from the built plan's")
        say(f"[11] plan files, flagship: build_plan + tile plans + tables on the card "
            f"{t_build:.3f} s; save_plan {t_save:.3f} s ({os.path.getsize(path)} B); load_plan "
            f"+ tile plans + tables {t_load:.3f} s; the loaded plan's output equals the built "
            f"plan's on 8 frames  ({smi})")
        src = os.path.join(tmp, "in.yuv")
        n_pf = 4
        write_yuv420_batch(src, *(t[:n_pf].cpu().numpy() for t in (yb, ub, vb)))
        api = [o.cpu().numpy() for o in eng.transform(yb[:n_pf], ub[:n_pf], vb[:n_pf])]
        want = b"".join(api[p][k].tobytes() for k in range(n_pf) for p in range(3))
        common = ["--vf", FLAGSHIP, "--input-size", f"{IN_W}x{IN_H}", "-i", src,
                  "--batch", "4", "--device", "cuda"]
        walls = {}
        for flag in ("--save-plan", "--load-plan"):
            out = os.path.join(tmp, f"out{flag}.yuv")
            t0 = time.perf_counter()
            rc = cli.main(common + ["-o", out, flag, path])
            walls[flag] = time.perf_counter() - t0
            with open(out, "rb") as f:
                got = f.read()
            if rc != 0 or got != want:
                raise SystemExit(f"FAIL CLI {flag}: rc {rc}, output "
                                 f"{'equals' if got == want else 'differs from'} the API's")
        say(f"[11] CLI {n_pf} frames with --save-plan, then --load-plan: output bytes equal "
            f"the API's; wall {walls['--save-plan']:.3f} s and {walls['--load-plan']:.3f} s "
            f"(plan, kernels' first calls and file IO included)  ({smi})")

    # -- 12. fidelity gate ---------------------------------------------------
    from transform360_tpu_torch import fidelity

    fx = fidelity.load_fixture()
    gplans = fidelity.case_plans()
    gplanes = fidelity._video_like_planes(*fidelity.GATE_IN)
    t0 = time.perf_counter()
    plain_gate = fidelity.run_gate(gplans, gplanes, 1, "cpu")
    t_plain = time.perf_counter() - t0
    plain_res = fidelity.score(plain_gate, fx.want)
    for b in (12, 1):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = fidelity.bench_fidelity(device="cuda", batch=b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gate_launches = read_counts()
        if (gate_launches["blur"] <= 0 or gate_launches["window"] <= 0
                or gate_launches["blur_u16"] or gate_launches["window_u16"]):
            raise SystemExit(f"FAIL the fidelity gate at batch {b} did not launch only K1 and "
                             f"K3 uint8: {gate_launches}")
        card = fidelity.run_gate(gplans, gplanes, b, "cuda")  # every frame == frame 0
        gate_err = 0
        for name, runs in card.items():
            for run in runs:
                for pname, g, w in zip("YUV", run, plain_gate[name][0]):
                    gate_err = max(gate_err, compare(torch.from_numpy(g), torch.from_numpy(w),
                                                     f"gate {name} {pname} batch {b}"))
        if res != plain_res:
            raise SystemExit(f"FAIL the gate on the card {res} differs from the plain path's "
                             f"{plain_res}")
        dbs = dict(res["configs"], flagship=min(res[p] for p in "YUV"))
        low = {n: (db, fx.jax_db[n]) for n, db in dbs.items() if db < fx.jax_db[n] - 0.1}
        say(f"[12] fidelity gate {fidelity.GATE_IN[0]}x{fidelity.GATE_IN[1]} -> "
            f"{fidelity.GATE_OUT[0]}x{fidelity.GATE_OUT[1]}, batch {b}: worst {res['worst_db']:.4f}"
            f" dB (Y {res['Y']:.4f}, U {res['U']:.4f}, V {res['V']:.4f}); per case, port / JAX "
            f"package (fixture) dB: "
            + ", ".join(f"{n} {db:.4f} / {fx.jax_db[n]:.4f}" for n, db in dbs.items())
            + f"; card vs plain path max |diff| {gate_err} LSB, every frame equals frame 0; "
            f"launches {gate_launches}; wall {wall:.3f} s (plain path on the CPU at batch 1: "
            f"{t_plain:.3f} s)  ({smi})")
        if res["worst_db"] < 50.0 or low:
            raise SystemExit(f"FAIL fidelity gate at batch {b}: worst {res['worst_db']:.4f} dB; "
                             f"more than 0.1 dB under the JAX package: {low}")

    # -- 13. the drop-in ffmpeg wrapper --------------------------------------
    from transform360_tpu_torch import ffmpeg as wrapper
    from transform360_tpu_torch.ops._build import BUILD_DIR

    n_ff = 8
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    old_path = os.environ.get("PATH", "")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        write_stubs(os.path.join(tmp, "bin"))
        os.environ["PATH"] = os.path.join(tmp, "bin") + os.pathsep + old_path
        try:
            say(f"[13] ffmpeg on PATH: {shutil.which('ffmpeg')} (a stub: probe, rawvideo "
                f"decode and encode only); ffprobe: {shutil.which('ffprobe')}")
            runs = []
            src = os.path.join(tmp, "in.mp4")  # raw yuv420p bytes under the user's file name
            write_yuv420_batch(src, *(t[:n_ff].cpu().numpy() for t in (yb, ub, vb)))
            api = [o.cpu().numpy() for o in eng.transform(yb[:n_ff], ub[:n_ff], vb[:n_ff])]
            want8 = b"".join(api[p][k].tobytes() for k in range(n_ff) for p in range(3))
            runs += [(f"yuv420p, --t360-batch {b}", "yuv420p", src, b, want8) for b in (1, 8)]
            src10 = os.path.join(tmp, "in10.mkv")
            write_yuv420_batch(src10, *(t[:n_ff].cpu().numpy() for t in (ydb, udb, vdb)))
            api = [o.cpu().numpy().astype("<u2")
                   for o in deep.transform(ydb[:n_ff], udb[:n_ff], vdb[:n_ff])]
            want10 = b"".join(api[p][k].tobytes() for k in range(n_ff) for p in range(3))
            runs.append(("yuv420p10le, --t360-batch 8", "yuv420p10le", src10, 8, want10))
            for what, fmt, path, b, want in runs:
                os.environ["T360_STUB_PIX_FMT"] = fmt
                out = os.path.join(tmp, "out.mp4")
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                rc = wrapper.main(["--t360-batch", str(b), "-y", "-i", path, "-vf",
                                   f"transform360={FLAGSHIP}", out])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                ff_launches = read_counts()
                with open(out, "rb") as f:
                    got = f.read()
                if rc != 0 or got != want:
                    raise SystemExit(f"FAIL ffmpeg wrapper {what}: rc {rc}, output "
                                     f"{'equals' if got == want else 'differs from'} the API's")
                k8 = ff_launches["blur"] > 0 and ff_launches["window"] > 0
                k16 = ff_launches["blur_u16"] > 0 and ff_launches["window_u16"] > 0
                ok = (k16 and not ff_launches["blur"] and not ff_launches["window"]
                      if fmt != "yuv420p" else
                      k8 and not ff_launches["blur_u16"] and not ff_launches["window_u16"])
                if not ok:
                    raise SystemExit(f"FAIL ffmpeg wrapper {what} launches {ff_launches}")
                say(f"[13] ffmpeg wrapper, {what}: {n_ff} frames {IN_W}x{IN_H}, output bytes "
                    f"equal the API's; launches {ff_launches}; wall {dt * 1e3 / n_ff:.2f} ms "
                    f"per frame (plan, pipes and file IO included)  ({smi})")
        finally:
            os.environ["PATH"] = old_path
            os.environ.pop("T360_STUB_PIX_FMT", None)

    # -- 14. batch sharding over a mesh -------------------------------------
    from transform360_tpu_torch import pipeline
    from transform360_tpu_torch.parallel import make_mesh, transform_batch_sharded

    for mname, mesh in (("make_mesh()", make_mesh()), ('["cuda:0"] * 2', make_mesh(["cuda:0"] * 2))):
        d = len(mesh.devices)
        k3_per_frame = k3_launches(plan, BATCH // d)
        torch.cuda.synchronize()
        reset_counts()
        outs = transform_batch_sharded(mesh, plan, yb, ub, vb)
        torch.cuda.synchronize()
        mesh_launches = read_counts()
        if (mesh_launches["blur"] != 2 * d or mesh_launches["window"] != k3_per_frame * d
                or mesh_launches["blur_u16"] or mesh_launches["window_u16"]):
            raise SystemExit(f"FAIL mesh {mname} launches {mesh_launches}, not K1 2 and K3 "
                             f"{k3_per_frame} per shard")
        for pname, o, w in zip("YUV", outs, (oy, ou, ov)):
            for off, s in zip(o.offsets, o.shards):
                if not torch.equal(s, w[off:off + s.shape[0]]):
                    raise SystemExit(f"FAIL mesh {mname} {pname} shard at {off} differs from "
                                     f"the unsharded batch")
        api = open_filter(FLAGSHIP, IN_W, IN_H, mesh=mesh, device="cuda").transform(yb, ub, vb)
        if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(api, outs)):
            raise SystemExit(f"FAIL open_filter(mesh={mname}) differs from transform_batch_sharded")
        del outs, api
        msteps, usteps = [], []
        cuda_times(lambda: transform_batch_sharded(mesh, plan, yb, ub, vb), 2)
        for _ in range(10):  # the unsharded step in turns with the sharded one
            usteps += cuda_times(lambda: eng.transform(yb, ub, vb), 3)
            msteps += cuda_times(lambda: transform_batch_sharded(mesh, plan, yb, ub, vb), 3)
        mgraph = graph_ms(lambda: transform_batch_sharded(mesh, plan, yb, ub, vb), 2, 5)
        ugraph = graph_ms(lambda: eng.transform(yb, ub, vb), 2, 5)
        say(f"[14] mesh {mname} ({d} shard(s) of {BATCH // d} on "
            f"{sorted(set(str(x) for x in mesh.devices))}), batch {BATCH}: every shard equals its "
            f"frames of the unsharded batch, open_filter(mesh=) equals it; launches "
            f"{mesh_launches} (K1 2 and K3 {k3_per_frame} per shard); step by CUDA events "
            f"median {statistics.median(msteps):.4f} ms (p90 {pct(msteps, 0.9):.4f}, "
            f"n={len(msteps)}), the unsharded step in turns {statistics.median(usteps):.4f} (p90 "
            f"{pct(usteps, 0.9):.4f}, n={len(usteps)}; phase 5: {step:.4f}); as a replayed CUDA "
            f"graph (device only) {mgraph:.4f} against unsharded {ugraph:.4f}  ({smi})")

    # -- 15. latency bands on the card ---------------------------------------
    one_frame = (y1, u1, v1)  # phase 6's [H, W] planes on the card
    unbanded = [t.cpu().numpy() for t in (ly, lu, lv)]  # phase 6's unbanded frame
    x1s = [p[None] for p in one_frame]
    frame_graph = graph_ms(lambda: pipeline.transform_frame_planes(plan, x1s))
    frame_issue = issue_ms(alternating(lambda *f: pipeline.transform_frame_planes(plan, f), x1s,
                                       [p[1:2] for p in (yb, ub, vb)]))
    lb1 = blur.blur_px(luma_t.blur, x1s[0])
    cb1 = blur.blur_px(chroma_t.blur, tuple(x1s[1:]))
    k3_graph = graph_ms(lambda: (window.remap_window_px(luma_w, lb1),
                                 window.remap_window_px(chroma_w, cb1)))
    band_rows = {}
    for n in (2, 4, 8):
        for costs in (None, "auto"):
            edges = "uniform" if costs is None else "cost model"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = latency.transform_frame_banded(plan, one_frame, n=n, row_costs=costs)
            first_wall = time.perf_counter() - t0
            bands = latency.band_plans(plan, n, costs)
            if len(bands) != n or any(not np.array_equal(g, w) for g, w in zip(got, unbanded)):
                raise SystemExit(f"FAIL {n} bands ({edges}) differ from the unbanded frame")
            want_k3 = sum(k3_launches(b, 1) for b in bands)
            torch.cuda.synchronize()
            reset_counts()
            latency.transform_frame_banded_async(plan, one_frame, n=n, row_costs=costs)
            torch.cuda.synchronize()
            bl = read_counts()
            if bl["blur"] != 2 * n or bl["window"] != want_k3 or bl["blur_u16"] or bl["window_u16"]:
                raise SystemExit(f"FAIL {n} bands ({edges}) launches {bl}, not K1 {2 * n} and "
                                 f"K3 {want_k3}")
            # the device memory that the bands' graphs hold once captured
            # anew on the frame where it lies (their tables built before)
            pipeline.clear_executor_cache()
            for b in bands:
                pipeline.device_put_plan(b, one_frame[0].device)
            torch.cuda.synchronize()
            a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            latency.transform_frame_banded(plan, one_frame, n=n, row_costs=costs)
            torch.cuda.synchronize()
            band_held = (torch.cuda.memory_allocated() - a0) / 2**20
            band_pool = (torch.cuda.memory_reserved() - r0) / 2**20
            read_counts()
            xs = [p[None] for p in one_frame]
            xs2 = [p[1:2] for p in (yb, ub, vb)]  # another frame, for replays that re-point
            dev = xs[0].device  # the device key the banded path built the tables under
            per_band, k3_band, issue = [], [], []
            for b in bands:
                per_band.append(graph_ms(lambda: pipeline.transform_frame_planes(b, xs)))
                issue.append(issue_ms(alternating(
                    lambda *f: pipeline.transform_frame_planes(b, f), xs, xs2)))
                lb = blur.blur_px(b.luma.tables(dev).blur, xs[0])
                cbl = blur.blur_px(b.chroma.tables(dev).blur, tuple(xs[1:]))
                lwt, cwt = b.luma.window_tables(dev), b.chroma.window_tables(dev)
                k3_band.append(graph_ms(lambda: (window.remap_window_px(lwt, lb),
                                                 window.remap_window_px(cwt, cbl))))
            whole_graph = graph_ms(lambda: [pipeline.transform_frame_planes(b, xs) for b in bands],
                                   calls=3)
            cuda_times(lambda: latency.transform_frame_banded_async(plan, one_frame, n=n,
                                                                    row_costs=costs), 3)
            whole = cuda_times(lambda: latency.transform_frame_banded_async(
                plan, one_frame, n=n, row_costs=costs), 50)
            walls = host_walls(lambda: latency.transform_frame_banded(
                plan, one_frame, n=n, row_costs=costs), 20)
            band_rows[(n, edges)] = (max(per_band), sum(issue))
            say(f"[15] {n} bands, {edges} edges (luma rows "
                f"{[b.luma.out_h for b in bands]}): bytes equal the unbanded frame; launches "
                f"{bl}; per band, device ms as a replayed CUDA graph "
                f"{[round(t, 4) for t in per_band]}, max(band) {max(per_band):.4f}, sum "
                f"{sum(per_band):.4f} (the unbanded frame {frame_graph:.4f}); K3 alone per band "
                f"(luma + chroma, graph) {[round(t, 4) for t in k3_band]}, max {max(k3_band):.4f}, "
                f"sum {sum(k3_band):.4f} (unbanded {k3_graph:.4f}); host issue per band, calls "
                f"back to back on two frames in turn {[round(t, 4) for t in issue]}, sum "
                f"{sum(issue):.4f} (unbanded "
                f"{frame_issue:.4f}); whole banded frame as a graph {whole_graph:.4f}, by CUDA "
                f"events around the dispatch median {statistics.median(whole):.4f} (p90 "
                f"{pct(whole, 0.9):.4f}, n={len(whole)}; phase 6's unbanded {frame_ms:.4f}); host "
                f"wall to numpy planes {statistics.median(walls):.4f} ms; first call "
                f"{first_wall:.3f} s (band plans, tile plans and tables built); device memory "
                f"after the band graphs' capture: "
                f"allocated {band_held:.2f} MiB (no static input or output), reserved "
                f"{band_pool:.1f} MiB (the graph pool's intermediates)  ({smi})")
    # the pinned host-to-device rate of one frame's planes: the host term of broadcast_ms
    pinned = [torch.from_numpy(p).pin_memory() for p in (y, u, v)]
    pageable = [torch.from_numpy(p) for p in (y, u, v)]
    nbytes = tensor_bytes(*pinned)
    rates = {"pinned": h2d_gbps(pinned), "pageable": h2d_gbps(pageable)}
    bc = latency.broadcast_ms(plan, IN_W, IN_H, 1, host_gbps=rates["pinned"])
    say(f"[15] host to device, one 4K yuv420p frame ({nbytes} B): pinned {rates['pinned']:.2f} "
        f"GB/s, pageable {rates['pageable']:.2f} GB/s; broadcast_ms to one card at the pinned "
        f"rate {bc:.4f} ms; one-card projection of N-card banded latency, uniform edges, "
        f"max(band) + broadcast_ms (the card-to-card term not measured), beside the host's "
        f"issue of all N bands from one thread + broadcast_ms: "
        + ", ".join(f"N={n} {band_rows[(n, 'uniform')][0] + bc:.4f} / "
                    f"{band_rows[(n, 'uniform')][1] + bc:.4f} ms" for n in (2, 4, 8))
        + f" (unbanded on one card {frame_graph + bc:.4f} / {frame_issue + bc:.4f})  ({smi})")
    del pinned, pageable
    for what, p, planes, n, eng_ in (
            ("supersampled 2x2", sp, (yb[0], ub[0], vb[0]), 3, ss),
            ("10-bit", dp, (ydb[0], udb[0], vdb[0]), 2, deep)):
        want = [t.cpu().numpy() for t in eng_.transform(*planes)]
        torch.cuda.synchronize()
        reset_counts()
        got = latency.transform_frame_banded(p, planes, n=n, row_costs="auto")
        torch.cuda.synchronize()
        bl = read_counts()
        if any(not np.array_equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"FAIL {what} flagship in {n} bands differs from its unbanded frame")
        k1 = bl["blur_u16"] if p.luma.depth > 8 else bl["blur"]
        k4 = 2 * n if p.luma.area is not None else 0  # K4 per band and plane batch
        if k1 != 2 * n or bl["area"] + bl["area_u16"] != k4:
            raise SystemExit(f"FAIL {what} flagship in {n} bands launches {bl}")
        say(f"[15] {what} flagship in {n} bands, cost-model edges (luma rows "
            f"{[b.luma.out_h for b in latency.band_plans(p, n, 'auto')]}): bytes equal its "
            f"unbanded frame; launches {bl}  ({smi})")

    # -- 16. two processes on the one card ----------------------------------
    from transform360_tpu_torch.utils.yuv import read_yuv420_batch

    mp_vf = FLAGSHIP.replace("=512", "=160")
    mp_w, mp_h, n_mp = 1920, 960, 8
    mp_plan = open_filter(mp_vf, mp_w, mp_h, device="cuda").plan
    ow, oh = mp_plan.out_w, mp_plan.out_h
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src = os.path.join(tmp, "in.yuv")
        gy, gu, gv = video_like_planes(mp_w, mp_h)
        write_yuv420_batch(src, *(np.stack([np.roll(p, 7 * k, axis=1) for k in range(n_mp)])
                                  for p in (gy, gu, gv)))
        common = ["--vf", mp_vf, "--input-size", f"{mp_w}x{mp_h}", "-i", src, "--device", "cuda"]
        if cli.main(common + ["-o", os.path.join(tmp, "one.yuv"), "--batch", "4"]) != 0:
            raise SystemExit("FAIL the one-process CLI run")
        want = read_yuv420_batch(os.path.join(tmp, "one.yuv"), ow, oh)
        env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for mode, flags in (("batch", ["--batch", "4"]), ("banded", ["--latency-bands", "2"])):
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                port = s_.getsockname()[1]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "transform360_tpu_torch.cli", *common, *flags,
                 "-o", os.path.join(tmp, f"{mode}{pid}.yuv"),
                 "--distributed", f"127.0.0.1:{port},2,{pid}"],
                cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for pid in range(2)]
            try:
                logs = [p.communicate(timeout=240)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            mp_wall = time.perf_counter() - t0
            for pid, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise SystemExit(f"FAIL {mode} rank {pid} rc {p.returncode}:\n{log[-3000:]}")
            if mode == "batch":  # rank p holds frames [2p, 2p + 2) of every batch of 4
                parts = [read_yuv420_batch(os.path.join(tmp, f"batch{pid}.yuv"), ow, oh)
                         for pid in range(2)]
                got = [np.concatenate([parts[k % 2][j][2 * (k // 2):2 * (k // 2) + 2]
                                       for k in range(n_mp // 2)]) for j in range(3)]
            else:  # rank p holds band p's rows of every frame
                bands = latency.band_plans(mp_plan, 2)
                got = [[], [], []]
                for pid, b in enumerate(bands):
                    raw = np.fromfile(os.path.join(tmp, f"banded{pid}.yuv"), np.uint8)
                    shapes = [(b.luma.out_h, ow)] + 2 * [(b.chroma.out_h, ow // 2)]
                    frames_ = raw.reshape(n_mp, -1)
                    off = 0
                    for j, (h_, w_) in enumerate(shapes):
                        got[j].append(frames_[:, off:off + h_ * w_].reshape(n_mp, h_, w_))
                        off += h_ * w_
                got = [np.concatenate(g, axis=1) for g in got]
            if any(not np.array_equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"FAIL two processes ({mode}) stitched differ from one process")
            say(f"[16] two processes on {kind} (gloo rendezvous, both ranks on cuda:0), CLI "
                f"{mode} mode {' '.join(flags)}, {n_mp} frames {mp_w}x{mp_h} -> {ow}x{oh}: the "
                f"ranks' outputs stitched equal one process's bytes; wall {mp_wall:.2f} s for "
                f"both processes (start, kernel load, plan and file IO included)  ({smi})")

    # -- 17. the native engine on the host's CPU ----------------------------
    from transform360_tpu_torch import native
    from transform360_tpu_torch.geometry import build_warp_map

    cpu = cpu_model()
    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit(f"FAIL the native engine did not build: {native.build_error()}")
    t_nat = time.perf_counter() - t0
    built = _build.BUILD_SECONDS.get("t360")
    say(f"[17] host CPU: {cpu}, os.cpu_count() {os.cpu_count()}; native engine "
        f"native/t360.cpp {'built in ' + format(built, '.2f') + ' s' if built else 'found built'} "
        f"({' '.join(_build.cxx_command() + list(_build.CXX_FLAGS))}; loaded in {t_nat:.2f} s)")
    n_nat = 8
    host = [t[:n_nat].cpu() for t in (yb, ub, vb)]  # phase 4's first frames, on the host
    card = [t[:n_nat].cpu() for t in (oy, ou, ov)]  # the card's bytes for them (phase 4)
    nat = open_filter(FLAGSHIP, IN_W, IN_H, backend="native")
    t0 = time.perf_counter()
    pooled = nat.transform(*host)  # the frame pool; maps generated on this first call
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = nat.transform(*host)
    t_pool = time.perf_counter() - t0
    nat.transform(*(h[0] for h in host))
    t0 = time.perf_counter()
    single = nat.transform(*(h[0] for h in host))
    t_single = time.perf_counter() - t0
    if any(o.dtype != torch.uint8 or o.device.type != "cpu" for o in pooled + single):
        raise SystemExit("FAIL the native engine's outputs are not CPU uint8 tensors")
    stats = []
    for pname, a, b, one in zip("YUV", pooled, card, single):
        if tuple(a.shape) != tuple(b.shape) or not torch.equal(one, a[0]):
            raise SystemExit(f"FAIL native {pname}: shape {tuple(a.shape)} against the card's "
                             f"{tuple(b.shape)}, or one [H, W] frame differs from frame 0 of "
                             f"the pool")
        d = (a.int() - b.int()).abs()
        mse = float((d.double() ** 2).mean())
        db = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        stats.append((pname, db, float((d > 0).double().mean()), int(d.max())))
    worst_db = min(db for _, db, _, _ in stats)
    worst_diff = max(fr for _, _, fr, _ in stats)
    nm = native.NativeTransform(plan.cfg)
    nm.generate_map_for_plane(IN_W, IN_H, plan.out_w, plan.out_h, 0)
    map_err = float(np.abs(nm.export_warp_map(0) - build_warp_map(
        plan.cfg, IN_W, IN_H, plan.out_w, plan.out_h).numpy()).max())
    try:
        open_filter(FLAGSHIP, IN_W, IN_H, backend="native",
                    pix_fmt="yuv420p10le").transform(*(t[0] for t in (ydb, udb, vdb)))
        refused = False
    except ValueError:
        refused = True
    say(f"[17] native engine vs the card, {n_nat} video-like frames {IN_W}x{IN_H} -> "
        f"{plan.out_w}x{plan.out_h} (flagship): "
        + ", ".join(f"{pn} {db:.2f} dB, {fr:.6f} of pixels differ, max |diff| {mx}"
                    for pn, db, fr, mx in stats)
        + f"; one [H, W] frame equals frame 0 of the pool; luma warp map vs the port's: max "
        f"|diff| {map_err:.6f} px (bound {1 / 32 + 1e-3:.6f}); 10-bit refused: {refused}")
    say(f"[17] native wall on {cpu} ({os.cpu_count()} cores): first call (maps + {n_nat} "
        f"frames) {t_first:.3f} s; frame pool {t_pool * 1e3 / n_nat:.1f} ms per frame "
        f"({n_nat} frames, {t_pool:.3f} s); one [H, W] frame {t_single * 1e3:.1f} ms")
    if worst_db < 50.0 or worst_diff > 0.01 or map_err >= 1 / 32 + 1e-3 or not refused:
        raise SystemExit(f"FAIL native engine vs the card: worst {worst_db:.2f} dB (bound 50), "
                         f"{worst_diff:.6f} of pixels differ (bound 0.01), warp map "
                         f"{map_err:.6f} px, 10-bit refused {refused}")
    del host, card, pooled, single, nm

    # -- 18. profiling the card ---------------------------------------------
    from transform360_tpu_torch.utils.profiling import device_trace, time_frame_step, trace_kernels

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        eng.transform(yb, ub, vb)
        torch.cuda.synchronize()
        reset_counts()
        with device_trace(tmp) as trace:
            eng.transform(yb, ub, vb)
        traced = read_counts()
        found = trace_kernels(trace)
        size = os.path.getsize(trace)
    k1 = [v for n, v in found.items() if "blur_ring_kernel" in n or "blur_direct_kernel" in n]
    k3 = [v for n, v in found.items() if "window_kernel" in n]
    n1, ms1 = sum(c for c, _ in k1), sum(m for _, m in k1)
    n3, ms3 = sum(c for c, _ in k3), sum(m for _, m in k3)
    say(f"[18] torch.profiler trace of one batch-{BATCH} flagship step ({size} B): K1 {n1} "
        f"launches, {ms1:.4f} ms; K3 {n3} launches, {ms3:.4f} ms; the counters read {traced}; "
        f"every kernel in it: "
        + ", ".join(f"{n[:90]} x{c} {m:.4f} ms" for n, (c, m) in sorted(found.items()))
        + f"; phase 5's stages by CUDA events: K1 {stages_b128['K1 luma'] + stages_b128['K1 chroma (U, V in place)']:.4f}"
        f" ms, K3 {stages_b128['K3 luma'] + stages_b128['K3 chroma (U+V)']:.4f} ms  ({smi})")
    if n1 != 2 or n3 != k3_launches(plan, BATCH) or (traced["blur"], traced["window"]) != (n1, n3):
        raise SystemExit(f"FAIL the trace holds K1 {n1} and K3 {n3} launches (want 2 and "
                         f"{k3_launches(plan, BATCH)}, as the counters read: {traced})")
    others = sorted(n for n in found if not any(
        k in n for k in ("blur_ring_kernel", "blur_direct_kernel", "window_kernel")))
    if others:  # no cat of U and V, no elementwise copy
        raise SystemExit(f"FAIL the batch-{BATCH} step's trace holds kernels other than K1 and "
                         f"K3: {others}")
    chain128 = time_frame_step(plan, yb, ub, vb) * 1e3
    chain1 = time_frame_step(plan, y1, u1, v1) * 1e3
    say(f"[18] time_frame_step (chain difference, 2 and 26 steps, best of 3): batch {BATCH} "
        f"{chain128:.4f} ms per step (phase 5's device median {step:.4f}); batch 1 "
        f"{chain1:.4f} ms (phase 6 by CUDA events {frame_ms:.4f}, phase 15 as a replayed CUDA "
        f"graph {frame_graph:.4f})  ({smi})")

    # -- 19. executors -------------------------------------------------------
    import contextlib

    gmax = pipeline.GRAPH_MAX_BATCH
    reset_counts()

    @contextlib.contextmanager
    def graphs_upto(n):
        """The executors with GRAPH_MAX_BATCH = n (0: every call eager)."""
        keep = pipeline.GRAPH_MAX_BATCH
        pipeline.GRAPH_MAX_BATCH = n
        try:
            yield
        finally:
            pipeline.GRAPH_MAX_BATCH = keep

    def replayed(plan_, b):
        """True when the executors of the plan hold captured graphs for b
        frames (luma b planes, the stacked chroma 2b)."""
        return all(any(type(g).__name__ == "_Graph" and k[0][0] == n for k, g in
                       pipeline.plane_executor(pp, "cuda")._by_shape.items())
                   for pp, n in ((plan_.luma, b), (plan_.chroma, 2 * b)))

    def program_nodes(plan_, b):
        """The nodes that one replay of the plan's graphs for b frames of
        packed, aligned card planes re-points when its planes and output
        are new: each program's nodes on the caller's memory."""
        return sum(len(g.program.nodes)
                   for pp, n in ((plan_.luma, b), (plan_.chroma, 2 * b))
                   for k, g in pipeline.plane_executor(pp, "cuda")._by_shape.items()
                   if type(g).__name__ == "_Graph" and k[0][0] == n and len(k) == 4)

    def max_lsb(got, want):
        return max(int((a.int() - w.int()).abs().max()) for a, w in zip(got, want))

    def np_lsb(got, want):
        return max(int(np.abs(g.astype(int) - w.astype(int)).max()) for g, w in zip(got, want))

    # three replays on two sets of planes in turn (B A B after the capture
    # on A), every output kept: each replay reads other planes and writes
    # another block than the last, so every node on the caller's memory is
    # re-pointed each time; the first output is compared after the later
    # calls, which must not have touched it
    same, updated = [], []
    for what, e, planes in (("flagship", eng, (yb, ub, vb)), ("10-bit", deep, (ydb, udb, vdb)),
                            ("supersampled 2x2", ss, (yb, ub, vb))):
        for b in sorted({1, 2, 8, gmax}):
            sets = [[t[k * b:(k + 1) * b] for t in planes] for k in (0, 1)]
            with graphs_upto(max(gmax, b)):
                # the first call of a shape is eager and captures the graph; its
                # output is kept, as are the later ones
                warm = e.transform(*sets[0])
                u0 = COUNTERS["nodes.updates"]
                got = [e.transform(*sets[k]) for k in (1, 0, 1)]
                upd = COUNTERS["nodes.updates"] - u0
            if not replayed(e.plan, b):
                raise SystemExit(f"FAIL {what} batch {b} did not replay a captured graph")
            full = program_nodes(e.plan, b)
            updated.append(f"{what} b={b} {upd}/{3 * full}")
            if upd != 3 * full:
                raise SystemExit(f"FAIL {what} batch {b}: 3 replays on other planes made {upd} "
                                 f"node updates, not {3 * full}")
            with graphs_upto(0):
                want = [e.transform(*sets[k]) for k in (1, 0)]
            same.append((f"{what} b={b}", max(max_lsb(got[0], want[0]), max_lsb(got[1], want[1]),
                                              max_lsb(got[2], want[0]))))
            del warm, got, want
    frames2 = (one_frame, tuple(t[1] for t in (yb, ub, vb)))
    for n in (2, 4, 8):
        warm = latency.transform_frame_banded_async(plan, frames2[0], n=n)  # kept, as are the rest
        u0 = COUNTERS["nodes.updates"]
        inflight = [latency.transform_frame_banded_async(plan, frames2[k], n=n) for k in (1, 0, 1)]
        upd = COUNTERS["nodes.updates"] - u0
        bands = latency.band_plans(plan, n)
        if not all(replayed(band, 1) for band in bands):
            raise SystemExit(f"FAIL {n} bands did not replay captured graphs")
        full = sum(program_nodes(band, 1) for band in bands)
        updated.append(f"{n} bands {upd}/{3 * full}")
        if upd != 3 * full:
            raise SystemExit(f"FAIL {n} bands: 3 replays on other frames made {upd} node "
                             f"updates, not {3 * full}")
        got = [f.gather() for f in inflight]
        del warm
        with graphs_upto(0):
            want = [latency.transform_frame_banded(plan, frames2[k], n=n) for k in (1, 0)]
        same.append((f"{n} bands", max(np_lsb(got[0], want[0]), np_lsb(got[1], want[1]),
                                       np_lsb(got[2], want[0]))))
    say(f"[19] executors (GRAPH_MAX_BATCH {gmax}): replayed CUDA graph on two sets of planes in "
        f"turn vs eager program, max |diff| in LSB: " + ", ".join(f"{k} {v}" for k, v in same)
        + f"; node updates in 3 replays / the nodes on the caller's memory x 3: "
        + ", ".join(updated))
    if any(v for _, v in same):
        raise SystemExit(f"FAIL executor replays differ from the eager program: {same}")

    last_updates = {}

    def both(fn, measure, rounds=4, full=None):
        """(eager, executor) medians of measure(fn) in turns: eager,
        executor, executor, eager, ...  With ``full``, the nodes one
        replay re-points when its planes and output are new, the executor's
        node updates per call must be at least 0.9 of it (a call whose
        planes or output block happen to be its graph's last is spared
        theirs), and last_updates["per_call"] holds them."""
        res = {"eager": [], "executor": []}
        calls, upd, n = [0], 0, 0

        def counted():
            calls[0] += 1
            return fn()

        for r in range(rounds):
            for mode in (("eager", "executor") if r % 2 == 0 else ("executor", "eager")):
                with graphs_upto(0 if mode == "eager" else 32):
                    u0, c0 = COUNTERS["nodes.updates"], calls[0]
                    res[mode].append(measure(counted))
                    if mode == "executor":
                        upd, n = upd + COUNTERS["nodes.updates"] - u0, n + calls[0] - c0
        if full is not None:
            last_updates["per_call"] = upd / n
            if upd < 0.9 * full * n:
                raise SystemExit(f"FAIL the executor's timed calls made {upd / n:.2f} node "
                                 f"updates per call, not about {full}: they did not re-point")
        return statistics.median(res["eager"]), statistics.median(res["executor"])

    def ev(fn):
        return statistics.median(cuda_times(fn, 40))

    def wall(fn):
        return statistics.median(host_walls(fn, 40))

    def bh(fn):
        return behind_ms(fn, 15)

    one = alternating(eng.transform, (y1, u1, v1), frames2[1])
    full1 = program_nodes(plan, 1)
    rows, upc = {}, []
    for k, measure in (("device by CUDA events", ev), ("device behind a busy card", bh),
                       ("host wall, planes on the card", wall)):
        rows[k] = both(one, measure, full=full1)
        upc.append(last_updates["per_call"])
    rows["numpy in to CPU tensors out"] = both(from_host, lambda f: statistics.median(
        host_walls(f, 20)))
    say("[19] batch 1, flagship, eager / executor in turns (medians of 4 rounds), on two frames "
        "in turn, each output kept until the next call: "
        + "; ".join(f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in rows.items())
        + f"; the executor's node updates per call {[round(u, 2) for u in upc]} of {full1}"
        + f"  ({smi})")
    e2e19 = host_walls(from_host, 50)
    say(f"[19] numpy in to CPU tensors out, phase 6's measure repeated (executor, 50 calls): "
        f"median {statistics.median(e2e19):.4f} ms (p90 {pct(e2e19, 0.9):.4f}; phase 6 "
        f"{statistics.median(e2e):.4f}); pageable host to device "
        f"{h2d_gbps([torch.from_numpy(p) for p in (yn, un, vn)]):.2f} GB/s (phase 6 "
        f"{pageable6:.2f})  ({smi})")
    ladder = {}
    for b in (1, 2, 4, 8, 16, 32):
        with graphs_upto(32):
            eng.transform(yb[:b], ub[:b], vb[:b])  # captured here if no earlier call was
        step = alternating(eng.transform, *[[t[k * b:(k + 1) * b] for t in (yb, ub, vb)]
                                            for k in (0, 1)])
        full = program_nodes(plan, b)
        ladder[b] = []
        for measure in (ev, bh, wall):
            ladder[b].append(both(step, measure, 2, full=full))
            upc.append(last_updates["per_call"])
        (ee, ex), (be, bx), (we, wx) = ladder[b]
        say(f"[19] ladder batch {b:2d}, eager / executor, two batches in turn: CUDA events "
            f"{ee:.4f} / {ex:.4f} ms, behind a busy card {be:.4f} / {bx:.4f} ms, host wall "
            f"{we:.4f} / {wx:.4f} ms (executor/eager by events {ex / ee:.3f}, behind a busy card "
            f"{bx / be:.3f}); node updates per executor call {[round(u, 2) for u in upc[-3:]]} "
            f"of {full}  ({smi})")
    for n in (2, 4, 8):
        bands = latency.band_plans(plan, n)
        xs = [[p[None] for p in f] for f in frames2]
        per = []
        for band in bands:
            fn = alternating(lambda *f: pipeline.transform_frame_planes(band, f), *xs)
            full = program_nodes(band, 1)
            per.append((both(fn, bh, 2, full=full), both(fn, issue_ms, 2, full=full)))
        say(f"[19] {n} bands, eager / executor, two frames in turn: max(band) behind a busy card "
            f"{max(p[0][0] for p in per):.4f} / {max(p[0][1] for p in per):.4f} ms; host issue "
            f"summed over the bands {sum(p[1][0] for p in per):.4f} / "
            f"{sum(p[1][1] for p in per):.4f} ms  ({smi})")
    n_exec = len(pipeline._EXEC_CACHE)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.yuv")
        write_yuv420_batch(src, *(t[:n_cli].cpu().numpy() for t in (yb, ub, vb)))
        for b in (1, 8):
            def cli_wall(_):
                t0 = time.perf_counter()
                if cli.main(["--vf", FLAGSHIP, "--input-size", f"{IN_W}x{IN_H}", "-i", src, "-o",
                             os.path.join(tmp, "out.yuv"), "--batch", str(b), "--device",
                             "cuda"]) != 0:
                    raise SystemExit(f"FAIL CLI --batch {b} in phase 19")
                return (time.perf_counter() - t0) * 1e3 / n_cli

            with graphs_upto(32):
                cli_wall(None)  # the CLI's plan may be new: its first call captures
            e, x = both(None, cli_wall)
            say(f"[19] CLI --batch {b}, {n_cli} frames, wall per frame eager / executor "
                f"{e:.2f} / {x:.2f} ms  ({smi})")
        # runs that each build the flagship's plan anew share the engine's
        # executors: neither the cache nor the card's memory grows
        held = []
        for _ in range(3):
            tplan.clear_plan_cache()
            cli_wall(None)
            torch.cuda.synchronize()
            held.append(torch.cuda.memory_allocated())
    say(f"[19] cached executors before the CLI runs {n_exec}, after {len(pipeline._EXEC_CACHE)}; "
        f"allocated after each of 3 runs with a new plan {[f'{h / 2**20:.1f}' for h in held]} "
        f"MiB")
    if len(pipeline._EXEC_CACHE) != n_exec or held[2] > held[1]:
        raise SystemExit(f"FAIL the CLI runs added executors or memory: {n_exec} -> "
                         f"{len(pipeline._EXEC_CACHE)} executors, {held} B")
    e, x = both(lambda: eng.transform(yb, ub, vb), ev, 4)
    say(f"[19] flagship step, batch {BATCH} (eager in both modes: above GRAPH_MAX_BATCH), by "
        f"CUDA events {e:.4f} / {x:.4f} ms  ({smi})")
    for b in sorted({1, gmax}):
        xs = (yb[:b], ub[:b], vb[:b])
        pipeline.clear_executor_cache()
        torch.cuda.synchronize()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        eng.transform(*xs)  # eager, then captured; its outputs dropped
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - a0
        say(f"[19] capture at batch {b} on planes on the card (luma and chroma executors): peak "
            f"allocated over what was allocated before "
            f"{(torch.cuda.max_memory_allocated() - a0) / 2**20:.1f} MiB; after it, allocated "
            f"{held / 2**20:.2f} MiB (no static input or output; the planes are "
            f"{tensor_bytes(*xs) / 2**20:.1f} MiB) and reserved "
            f"{(torch.cuda.memory_reserved() - r0) / 2**20:.1f} MiB (the graph pool, which keeps "
            f"the intermediates, and the eager call's blocks)  ({smi})")
        if held >= tensor_bytes(*xs):  # a graph holds no copy of its planes
            raise SystemExit(f"FAIL a capture at batch {b} holds {held} B, as much as its planes")
    read_counts()

    say(f"[19] every phase passed in {time.perf_counter() - t_start:.1f} s, the kernels' build "
        f"included")
    launches.update({k: deep_launches[k] for k in ("blur_u16", "window_u16")})
    launches.update(area=ss_launches["area"], area_u16=ssd_launches["area_u16"])

    def entry(name, src, replaces, **extra):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": None, **extra}

    kernels = [
        entry("blur", "transform360_tpu_torch/csrc/blur.cu",
              "transform360_tpu/ops/blur_lane.py:269", serves="B1", batches="all",
              shape="16 luma frames", issue_bound_ms=k1_issue["blur"],
              sass_per_px={f"{v} columns": {str(r): k1_px[("u8", v, r)]["total"]
                                            for r in K1_PROBE_RX} for v in (8, 16)},
              step=dict(k1_step, ms=stages_b128["K1 luma"]
                        + stages_b128["K1 chroma (U, V in place)"])),
        entry("window", "transform360_tpu_torch/csrc/window.cu",
              "transform360_tpu/ops/remap_pallas.py:441", serves="B5; B2, B3, B4 closed on it",
              batches="all", shape="16 luma frames", chroma=chroma_k3,
              issue_bound_ms=k3_issue["window"],
              sass_per_px=k3_px[("u8", luma_w.taps, luma_w.mode)]["own"],
              step=dict(k3_step, ms=stages_b128["K3 luma"] + stages_b128["K3 chroma (U+V)"])),
        entry("blur_u16", "transform360_tpu_torch/csrc/blur.cu",
              "transform360_tpu/ops/blur_lane.py:269", serves="B1 at 10-16 bits",
              batches="all", shape="16 10-bit luma frames", issue_bound_ms=k1_issue["blur_u16"],
              sass_per_px={"8 columns": {str(r): k1_px[("u16", 8, r)]["total"]
                                         for r in K1_PROBE_RX}}),
        entry("window_u16", "transform360_tpu_torch/csrc/window.cu",
              "transform360_tpu/ops/remap_pallas.py:441", serves="B5 at 10-16 bits",
              batches="all", shape="16 10-bit luma frames", issue_bound_ms=k3_issue["window_u16"],
              sass_per_px=k3_px[("u16", dlw.taps, dlw.mode)]["own"]),
        entry("area", "transform360_tpu_torch/csrc/area.cu", "transform360_tpu/sampling.py:483",
              serves="the XLA stage apply_area_resize + round (pipeline.py:304-311 there); "
              "no pallas_call", batches="all",
              shape="16 supersampled 2x2 luma frames 3072x2048 -> 1536x1024",
              library_ms=library["area"], library="avg_pool2d on a float32 copy",
              timing="ms: a replayed CUDA graph of 20 calls; plain_ms, library_ms: CUDA events",
              ms_events=events_ms["area"]),
        entry("area_u16", "transform360_tpu_torch/csrc/area.cu",
              "transform360_tpu/sampling.py:483", serves="the same at 10-16 bits",
              batches="all", shape="16 10-bit supersampled 2x2 luma frames",
              library_ms=library["area_u16"], library="avg_pool2d on a float32 copy",
              timing="ms: a replayed CUDA graph of 20 calls; plain_ms, library_ms: CUDA events",
              ms_events=events_ms["area_u16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
