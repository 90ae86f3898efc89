"""Where K3's cycles go, warp by warp: a clock64 probe build of a tree's
remap kernel (``csrc/window.cu``), and its frame loop's SASS per output
pixel.

    python3 port_tools/k3_probe.py [--supersampled] [DIR ...]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Each DIR holds a ``transform360_tpu_torch/`` package with the kernels'
C ABI seam, ``ops.nodes.Kernel`` (default: this checkout; a commit unpacked
with ``git archive <commit> transform360_tpu_torch | tar -x -C DIR``),
and runs in its own process.

The probe build is a rewritten copy of that tree's ``window.cu`` under
``transform360_tpu_torch/build/variants/`` (``PROBES``: one set of edits
per kernel design, the first whose anchors all match once is taken): every
thread reads ``%clock64`` at the edges of the kernel's phases, and lane 0
of each of a CTA's 8 warps adds its cycles of each phase, summed over the
CTAs, to a device array (a row per warp) that ``t360_window_probe``
copies out.  Each launch of the flagship (``chip_smoke.FLAGSHIP``; with
``--supersampled`` its 2x2 supersampled twin, K3 to 3072x2048) runs once
alone on 128 luma frames and on one luma frame (after a warm-up launch),
as the tree's package launches it at that batch; printed per launch: the
CTAs, the frames each walks, and per warp the cycles per CTA of each
phase and their shares.  A warp that issues more of a pass's copies
spends more of its cycles in that phase, and the others wait for it at
the barriers.  The clock reads cost a few instructions each and order
the phases' memory operations, so the shares, not the sums, are the
reading.

Then the loop build (``chip_smoke.k3_loop_source``: every tile staged)
and ``chip_smoke.k3_loop_counts``: the frame loop's SASS instructions
per output pixel, by pipe, of each instantiation (``own``: without the
copy loops it holds), and the issue bound ``own`` gives a batch-128
flagship step's K3 (128 luma frames and 256 chroma planes, uint8, T = 4,
wrap) at the card's largest SM clock.  One JSON line per tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARPS, PHASES = 8, 8  # a CTA's warps; the probe array's phases per warp

HEADER = '''
// cycles of phase i of warp w at [8 * w + i]; [64] frames, [65] CTAs
__device__ unsigned long long t360_probe[66];
#define T360_NOW(t) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory")
#define T360_LAP(i)                 \\
  do {                              \\
    long long n_;                   \\
    T360_NOW(n_);                   \\
    t360_p[i] += n_ - t360_c;       \\
    t360_c = n_;                    \\
  } while (0)
#define T360_DEP(x) asm volatile("" ::"f"(x))
#define T360_PUT(frames)                                                            \\
  do {                                                                              \\
    if ((threadIdx.x & 31) == 0)                                                    \\
      for (int i_ = 0; i_ < 8; ++i_)                                                \\
        atomicAdd(&t360_probe[8 * (threadIdx.x >> 5) + i_],                         \\
                  static_cast<unsigned long long>(t360_p[i_]));                     \\
    if (threadIdx.x == 0) {                                                         \\
      atomicAdd(&t360_probe[64], static_cast<unsigned long long>(frames));          \\
      atomicAdd(&t360_probe[65], 1ull);                                             \\
    }                                                                               \\
  } while (0)
'''

FOOTER = '''
extern "C" int t360_window_probe(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, t360_probe, sizeof(t360_probe));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[66] = {};
    e = cudaMemcpyToSymbol(t360_probe, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
'''

CLOCKS = "  long long t360_c, t360_p[8] = {};\n  T360_NOW(t360_c);\n"
PHASE_NAMES = ("set-up: chunk table, first copies, weights", "issue the next pass's copies",
               "wait for the window: cp.async wait and barrier", "sums", "round and store",
               "barrier after the pass")
WAIT = ("      t360::cp_async_commit();  // empty past the batch's end\n"
        "      t360::cp_async_wait<1>();\n"
        "      __syncthreads();  // this pass's windows are complete\n")
END = "    if (staged) __syncthreads();  // this half is free for the pass after next\n"
PUT = "    put<S, T, MODE>(out, acc0, fill_term, invalid, fill_px, a.maxval, oo);\n"
STORE = "    if (two) put<S, T, MODE>(out + N, acc1, fill_term, invalid, fill_px, a.maxval, oo);\n"


def _wait(pad: str) -> tuple:
    """The laps around a frame loop's wait (its lines indented by ``pad``):
    the copies issued before it, and the wait with its barrier."""
    old = "".join(pad + line.strip() + "\n" for line in WAIT.strip("\n").split("\n"))
    lines = old.splitlines(keepends=True)
    return (old, lines[0] + pad + "T360_LAP(1);\n" + lines[1] + lines[2] + pad + "T360_LAP(2);\n")


_HEAD = (('#include "common.cuh"\n', '#include "common.cuh"\n' + HEADER),
         ("  extern __shared__ __align__(16) unsigned char smem[];\n",
          "  extern __shared__ __align__(16) unsigned char smem[];\n" + CLOCKS))


def _sums(pad: str, store_lap: bool) -> tuple:
    """The laps around a frame loop's sums and (``store_lap``) its stores,
    its lines indented by ``pad``."""
    put, store = "\n" + pad + PUT.lstrip(), "\n" + pad + STORE.lstrip()
    edits = ((put, "\n" + pad + "T360_DEP(acc0);\n" + pad + "T360_DEP(acc1);\n" + pad
              + "T360_LAP(3);" + put),)
    return edits + (((store, store + pad + "T360_LAP(4);\n"),) if store_lap else ())
_END6 = "  " + END  # the barrier after a pass, inside a frame loop of 6 spaces

# (design, edits): each edit (old, new) must match once.  The first: a WIDE
# instantiation (passes of up to 8 frames, copies dealt over every thread,
# a pair of frames each trip of its frame loop) beside the one-or-two-frame
# loop, both summing and storing a pair in one lambda.  The second (its
# parent): one or two frames a pass, each thread copying its chunks of
# both, a pass each trip.
PROBES = (
    ("one CTA per tile; WIDE: a pass of up to 8 frames, its copies dealt over every thread; "
     "else one or two frames a pass; two CTA barriers per pass; every warp's lane 0",
     _HEAD + _sums("      ", True) + _sums("    ", True) + (
              ("  if (!WIDE) {", "  T360_LAP(0);\n  if (!WIDE) {"),
              (_END6 + "      half ^= 1;\n    }\n    return;\n",
               _END6 + "      T360_LAP(5);\n      half ^= 1;\n    }\n    T360_PUT(nf);\n"
               "    return;\n"),
              (_END6 + "      half ^= 1;\n      j = 0;\n    }\n  }\n}\n",
               _END6 + "      T360_LAP(5);\n      half ^= 1;\n      j = 0;\n    }\n  }\n"
               "  T360_PUT(nf);\n}\n"),
              _wait("        "), _wait("      "))),
    ("one CTA per tile, one or two frames a pass, each thread copying its chunks of both, two "
     "CTA barriers per pass; every warp's lane 0",
     _HEAD + _sums("    ", False) + (("  int half = 0", "  T360_LAP(0);\n  int half = 0"),
              (END, "    T360_LAP(4);\n" + END + "    T360_LAP(5);\n"),
              ("    half ^= 1;\n  }\n}\n", "    half ^= 1;\n  }\n  T360_PUT(nf);\n}\n"),
              _wait("      "))),
)


def probe_source(src: str):
    """(design, rewritten source) of the first ``PROBES`` entry whose
    anchors all match ``src`` once."""
    for design, edits in PROBES:
        if all(src.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            return design, src + FOOTER
    raise SystemExit("FAIL no probe edit set matches this window.cu")


def tree_launches(window, wt, B):
    """(group, frames per CTA, frames a pass) of each launch the tree's
    package makes at batch B (``window.launches``)."""
    return [((f, n, w), fr, fp) for f, n, w, fp, fr in window.launches(wt.groups, B)]


def child(tree: str, supersampled: bool) -> None:
    import ctypes
    from pathlib import Path

    import torch

    import transform360_tpu_torch as P
    from transform360_tpu_torch.ops import _build, window

    sys.path.append(ROOT)
    from chip_smoke import (FLAGSHIP, LANES_PER_SM, PIPES, SMS, SUPERSAMPLED, batch_of,
                            k3_loop_counts, k3_loop_source, video_like_planes)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    csrc = Path(P.__file__).parent / "csrc"
    src = (csrc / "window.cu").read_text()
    design, text = probe_source(src)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as ex:
        fp = ex.submit(_build._build, "window", (), text, csrc, "clock probe")
        fl = ex.submit(_build._build, "window", (), k3_loop_source(src), csrc, "loop build")
        probe_path, loop_path = fp.result(), fl.result()
    lib = window.KERNEL.bind(ctypes.CDLL(str(probe_path)))
    lib.t360_window_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.t360_window_probe.restype = ctypes.c_int

    plan = P.open_filter(SUPERSAMPLED if supersampled else FLAGSHIP, 3840, 2160,
                         device="cuda").plan
    wt = plan.luma.window_tables("cuda")
    y, _, _ = video_like_planes(3840, 2160)
    yb = batch_of(y, 128)
    stream = torch.cuda.current_stream().cuda_stream
    phases = PHASE_NAMES
    res = {"tree": tree, "card": smi, "design": design, "phases": list(phases),
           "plan": "supersampled" if supersampled else "flagship", "launches": {}}
    buf = (ctypes.c_ulonglong * 66)()
    for B in (128, 1):
        x = yb[:B].contiguous()
        out = torch.empty((B, wt.out_h, wt.out_w), dtype=torch.uint8, device="cuda")
        for gi, (g, frames, per_pass) in enumerate(tree_launches(window, wt, B)):
            go = lambda: window.launch_class(lib, wt, x, out, g, frames, per_pass, stream)
            go()
            torch.cuda.synchronize()
            lib.t360_window_probe(buf, 1)
            go()
            torch.cuda.synchronize()
            lib.t360_window_probe(buf, 1)
            ctas = max(1, buf[65])
            warps = []
            for w in range(WARPS):
                cyc = {p: buf[PHASES * w + i] / ctas for i, p in enumerate(phases)}
                total = sum(cyc.values())
                warps.append({"cycles_per_cta": round(total),
                              "share": {p: round(c / total, 4) if total else 0.0
                                        for p, c in cyc.items()}})
            res["launches"][f"{B} luma, launch {gi} ({g[1]} tiles, window {g[2]} B, "
                            f"{int(per_pass)} a pass)"] = {
                "ctas": buf[65], "frames_per_cta": buf[64] / ctas, "warps": warps}
    loops = k3_loop_counts(loop_path)
    res["loop_per_px"] = {" ".join(map(str, key)): {k: c[k] for k in ("own", "total", "nested",
                                                                       *PIPES)}
                          for key, c in sorted(loops.items(), key=str)}
    per_px = loops[("u8", 4, 0)]["own"]
    px = 128 * plan.luma.out_h * plan.luma.out_w + 256 * plan.chroma.out_h * plan.chroma.out_w
    res["issue_bound_ms_step"] = per_px * px / (SMS * LANES_PER_SM * sm_mhz * 1e3)
    res["sm_mhz"] = sm_mhz
    print(json.dumps(res), flush=True)


def main(argv) -> int:
    if argv and argv[0] == "--child":
        child(argv[1], argv[2] == "1")
        return 0
    supersampled = "--supersampled" in argv
    rc = 0
    for tree in [a for a in argv if a != "--supersampled"] or ["."]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree,
                              str(int(supersampled))], env=env, capture_output=True, text=True)
        if out.returncode:
            print(f"{tree}: exit {out.returncode}\n{out.stderr[-3000:]}", flush=True)
            rc = 1
        else:
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
