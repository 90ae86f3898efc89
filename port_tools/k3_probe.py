"""Where K3's cycles go: a clock64 probe build of a tree's remap kernel
(``csrc/window.cu``), and its frame loop's SASS per output pixel.

    python3 port_tools/k3_probe.py [--supersampled] [DIR ...]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU.
Each DIR holds a ``transform360_tpu_torch/`` package (default: this
checkout; an earlier commit unpacked with ``git archive <commit>
transform360_tpu_torch | tar -x -C DIR``) and runs in its own process.

The probe build is a rewritten copy of that tree's ``window.cu`` under
``transform360_tpu_torch/build/variants/`` (``PROBES``: one set of edits
per kernel design, the first whose anchors all match once is taken): one
thread of each CTA reads ``%clock64`` at the edges of the kernel's phases
and adds the cycles of each phase, summed over the CTAs, to a device
array that ``t360_window_probe`` copies out.  Each class launch of the
flagship (``chip_smoke.FLAGSHIP``; with ``--supersampled`` its 2x2
supersampled twin, K3 to 3072x2048) runs once alone on 128 luma frames and
on one luma frame (after a warm-up launch); printed per launch: the
CTAs, the frames each walks, and the cycles per CTA of each phase with
their shares.  The clock reads cost a few instructions each and order
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

HEADER = '''
__device__ unsigned long long t360_probe[16];  // cycles of phase i < 14; [14] frames, [15] CTAs
#define T360_NOW(t) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory")
#define T360_LAP(i)                 \\
  do {                              \\
    long long n_;                   \\
    T360_NOW(n_);                   \\
    t360_p[i] += n_ - t360_c;       \\
    t360_c = n_;                    \\
  } while (0)
#define T360_DEP(x) asm volatile("" ::"f"(x))
#define T360_PUT(frames)                                                          \\
  do {                                                                            \\
    for (int i_ = 0; i_ < 14; ++i_)                                               \\
      atomicAdd(&t360_probe[i_], static_cast<unsigned long long>(t360_p[i_]));    \\
    atomicAdd(&t360_probe[14], static_cast<unsigned long long>(frames));          \\
    atomicAdd(&t360_probe[15], 1ull);                                             \\
  } while (0)
'''

FOOTER = '''
extern "C" int t360_window_probe(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, t360_probe, sizeof(t360_probe));
  if (e == cudaSuccess && reset) {
    static const unsigned long long zero[16] = {};
    e = cudaMemcpyToSymbol(t360_probe, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
'''

CLOCKS = "  long long t360_c, t360_p[14] = {};\n  T360_NOW(t360_c);\n"

# The put of a pass's first frame: the two-source kernel's, and the one
# before it (one plane stride, a 64-bit product per frame).
PUTS = ("    put<S, T, MODE>(out, acc0, fill_term, invalid, fill_px, a.maxval, oo);\n",
        "    put<S, T, MODE>(dst + f * N, acc0, fill_term, invalid, fill_px, a.maxval, oo);\n")


def _edits(put: str) -> tuple:
    """The clock reads of the one-CTA-per-tile design, around ``put``."""
    return (('#include "common.cuh"\n', '#include "common.cuh"\n' + HEADER),
            ("  extern __shared__ __align__(16) unsigned char smem[];\n",
             "  extern __shared__ __align__(16) unsigned char smem[];\n" + CLOCKS),
            ("  int half = 0;\n", "  T360_LAP(0);\n  int half = 0;\n"),
            ("      t360::cp_async_commit();  // empty past the batch's end\n"
             "      t360::cp_async_wait<1>();\n"
             "      __syncthreads();  // this pass's windows are complete\n",
             "      t360::cp_async_commit();  // empty past the batch's end\n"
             "      T360_LAP(1);\n"
             "      t360::cp_async_wait<1>();\n"
             "      __syncthreads();  // this pass's windows are complete\n"
             "      T360_LAP(2);\n"),
            (put, "    T360_DEP(acc0);\n    T360_DEP(acc1);\n    T360_LAP(3);\n" + put),
            ("    if (staged) __syncthreads();  // this half is free for the pass after next\n",
             "    T360_LAP(4);\n"
             "    if (staged) __syncthreads();  // this half is free for the pass after next\n"
             "    T360_LAP(5);\n"),
            ("    half ^= 1;\n  }\n}\n",
             "    half ^= 1;\n  }\n  if (threadIdx.x == 0) T360_PUT(nf);\n}\n"))


# (design, phase names, edits): each edit (old, new) must match once
PROBES = tuple(
    ("one CTA per tile, cp.async chunks by every thread, two CTA barriers per pass; "
     "thread 0 of each CTA",
     ("set-up: chunk table, first copies, weights", "issue the next pass's copies",
      "wait for the window: cp.async wait and barrier", "sums", "round and store",
      "barrier after the pass"),
     _edits(put)) for put in PUTS)


def probe_source(src: str):
    """(design, phase names, rewritten source) of the first ``PROBES``
    entry whose anchors all match ``src`` once."""
    for design, phases, edits in PROBES:
        if all(src.count(old) == 1 for old, _ in edits):
            for old, new in edits:
                src = src.replace(old, new)
            return design, phases, src + FOOTER
    raise SystemExit("FAIL no probe edit set matches this window.cu")


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
    design, phases, text = probe_source(src)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as ex:
        fp = ex.submit(_build._build, "window", (), text, csrc, "clock probe")
        fl = ex.submit(_build._build, "window", (), k3_loop_source(src), csrc, "loop build")
        probe_path, loop_path = fp.result(), fl.result()
    shipping = window._lib()
    lib = ctypes.CDLL(str(probe_path))
    for fn in ("t360_window", "t360_window_attrs", "t360_error_string"):
        getattr(lib, fn).argtypes = getattr(shipping, fn).argtypes
        getattr(lib, fn).restype = getattr(shipping, fn).restype
    lib.t360_window_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.t360_window_probe.restype = ctypes.c_int

    plan = P.open_filter(SUPERSAMPLED if supersampled else FLAGSHIP, 3840, 2160,
                         device="cuda").plan
    wt = plan.luma.window_tables("cuda")
    y, _, _ = video_like_planes(3840, 2160)
    yb = batch_of(y, 128)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"tree": tree, "card": smi, "design": design, "phases": list(phases),
           "plan": "supersampled" if supersampled else "flagship", "launches": {}}
    buf = (ctypes.c_ulonglong * 16)()
    for B in (128, 1):
        x = yb[:B].contiguous()
        out = torch.empty((B, wt.out_h, wt.out_w), dtype=torch.uint8, device="cuda")
        for gi, g in enumerate(wt.groups):
            go = lambda: window.launch_class(lib, wt, x, out, g, window.frames_per_cta(B, g[1]),
                                             window.pairs(g[2]), stream)
            go()
            torch.cuda.synchronize()
            lib.t360_window_probe(buf, 1)
            go()
            torch.cuda.synchronize()
            lib.t360_window_probe(buf, 1)
            ctas = max(1, buf[15])
            cyc = {p: buf[i] / ctas for i, p in enumerate(phases)}
            total = sum(cyc.values())
            res["launches"][f"{B} luma, launch {gi} ({g[1]} tiles, window {g[2]} B)"] = {
                "ctas": buf[15], "frames_per_cta": buf[14] / ctas, "cycles_per_cta": cyc,
                "share": {p: c / total if total else 0.0 for p, c in cyc.items()}}
    loops = k3_loop_counts(loop_path)
    res["loop_per_px"] = {f"{s} T={t} mode {m}": {k: c[k] for k in ("own", "total", "nested",
                                                                      *PIPES)}
                          for (s, t, m), c in sorted(loops.items())}
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
