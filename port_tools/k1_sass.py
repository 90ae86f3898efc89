"""Count K1's row-loop instructions per output pixel in a tree's ``blur.cu``.

    python3 port_tools/k1_sass.py [DIR ...]

Run from the root of a checkout on a machine with nvcc, cuobjdump and an
NVIDIA GPU (for the SM clock).  For each DIR (a directory holding
``transform360_tpu_torch/``, such as an earlier commit unpacked with
``git archive <commit> transform360_tpu_torch | tar -x -C DIR``; default:
this checkout), builds its ``csrc/blur.cu`` once per flagship x radius
(1, 2, 6) with the ring kernel's x-radius switch fixed to that radius
and its scalar stores of partial groups out of the row loop
(``chip_smoke.k1_probe_source``, which also knows an earlier K1's
source), every build at once.  Prints, per sample size, the row loop's
instructions per output pixel by pipe (``chip_smoke.loop_counts``), and
one JSON line per tree with the issue bound of the flagship's K1
(``chip_smoke.issue_bound``: 16 luma frames, and a batch-128 step of
luma and stacked chroma) at the card's largest SM clock, beside the byte
and float-operation bounds (``chip_smoke.blur_work``).
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    from chip_smoke import (BATCH, FLAGSHIP, FP32_OPS_PER_MS, HBM_BYTES_PER_MS, PIPES,
                            blur_pixels, blur_work, issue_bound, k1_probe_builds,
                            k1_probe_counts)
    import transform360_tpu_torch as P

    trees = argv or [ROOT]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sm_mhz = float(smi.split(",")[-1])
    plan = P.open_filter(FLAGSHIP, 3840, 2160, device="cpu").plan
    lt, ct = plan.luma.tables("cpu").blur, plan.chroma.tables("cpu").blur
    step_px = blur_pixels(lt, BATCH)
    for r, n in blur_pixels(ct, 2 * BATCH).items():
        step_px[r] = step_px.get(r, 0.0) + n
    wl, wc = blur_work(lt, BATCH), blur_work(ct, 2 * BATCH)

    def build(i):
        csrc = os.path.join(os.path.abspath(trees[i]), "transform360_tpu_torch", "csrc")
        return k1_probe_builds(csrc, f"tree {i} ")

    with ThreadPoolExecutor(max_workers=len(trees)) as ex:
        probes = list(ex.map(build, range(len(trees))))
    jobs = [(i, r, lib) for i, p in enumerate(probes) for r, lib in p.items()]
    counts = {}  # (tree, sample, columns per thread, x radius) -> counts
    for i, r, lib in jobs:
        for (sname, v), c in k1_probe_counts(lib).items():
            counts[(i, sname, v, r)] = c
            print(f"{trees[i]} {sname} {v or 'the only'} columns a thread, rx {r}: "
                  f"{c['total']:.3f} instructions per output pixel "
                  f"({c['px_per_iteration']:.0f} an iteration; "
                  + ", ".join(f"{p} {c[p]:.3f}" for p in PIPES) + "); "
                  + json.dumps({o: round(v, 3) for o, v in c.items() if o.isupper()}), flush=True)
    for i, tree in enumerate(trees):
        per_px = {}  # "sample, columns" -> {x radius: instructions per output pixel}
        for (j, sname, v, r), c in sorted(counts.items(), key=str):
            if j == i:
                per_px.setdefault(f"{sname} {v or 'the only'} columns", {})[r] = c["total"]
        u8 = {k: px for k, px in per_px.items() if k.startswith("u8")}
        print(json.dumps({
            "tree": tree, "card": smi, "sm_mhz": sm_mhz, "per_px": per_px,
            "issue_bound_ms_16_luma": {k: issue_bound(px, blur_pixels(lt, 16), sm_mhz)
                                       for k, px in u8.items()},
            "bytes_bound_ms_16_luma": blur_work(lt, 16)[0] / HBM_BYTES_PER_MS,
            "operations_bound_ms_16_luma": blur_work(lt, 16)[1] / FP32_OPS_PER_MS,
            "issue_bound_ms_step": {k: issue_bound(px, step_px, sm_mhz) for k, px in u8.items()},
            "bytes_bound_ms_step": (wl[0] + wc[0]) / HBM_BYTES_PER_MS,
            "operations_bound_ms_step": (wl[1] + wc[1]) / FP32_OPS_PER_MS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
