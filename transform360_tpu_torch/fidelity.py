"""The fidelity gate: worst-plane PSNR of the port against the reference
filter's outputs, the counterpart of ``transform360_tpu.fidelity``.

:func:`bench_fidelity` runs the flagship config (cubic, adaptive
prefilter) at a reduced size, at the gate batch and at batch 1, and the
seven BASELINE parity cases of the JAX gate (``fidelity.py:142-167``
there): bilinear without the prefilter, cubic at twice the output size,
the 32x15 adaptive prefilter, TB and LR stereo, NEAREST and LANCZOS4.
Every case runs the plan's whole frame path (K1, then K3, on a CUDA
device; their plain versions on the CPU) and is scored against the
OpenCV oracle (``transform360_tpu.oracle``): the PSNR of frame 0 per
plane, folded to a minimum.  The frames of a batch are identical, so
every frame must equal frame 0: a fault in K3's frame pairs or frame
groups raises there.

The oracle needs OpenCV, which the GPU host lacks, so its outputs come
from ``data/fidelity_oracle.npz`` at the gate size (1920x960 -> 480x320),
written by ``port_tools/make_fidelity_fixture.py``; the fixture also
holds the JAX package's worst-plane PSNR per case and the SHA-256 of the
input planes, which are checked against this module's own.  Other sizes
need ``want=`` (the oracle's planes per case).

The flagship also runs latency-banded, as the JAX gate's ``:130-134``:
two output row-bands with cost-model edges (:mod:`.parallel.latency`),
each band on the gate's device.  The JAX gate's lane-packing loop
(``:105-117``) has no counterpart: it exists for TPU lane kernels, and
K3 serves every batch size.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .config import Interpolation, StereoFormat, TransformConfig, chroma_dims
from .parallel.latency import transform_frame_banded
from .pipeline import transform_batch
from .plan import TransformPlan, build_plan

GATE_IN = (1920, 960)
GATE_OUT = (480, 320)
FIXTURE = Path(__file__).resolve().parent / "data" / "fidelity_oracle.npz"
PLANES = "YUV"


def _video_like_planes(in_w: int, in_h: int):
    """Synthetic but smooth, video-like planes (pure noise would hide
    interpolation-weight bugs behind its flat spectrum); the JAX gate's
    generator, seed 7."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:in_h, 0:in_w]
    y = np.clip(
        128 + 70 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
        + 40 * np.sin((xx + 2 * yy) / 5.0) + rng.normal(0, 6, (in_h, in_w)),
        0, 255,
    ).astype(np.uint8)
    cw, ch = chroma_dims(in_w, in_h)
    u = np.clip(
        128 + 50 * np.sin(np.mgrid[0:ch, 0:cw][1] / 9.0), 0, 255
    ).astype(np.uint8)
    v = np.clip(
        128 + 50 * np.cos(np.mgrid[0:ch, 0:cw][0] / 7.0), 0, 255
    ).astype(np.uint8)
    return y, u, v


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / mse)) if mse else 99.0


def planes_sha256(planes) -> Dict[str, str]:
    return {p: hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()
            for p, x in zip(PLANES, planes)}


def gate_cases(out_wh: Tuple[int, int], parity_sweep: bool = True):
    """``[(name, TransformConfig, (out_w, out_h))]``: the flagship, then
    (with ``parity_sweep``) the seven parity cases, each run against its
    own oracle output."""
    ow, oh = out_wh
    mono = dict(input_stereo_format=StereoFormat.MONO,
                output_stereo_format=StereoFormat.MONO)
    cases = [("flagship", TransformConfig(**mono), (ow, oh))]
    if parity_sweep:
        cases += [
            ("bilinear_nolpf", TransformConfig(interpolation_alg=Interpolation.LINEAR,
                                               enable_low_pass_filter=0, **mono), (ow, oh)),
            # the edge-1024 parity config scaled to the gate: 4x the output px
            ("cubic_big", TransformConfig(**mono), (ow * 2, oh * 2)),
            ("adaptive_32x15", TransformConfig(num_vertical_segments=32,
                                               num_horizontal_segments=15, adjust_kernel=1,
                                               **mono), (ow, oh)),
            ("stereo_tb", TransformConfig(input_stereo_format=StereoFormat.TB,
                                          output_stereo_format=StereoFormat.TB), (ow, oh)),
            ("stereo_lr", TransformConfig(input_stereo_format=StereoFormat.LR,
                                          output_stereo_format=StereoFormat.LR), (ow, oh)),
            ("nearest", TransformConfig(interpolation_alg=Interpolation.NEAREST, **mono),
             (ow, oh)),
            ("lanczos4", TransformConfig(interpolation_alg=Interpolation.LANCZOS4, **mono),
             (ow, oh)),
        ]
    return cases


@dataclasses.dataclass(frozen=True)
class Fixture:
    """The oracle's planes per case at one size, the JAX package's
    worst-plane PSNR per case on them, and the input planes' SHA-256."""

    in_wh: Tuple[int, int]
    out_wh: Tuple[int, int]
    want: Dict[str, Tuple[np.ndarray, ...]]
    jax_db: Dict[str, float]
    sha256: Dict[str, str]


def load_fixture(path=FIXTURE) -> Fixture:
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["cases"]]
        return Fixture(
            in_wh=tuple(int(x) for x in z["in_wh"]),
            out_wh=tuple(int(x) for x in z["out_wh"]),
            want={n: tuple(z[f"{n}.{p}"] for p in PLANES) for n in names},
            jax_db={n: float(z[f"jax_db.{n}"]) for n in names},
            sha256={p: str(z[f"sha256.{p}"]) for p in PLANES},
        )


def case_plans(in_wh=GATE_IN, out_wh=GATE_OUT, parity_sweep=True) -> Dict[str, TransformPlan]:
    """Each gate case's plan (the port's own geometry, memoized)."""
    return {name: build_plan(cfg, in_wh[0], in_wh[1], ow, oh)
            for name, cfg, (ow, oh) in gate_cases(out_wh, parity_sweep)}


def run_case(plan: TransformPlan, planes, batch: int, device) -> Tuple[np.ndarray, ...]:
    """The plan's frame path on ``batch`` copies of ``planes`` on
    ``device``; returns frame 0's output planes (numpy) after checking
    that every frame of the batch equals it."""
    stacked = [np.broadcast_to(p, (batch,) + p.shape) for p in planes]
    outs = [o.cpu().numpy() for o in transform_batch(plan, *stacked, device=device)]
    for pname, o in zip(PLANES, outs):
        bad = [k for k in range(1, batch) if not np.array_equal(o[k], o[0])]
        if bad:
            raise RuntimeError(
                f"fidelity gate: plane {pname} of frames {bad} differs from frame 0 "
                f"of a batch of {batch} identical frames"
            )
    return tuple(o[0] for o in outs)


def run_gate(plans: Dict[str, TransformPlan], planes, batch: int, device) -> Dict[str, List]:
    """``{case: [frame-0 planes per run]}``: the flagship at ``batch``, at
    batch 1 and in two latency bands with ``row_costs="auto"``, every
    other case at ``batch``."""
    got = {}
    for name, plan in plans.items():
        runs = [run_case(plan, planes, batch, device)]
        if name == "flagship":
            runs.append(run_case(plan, planes, 1, device))
            runs.append(transform_frame_banded(plan, planes, devices=[device], n=2,
                                               row_costs="auto"))
        got[name] = runs
    return got


def score(got: Dict[str, List], want: Dict[str, Tuple[np.ndarray, ...]]) -> Dict:
    """The JAX gate's result: the flagship's per-plane minimum PSNR over
    its runs (``Y``, ``U``, ``V``), each parity case's worst plane under
    ``configs``, and ``worst_db``, the minimum of all."""
    out: Dict = {}
    for run in got["flagship"]:
        for pname, g, w in zip(PLANES, run, want["flagship"]):
            out[pname] = min(out.get(pname, np.inf), psnr(g, w))
    out["worst_db"] = min(out[p] for p in PLANES)
    others = [n for n in got if n != "flagship"]
    if others:
        out["configs"] = {}
        for name in others:
            db = min(psnr(g, w) for run in got[name] for g, w in zip(run, want[name]))
            out["configs"][name] = db
            out["worst_db"] = min(out["worst_db"], db)
    return out


def bench_fidelity(
    in_wh: Tuple[int, int] = GATE_IN,
    out_wh: Tuple[int, int] = GATE_OUT,
    batch: int = 12,
    parity_sweep: bool = True,
    device="cuda",
    want=None,
) -> Dict:
    """Worst-plane PSNR of the frame path on ``device`` against the
    oracle: ``{"worst_db", "Y", "U", "V", "configs"}`` as the JAX gate
    returns it (``configs`` only with ``parity_sweep``).

    ``want`` maps each case name to the oracle's planes; without it the
    committed fixture serves the gate size, and any other size raises.
    """
    planes = _video_like_planes(*in_wh)
    if want is None:
        fx = load_fixture()
        if (fx.in_wh, fx.out_wh) != (tuple(in_wh), tuple(out_wh)):
            raise ValueError(
                f"the oracle fixture holds {fx.in_wh} -> {fx.out_wh}; pass want= "
                f"for {tuple(in_wh)} -> {tuple(out_wh)}"
            )
        if fx.sha256 != planes_sha256(planes):
            raise ValueError("the oracle fixture was made from other input planes")
        want = fx.want
    plans = case_plans(in_wh, out_wh, parity_sweep)
    return score(run_gate(plans, planes, batch, device), want)
