"""Write the fidelity gate's oracle fixture, ``transform360_tpu_torch/data/fidelity_oracle.npz``.

    JAX_PLATFORMS=cpu python3 port_tools/make_fidelity_fixture.py

Run from the root of a checkout on a machine with opencv-python and jax
(the CPU is enough; the GPU host has neither).  For each case of
``transform360_tpu_torch.fidelity.gate_cases`` at the gate size it stores
the OpenCV oracle's output planes (``transform360_tpu.oracle
.transform_frame_yuv420``) on the gate's input planes, the JAX package's
worst-plane PSNR against them through its CPU path, and the SHA-256 of
the input planes.  The file is written with fixed zip timestamps, so the
same inputs give the same bytes (``tests/test_torch_fidelity.py``
rebuilds it and compares).
"""

from __future__ import annotations

import dataclasses
import enum
import io
import os
import sys
import zipfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from transform360_tpu_torch import fidelity  # noqa: E402


def jax_config(cfg):
    """The JAX package's TransformConfig with the same fields."""
    from transform360_tpu import config as jc

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = getattr(jc, type(v).__name__)(int(v)) if isinstance(v, enum.Enum) else v
    return jc.TransformConfig(**kw)


def oracle_outputs(in_wh, out_wh, parity_sweep=True):
    """``{case: (Y, U, V)}`` of the OpenCV oracle on the gate's planes."""
    from transform360_tpu import oracle

    planes = fidelity._video_like_planes(*in_wh)
    return {name: oracle.transform_frame_yuv420(jax_config(cfg), planes, ow, oh)
            for name, cfg, (ow, oh) in fidelity.gate_cases(out_wh, parity_sweep)}


def jax_worst_db(in_wh, out_wh, want):
    """``{case: worst-plane PSNR}`` of the JAX package's CPU path against
    ``want``, on one frame of the gate's planes."""
    from transform360_tpu.pipeline import transform_batch
    from transform360_tpu.plan import build_plan

    y, u, v = fidelity._video_like_planes(*in_wh)
    out = {}
    for name, cfg, (ow, oh) in fidelity.gate_cases(out_wh):
        plan = build_plan(jax_config(cfg), in_wh[0], in_wh[1], ow, oh)
        got = transform_batch(plan, y[None], u[None], v[None])
        out[name] = min(fidelity.psnr(np.asarray(g[0]), w) for g, w in zip(got, want[name]))
    return out


def build_fixture(in_wh=fidelity.GATE_IN, out_wh=fidelity.GATE_OUT, want=None):
    """The fixture's arrays by name (``want``: the oracle's outputs, if
    already computed)."""
    want = want or oracle_outputs(in_wh, out_wh)
    jdb = jax_worst_db(in_wh, out_wh, want)
    names = list(want)
    arrays = {"cases": np.array(names), "in_wh": np.array(in_wh, np.int64),
              "out_wh": np.array(out_wh, np.int64)}
    for p, h in fidelity.planes_sha256(fidelity._video_like_planes(*in_wh)).items():
        arrays[f"sha256.{p}"] = np.array(h)
    for name in names:
        arrays[f"jax_db.{name}"] = np.array(jdb[name], np.float64)
        for p, plane in zip(fidelity.PLANES, want[name]):
            arrays[f"{name}.{p}"] = np.ascontiguousarray(plane, np.uint8)
    return arrays


def npz_bytes(arrays) -> bytes:
    """``np.savez_compressed``'s layout with fixed member timestamps."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for k in sorted(arrays):
            member = io.BytesIO()
            np.lib.format.write_array(member, arrays[k], allow_pickle=False)
            info = zipfile.ZipInfo(k + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            z.writestr(info, member.getvalue())
    return buf.getvalue()


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = npz_bytes(build_fixture())
    fidelity.FIXTURE.parent.mkdir(exist_ok=True)
    fidelity.FIXTURE.write_bytes(data)
    fx = fidelity.load_fixture()
    print(f"wrote {fidelity.FIXTURE.relative_to(ROOT)} ({len(data)} B): "
          + ", ".join(f"{n} {db:.2f} dB" for n, db in fx.jax_db.items()))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
