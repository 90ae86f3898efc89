"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
nvcc builds it in seconds.  The library is built at first use into
``transform360_tpu_torch/build/`` (listed in ``.gitignore``), under a name
that hashes the source and the flags, so an edited source is rebuilt.
Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: no multiply-add
is contracted into an FMA behind the source's back, so the kernels round
exactly where their plain PyTorch versions do (each product, then each
sum).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # nvcc wall time per library built here
BUILD_LOG: Dict[str, str] = {}  # nvcc's output (ptxas registers, spills)


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME``, then ``PATH``, then the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of transform360_tpu_torch are built from source at first use"
    )


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    deps = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in [src, *deps]:
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = res.stdout + res.stderr
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib



def build_all(names: Sequence[str]) -> None:
    """Build several sources at once, one nvcc each, all started together
    (each writes its own hash-named file), then load them."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for f in [ex.submit(_build, n) for n in names]:
            f.result()
    for n in names:
        library(n)
