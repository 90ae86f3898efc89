"""Build the CUDA sources under ``csrc/`` with nvcc, and the native C++
engine ``native/t360.cpp`` with the host's C++ compiler, and load them by
ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
nvcc builds it in seconds.  The library is built at first use into
``transform360_tpu_torch/build/`` (listed in ``.gitignore``), under a name
that hashes the source and the flags, so an edited source is rebuilt.
Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: no multiply-add
is contracted into an FMA behind the source's back, so the kernels round
exactly where their plain PyTorch versions do (each product, then each
sum).

The native engine is built with the flags of the JAX package's
``native/Makefile`` (``CXX_FLAGS``), so both engines are the same machine
code on one host.  ``-march=native`` code may not run on another CPU, so
its library's name also hashes the host CPU's identity
(:func:`host_fingerprint`): a build directory shared between hosts never
loads another CPU's build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix

NATIVE_SRC = _PKG / "native" / "t360.cpp"
# transform360_tpu/native/Makefile's CXXFLAGS and LDFLAGS, unchanged
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native", "-shared", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # compiler wall time per library built here (by key)
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


def _build(name: str, extra: Sequence[str] = (), text: str = None, include: Path = CSRC,
           label: str = "") -> Path:
    """``csrc/<name>.cu`` built (if needed) with ``NVCC_FLAGS`` and the
    ``extra`` flags (a variant, such as ``-DT360_AREA_MIN_BLOCKS=3``; its
    file name hashes them too), or, given ``text``, that source in its
    place (a rewritten variant, written under ``BUILD_DIR/variants``) with
    the headers of ``include``.  ``BUILD_SECONDS`` and ``BUILD_LOG`` key a
    build by the name, its extra flags and ``label``."""
    src = CSRC / f"{name}.cu"
    deps = sorted(Path(include).glob("*.cuh"))
    h = hashlib.sha1(" ".join((*NVCC_FLAGS, *extra)).encode())
    h.update(src.read_bytes() if text is None else text.encode())
    for p in deps:
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if text is not None:
        src = BUILD_DIR / "variants" / f"{name}-{h.hexdigest()[:12]}.cu"
        src.parent.mkdir(exist_ok=True)
        src.write_text(text)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-I", str(include), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    key = " ".join((name, *extra, *([label] if label else [])))
    BUILD_SECONDS[key] = time.perf_counter() - t0
    BUILD_LOG[key] = res.stdout + res.stderr
    return out


def host_fingerprint() -> str:
    """Hash of the host CPU's identity AND feature flags (a copy of
    ``transform360_tpu.utils.backend._host_fingerprint``).

    ``-march=native`` code compiled on one CPU can SIGILL on another.  The
    flags line alone is not enough: the compiler derives tuning from the
    CPU *model* too, so vendor/family/model/stepping/model-name count.
    """
    keys = (
        # x86
        "vendor_id", "cpu family", "model", "stepping", "model name",
        "flags",
        # ARM (/proc/cpuinfo has no x86 keys there; 'Features' is the
        # flags analog, the rest identify the core)
        "CPU implementer", "CPU architecture", "CPU variant", "CPU part",
        "CPU revision", "Features",
    )
    ident = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                k = k.strip()
                if k in keys and k not in ident:
                    v = v.strip()
                    if k in ("flags", "Features"):
                        v = " ".join(sorted(v.split()))
                    ident[k] = v
    except OSError:
        pass
    if ident:
        feats = "|".join(f"{k}={ident.get(k, '')}" for k in keys)
        return hashlib.sha256(feats.encode()).hexdigest()[:12]
    import platform

    return hashlib.sha256(
        f"{platform.machine()}-{platform.processor()}".encode()
    ).hexdigest()[:12]


def cxx_command() -> list:
    """The C++ compiler: ``$CXX`` when set (no other is tried then), else
    ``g++``, else ``c++`` on ``PATH``."""
    env = os.environ.get("CXX")
    cmd = shlex.split(env) if env else [shutil.which("g++") or shutil.which("c++") or "g++"]
    exe = shutil.which(cmd[0]) if cmd else None
    if exe is None:
        raise RuntimeError(
            f"C++ compiler not found ({'$CXX=' + env if env else 'g++ or c++ on PATH'}): "
            "the native engine of transform360_tpu_torch is built from "
            "native/t360.cpp at first use"
        )
    return [exe, *cmd[1:]]


def _build_native() -> Path:
    cxx = cxx_command()
    h = hashlib.sha1(" ".join([*cxx, *CXX_FLAGS]).encode())
    h.update(NATIVE_SRC.read_bytes())
    out = BUILD_DIR / f"libt360-{h.hexdigest()[:12]}-{host_fingerprint()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"the C++ compiler failed on {NATIVE_SRC.name} (exit {res.returncode}):\n"
            f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    BUILD_SECONDS["t360"] = time.perf_counter() - t0
    return out


def native_library() -> ctypes.CDLL:
    """The loaded native engine ``libt360``, built from ``native/t360.cpp``
    if needed; raises ``RuntimeError`` with the compiler's message."""
    with _LOCK:
        lib = _LIBS.get("t360")
        if lib is None:
            lib = ctypes.CDLL(str(_build_native()))
            _LIBS["t360"] = lib
        return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>`` for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _LIBS[name] = lib
        return lib



def build_all(names: Sequence[str], variants: Sequence[Tuple[str, Sequence[str]]] = ()
              ) -> Dict[Tuple[str, ...], Path]:
    """Build several sources at once, one nvcc each, all started together
    (each writes its own hash-named file), then load them; the
    ``variants`` -- (name, extra flags) -- are built in the same pool but
    not loaded.  Returns each variant's library path, keyed by (name,
    *flags)."""
    jobs = [(n, ()) for n in names] + [(n, tuple(e)) for n, e in variants]
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as ex:
        futures = [ex.submit(_build, n, e) for n, e in jobs]
        paths = [f.result() for f in futures]
    for n in names:
        library(n)
    return {(n, *e): p for (n, e), p in zip(jobs, paths) if e}
