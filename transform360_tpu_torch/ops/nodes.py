"""The C ABI seam of the kernels K1, K3 and K4: how a wrapper binds a
kernel library, launches it, records the launch as a graph node and
re-points that node.

Each kernel library (``csrc/blur.cu``, ``window.cu``, ``area.cu``)
exports ``t360_<k>(call, stream, node out)``, ``t360_<k>_update(graph
exec, node, call)``, ``t360_<k>_attrs(ints..., out)`` and
``t360_error_string(err)``, ``call`` being one ctypes structure that
mirrors the ``.cu``'s own.  A :class:`Kernel` holds that protocol for one
library, from its binding to the front of its ``*_px`` wrapper; K1's and
K3's calls share the source/output prefix :class:`PlaneCall`.  The kernel
modules keep their tile plans, their call fields past the pointers and
their launch choices.

A plane executor (``pipeline.PlaneExecutor``) captures its program in a
CUDA graph once per shape and replays that graph on each caller's planes.
While :func:`recording` is active on a thread, every launch made there
asks its C entry point for the kernel node it added to the capture and
appends a :class:`Node`: the handle, the sources and output it was
captured with, and its update (:meth:`Kernel.update` on the launch's own
call: copy, grid, frames per CTA), which re-points the node in the
instantiated graph.  The C library builds an update's arguments with the
function that builds a launch's, so a replay runs what an eager launch on
those planes would.

:class:`Program` keeps the nodes that touch the caller's memory: those
that read the program's sources (K1's, or K3's in a plan without a
prefilter) and those that write its output (K3's, or K4's in a
supersampled plan).  The nodes between them read and write the graph's
own intermediates, which stay where they were captured.  A node is
updated only where its pointers change: a caller that hands the same
planes again, or gets an output block back from the caching allocator,
pays for no update of it.  The counter ``nodes.updates``
(:data:`..utils.profiling.COUNTERS`) counts the updates made; the span
``t360.executor.repoint`` times :meth:`Program.repoint`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.profiling import COUNTERS, count, span
from . import _build
from .sources import Source

_LOCAL = threading.local()
_LOCK = threading.Lock()
_RESIDENT: Dict[tuple, int] = {}  # (kernel, device, its key...) -> resident CTAs
ATTRS = ("registers", "local_bytes", "ctas_per_sm", "smem_bytes", "threads")


class Node(NamedTuple):
    """One kernel launch captured in a graph."""

    handle: int  # the cudaGraphNode_t
    src: Tuple[Source, ...]  # the sources it read at capture
    out: int  # the output pointer it wrote at capture
    # update(exec, handle, sources, output pointer): re-point the node in
    # the instantiated graph exec; raises if the C library refuses
    update: Callable[[int, int, Tuple[Source, ...], int], None]


class PlaneCall(ctypes.Structure):
    """The prefix of K1's and K3's calls: source 0 (base, frame stride in
    samples, frames), source 1 (base or null, frame stride) and the
    output, in the order of the ``.cu`` structs' first six fields."""

    _fields_ = [
        ("src0", ctypes.c_void_p), ("fs0", ctypes.c_longlong), ("b0", ctypes.c_int),
        ("src1", ctypes.c_void_p), ("fs1", ctypes.c_longlong),
        ("dst", ctypes.c_void_p),
    ]

    def point(self, src: Tuple[Source, ...], out: int) -> None:
        """Set the sources (described, :func:`.sources.describe`) and the
        output: what a replay re-points."""
        s0, s1 = src[0], src[-1]
        self.src0, self.fs0, self.b0 = s0.ptr, s0.stride, s0.frames
        self.src1, self.fs1 = s1.ptr if len(src) > 1 else None, s1.stride
        self.dst = out


@contextlib.contextmanager
def recording():
    """Collect the nodes of the launches made on this thread (a list of
    :class:`Node`, in launch order) while the block runs."""
    nodes: List[Node] = []
    _LOCAL.nodes = nodes
    try:
        yield nodes
    finally:
        _LOCAL.nodes = None


class Kernel:
    """The C ABI of one kernel library, ``lib<name>``: its call structure
    ``call`` (with a ``point(src, out)`` method), the number of int
    arguments of its attributes entry and of the attributes it returns
    (:data:`ATTRS`), what its messages call its planes, and the counter
    that :meth:`run` increments per launch (``_u16`` appended for uint16
    samples; None: the module counts its own launches)."""

    def __init__(self, name: str, call: type, attrs_args: int, attrs_out: int, what: str,
                 counter: Optional[str] = None):
        self.name, self.call, self.what, self.counter = name, call, what, counter
        self._attrs_args, self._attrs_out = attrs_args, attrs_out
        self._launch_entry, self._update_entry = f"t360_{name}", f"t360_{name}_update"
        self._attrs_entry = f"t360_{name}_attrs"

    def bind(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        """Give ``lib`` (a build of this kernel, shipped or a variant)
        its entries' argument and result types, once."""
        fn = getattr(lib, self._launch_entry)
        if fn.argtypes is None:
            call = ctypes.POINTER(self.call)
            update = getattr(lib, self._update_entry)
            update.argtypes = [ctypes.c_void_p, ctypes.c_void_p, call]  # graph, node, call
            update.restype = ctypes.c_int
            attrs = getattr(lib, self._attrs_entry)
            attrs.argtypes = [ctypes.c_int] * self._attrs_args + [ctypes.c_void_p]
            attrs.restype = ctypes.c_int
            lib.t360_error_string.argtypes = [ctypes.c_int]
            lib.t360_error_string.restype = ctypes.c_char_p
            fn.restype = ctypes.c_int
            # call, stream, where the node is returned
            fn.argtypes = [call, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        return lib

    def library(self) -> ctypes.CDLL:
        """The shipped build (:func:`._build.library`), bound."""
        return self.bind(_build.library(self.name))

    @staticmethod
    def error(lib: ctypes.CDLL, err: int) -> str:
        """What the library's nonzero return ``err`` means."""
        if err < 0:
            return f"cuTensorMapEncodeTiled returned CUresult {-err}"
        return lib.t360_error_string(err).decode()

    def launch(self, lib: ctypes.CDLL, call: ctypes.Structure, src: Tuple[Source, ...],
               out: int, stream: int) -> None:
        """Point the filled ``call`` at the sources ``src`` (described)
        and the output at ``out`` and launch it on the CUDA stream
        ``stream``.  While a capture is recorded (:func:`recording`), the
        node it added is recorded with its update.  Raises if the launch
        fails."""
        call.point(src, out)
        nodes = getattr(_LOCAL, "nodes", None)
        ref = None if nodes is None else ctypes.c_void_p()
        err = getattr(lib, self._launch_entry)(ctypes.byref(call), stream,
                                               None if ref is None else ctypes.byref(ref))
        if err:
            raise RuntimeError(f"{self.name} kernel launch failed: {self.error(lib, err)}")
        if nodes is not None:
            if not ref.value:
                raise RuntimeError("a kernel launched while recording added no node: its "
                                   "stream is not being captured")
            nodes.append(Node(ref.value, src, out, functools.partial(self.update, lib, call)))

    def update(self, lib: ctypes.CDLL, call: ctypes.Structure, exec_: int, node: int,
               src: Tuple[Source, ...], out: int) -> None:
        """Re-point a captured launch's node in the graph ``exec_`` at the
        sources ``src`` and the output at ``out``, with the rest of its
        ``call`` as captured.  Raises if the library refuses them (a TMA
        copy or vector accesses that the new pointers do not allow)."""
        call.point(src, out)
        err = getattr(lib, self._update_entry)(exec_, node, ctypes.byref(call))
        if err:
            raise RuntimeError(f"{self.name} kernel node update failed: {self.error(lib, err)}")

    def attrs(self, lib: ctypes.CDLL, *args: int) -> dict:
        """One instantiation's attributes on the current GPU
        (``t360_<name>_attrs(*args)``), by name (:data:`ATTRS`)."""
        lib = lib or self.library()
        out = (ctypes.c_int * self._attrs_out)()
        err = getattr(lib, self._attrs_entry)(*args, out)
        if err:
            raise RuntimeError(f"{self.name} kernel attributes: {self.error(lib, err)}")
        return dict(zip(ATTRS, out))

    def resident(self, key: tuple, per_sm: Callable[[], int]) -> int:
        """CTAs of an instantiation resident on all of the current card's
        SMs at once: ``per_sm()`` (its attributes) times the SMs, memoized
        per card and ``key`` (the instantiation and, last, its shared
        memory bytes)."""
        dev = torch.cuda.current_device()
        k = (self.name, dev) + key
        with _LOCK:
            n = _RESIDENT.get(k)
        if n is None:
            ctas = per_sm()
            if ctas <= 0:
                raise RuntimeError(f"{self.name} kernel: no CTA fits an SM with {key[-1]} B "
                                   f"of shared memory")
            n = ctas * torch.cuda.get_device_properties(dev).multi_processor_count
            with _LOCK:
                _RESIDENT[k] = n
        return n

    def run(self, dev: torch.device, sample_bytes: int, maxval: int, shape: tuple,
            dtype: torch.dtype, plain: Callable[[], torch.Tensor],
            launch: Callable[[ctypes.CDLL, torch.Tensor, int], None]) -> torch.Tensor:
        """The front of a ``*_px`` wrapper whose checked planes lie on
        ``dev``: check ``maxval`` against the samples, return ``plain()``
        (the plain version) on the CPU, refuse other devices, else call
        ``launch(lib, out, stream)`` on a new ``shape`` output of ``dtype``
        inside ``dev`` and its current stream, and count it."""
        if sample_bytes == 1 and maxval != 255:
            raise ValueError(f"uint8 samples saturate at 255, not {maxval}")
        if not 255 <= maxval <= 65535:
            raise ValueError(f"largest sample {maxval} is not a depth of 8 to 16 bits")
        if dev.type == "cpu":
            return plain()
        if dev.type != "cuda":
            raise ValueError(f"{self.what} runs on cpu or cuda tensors, not {dev}")
        out = torch.empty(shape, dtype=dtype, device=dev)
        lib = self.library()
        with torch.cuda.device(dev):
            launch(lib, out, torch.cuda.current_stream(dev).cuda_stream)
        if self.counter:
            count(self.counter if sample_bytes == 1 else self.counter + "_u16")
        return out


def grid_ctas(n_items: int, resident: int) -> int:
    """The persistent grid of K1 and K4: every CTA the card holds at once
    (``resident``, :meth:`Kernel.resident`), but no more than there are
    items."""
    return max(1, min(n_items, resident))


class Program:
    """The nodes of one captured program that touch the caller's memory:
    ``(node, reads the sources, writes the output)``, from the nodes
    recorded while it was captured on the sources ``src`` into the output
    at ``out``."""

    def __init__(self, nodes: Sequence[Node], src: Tuple[Source, ...], out: int):
        self.nodes = tuple((n, n.src == src, n.out == out) for n in nodes
                           if n.src == src or n.out == out)
        if not any(r for _, r, _ in self.nodes) or not any(w for _, _, w in self.nodes):
            raise RuntimeError(f"the captured program has no node that reads its sources or "
                               f"none that writes its output ({len(nodes)} nodes recorded)")
        self._at = (src, out)  # what the nodes point at (None: not known)

    def repoint(self, exec_: int, src: Tuple[Source, ...], out: int) -> None:
        """Point the program's nodes in the instantiated graph ``exec_`` at
        the sources ``src`` and the output at ``out``; a node that already
        points there keeps its arguments."""
        with span("executor.repoint"):
            at, self._at = self._at, None  # known again once every update is made
            new_src = at is None or at[0] != src
            new_out = at is None or at[1] != out
            updated = 0
            for n, reads, writes in self.nodes:
                if (reads and new_src) or (writes and new_out):
                    n.update(exec_, n.handle, src if reads else n.src, out if writes else n.out)
                    updated += 1
            COUNTERS["nodes.updates"] += updated  # a dict increment on every replay
            self._at = (src, out)
