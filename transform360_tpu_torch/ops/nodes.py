"""The kernel nodes of a captured plane program, and their re-pointing.

A plane executor (``pipeline.PlaneExecutor``) captures its program in a
CUDA graph once per shape and replays that graph on each caller's planes.
While :func:`recording` is active on a thread, every launch of K1, K3 or
K4 made there asks its C entry point for the kernel node it added to the
capture and appends a :class:`Node`: the handle, the sources and output
it was captured with, and the launch's update, which re-points the node
in the instantiated graph with the launch's own choices (copy, grid,
frames per CTA) and new pointers.  The C library builds an update's
arguments with the function that builds a launch's, so a replay runs
what an eager launch on those planes would.

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
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from ..utils.profiling import COUNTERS, span
from .sources import Source

_LOCAL = threading.local()


class Node(NamedTuple):
    """One kernel launch captured in a graph."""

    handle: int  # the cudaGraphNode_t
    src: Tuple[Source, ...]  # the sources it read at capture
    out: int  # the output pointer it wrote at capture
    # update(exec, handle, sources, output pointer): re-point the node in
    # the instantiated graph exec; raises if the C library refuses
    update: Callable[[int, int, Tuple[Source, ...], int], None]


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


def handle_ref() -> Optional[ctypes.c_void_p]:
    """Where a launch returns its node: a ``c_void_p`` while recording,
    else ``None`` (the C entry point is not asked)."""
    return ctypes.c_void_p() if getattr(_LOCAL, "nodes", None) is not None else None


def add(ref: ctypes.c_void_p, src: Tuple[Source, ...], out: int,
        update: Callable[[int, int, Tuple[Source, ...], int], None]) -> None:
    """Record the node that a launch returned into ``ref``
    (:func:`handle_ref`, while recording)."""
    if not ref.value:
        raise RuntimeError("a kernel launched while recording added no node: its stream is "
                           "not being captured")
    _LOCAL.nodes.append(Node(ref.value, src, out, update))


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
