"""A plane batch as K1 and K3 read it: one or two sources, each read
where it lies.

A source is a ``[b, H, W]`` tensor whose rows are packed (``stride(2) ==
1``, ``stride(1) == W``) and whose frames lie at least a plane apart
(``stride(0) >= H * W``, any larger stride allowed): a contiguous batch,
or a slice of a packed per-frame buffer such as the U or V view of a
decoder's yuv420p frames.  A batch of ``MAX_SOURCES`` sources is one
logical batch of ``b_0 + b_1`` frames: frame ``f`` is frame ``f`` of
source 0 for ``f < b_0``, else frame ``f - b_0`` of source 1
(:func:`locate`).  The chroma executor hands the U and V planes to K1
(or to K3, for a plan without a prefilter) as two sources, so no kernel
input is ever stacked by a copy on the card; the kernels write one
stacked output.

:func:`describe` gives what a kernel launch takes of each source: its
base pointer, frame count, frame stride in samples, and whether the base
and the frame stride are 16-byte aligned (TMA's rule, and that of K3's
16-byte ``cp.async``), memoized by pointer, shape, strides, dtype and
device, so that planes described (and checked) before cost a dict
lookup.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple, Union

import torch

MAX_SOURCES = 2
ALIGN = 16  # bytes: TMA's rule for a tensor's base and strides


class Source(NamedTuple):
    """One source as a launch takes it (a tuple: made on every launch)."""

    ptr: int  # the base pointer
    frames: int
    stride: int  # samples from one frame to the next
    aligned: bool  # the base and the frame stride 16-byte aligned


Planes = Union[torch.Tensor, Sequence[torch.Tensor]]


def as_sources(x: Planes) -> Tuple[torch.Tensor, ...]:
    """``x`` as a tuple of sources: a tensor is one; a sequence holds 1 to
    ``MAX_SOURCES``."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    if not 1 <= len(xs) <= MAX_SOURCES:
        raise ValueError(f"a plane batch is 1 to {MAX_SOURCES} sources, got {len(xs)}")
    return xs


def rows_packed(x: torch.Tensor) -> bool:
    """``x`` ([b, H, W]) has packed rows and frames at least a plane
    apart, so that a kernel reads it where it lies."""
    if x.is_contiguous():
        return True
    b, h, w = x.shape
    sb, sh, sw = x.stride()
    return (w == 1 or sw == 1) and (h == 1 or sh == w) and (b == 1 or sb >= h * w)


def frame_stride(x: torch.Tensor) -> int:
    """Samples from one frame of ``x`` to the next.  A single frame has no
    next one: its plane size, rounded up to 16 bytes (a stride TMA takes)."""
    if x.shape[0] > 1:
        return x.stride(0)
    e = ALIGN // x.element_size()
    return -(-x.shape[1] * x.shape[2] // e) * e


def check_sources(x: Planes, H: int, W: int, dtype: torch.dtype, device: torch.device,
                  what: str) -> Tuple[Tuple[torch.Tensor, ...], Tuple[Source, ...]]:
    """The sources of ``x``, each checked -- a tensor of ``dtype``
    samples, ``[b, H, W]`` with ``b > 0``, packed rows
    (:func:`rows_packed`), on ``device`` -- and their descriptions
    (:func:`describe`).  A source described before is checked against
    its memoized key.  Raises ``TypeError`` or ``ValueError``; nothing is
    copied."""
    xs = as_sources(x)
    src = []
    for s in xs:
        if not isinstance(s, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(s).__name__}")
        key = _key(s)
        d = _MEMO.get(key)
        if d is None or key[1][1:] != (H, W) or key[3] != dtype or key[4] != device:
            _check(s, H, W, dtype, device, what)
            d = _describe(s, key)
        src.append(d)
    return xs, tuple(src)


def _check(s: torch.Tensor, H: int, W: int, dtype: torch.dtype, device: torch.device,
           what: str) -> None:
    if s.dtype != dtype:
        raise TypeError(f"these {what} tables take {dtype} planes, got {s.dtype}")
    shape = s.shape
    if len(shape) != 3 or shape[1] != H or shape[2] != W:
        raise ValueError(f"{what} expects [B, {H}, {W}], got {tuple(shape)}")
    if shape[0] == 0:
        raise ValueError("empty batch")
    if not rows_packed(s):
        raise ValueError(f"{what} takes planes with packed rows, frames at least a plane "
                         f"apart; got strides {s.stride()}")
    if s.device != device:
        raise ValueError(f"plane on {s.device} but the {what} tables on {device}")


def describe(xs: Sequence[torch.Tensor]) -> Tuple[Source, ...]:
    """Each source's base pointer, frame count, frame stride in samples
    and alignment.  The description of a source with packed rows is
    memoized by its pointer, shape, strides, dtype and device, so that a
    batch described before costs a dict lookup."""
    return tuple([_describe(s, _key(s)) for s in xs])


_MEMO: Dict[tuple, Source] = {}
MEMO_MAX = 4096  # descriptions kept; the memo starts anew past this many


def _key(s: torch.Tensor) -> tuple:
    return s.data_ptr(), s.shape, s.stride(), s.dtype, s.device


def _describe(s: torch.Tensor, key: tuple) -> Source:
    d = _MEMO.get(key)
    if d is None:
        ptr, b = key[0], key[1][0]
        fs = key[2][0] if b > 1 else frame_stride(s)
        d = Source(ptr, b, fs, ptr % ALIGN == 0 and fs * s.element_size() % ALIGN == 0)
        if len(key[1]) == 3 and b > 0 and rows_packed(s):  # a memoized source is one
            if len(_MEMO) >= MEMO_MAX:
                _MEMO.clear()
            _MEMO[key] = d
    return d


def frames(xs: Sequence[torch.Tensor]) -> int:
    """Frames of the logical batch."""
    return sum(s.shape[0] for s in xs)


def locate(counts: Sequence[int], f: int) -> Tuple[int, int]:
    """(source, its frame) of frame ``f`` of the logical batch of sources
    of ``counts`` frames, as the kernels map it."""
    if not 0 <= f < sum(counts):
        raise IndexError(f"frame {f} of a batch of {sum(counts)}")
    i = 0
    while f >= counts[i]:
        f -= counts[i]
        i += 1
    return i, f


def stacked(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The logical batch as one tensor (a cat of several sources): the
    plain versions' input on the CPU."""
    return xs[0] if len(xs) == 1 else torch.cat(list(xs))
