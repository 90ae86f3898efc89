"""Drop-in ``ffmpeg`` front end: run an UNCHANGED reference command line
on the GPU (the port of ``transform360_tpu.ffmpeg``).

The reference ships as an ``AVFilter`` compiled into libavfilter and is
driven as ``ffmpeg -i in.mp4 -vf transform360="k=v:k=v" out.mp4``
(reference ``README.md:84-95``, ``vf_transform360.c:1013-1023``).  This
module accepts that exact argv — swap ``ffmpeg`` for
``python -m transform360_tpu_torch.ffmpeg`` and nothing else changes::

    python -m transform360_tpu_torch.ffmpeg -y -i in.mp4 \
        -vf transform360="cube_edge_length=512:interpolation_alg=cubic" \
        -c:v libx264 out.mp4

It splits the command at the transform360 filter: filters BEFORE it run
in an ffmpeg decode subprocess, the transform itself runs on the GPU
(K1 and K3, batched + prefetched, same pipeline as :mod:`.cli`), and
filters AFTER
it plus every output option run in an ffmpeg encode subprocess.  The
raw pipes carry the stream's OWN negotiated pixel format whenever it is
in the pipeline's planar registry (yuv420p/422p/444p/411p/410p/440p,
gbrp, gray — matching the reference filter, which declares no format
list and processes whatever the graph negotiates,
``vf_transform360.c:87-97,107-108``); formats outside it convert to
yuv420p with a warning.  Audio from a container input is mapped through
with ``-c:a copy`` unless the command already routes streams itself
(``-map``/``-an``).  An argv with no transform360 filter is handed to
the real ``ffmpeg`` verbatim.

Wrapper-only knobs (stripped before ffmpeg parsing, or env vars):
``--t360-batch N`` / ``T360_BATCH`` (frames per device step, default 8),
``--t360-prefetch N`` / ``T360_PREFETCH`` (batches in flight, default 1),
``--t360-stats`` (JSON stats line on stderr), ``--t360-device
{cuda,cpu}`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
versions).

Scope (documented, erroring loudly otherwise): multi-output commands
run the transform output through the pipe pipeline and every other
output as its own passthrough ffmpeg process against the source (ffmpeg
applies ``-vf`` per output, so non-transform outputs never see the
transformed stream — plain ffmpeg semantics); transform360 may appear
in ONE output's filters, and not inside ``-filter_complex`` when there
are multiple outputs.  ``-filter_complex`` graphs are split
mechanically whenever the
transform360 video stream is the ONLY link crossing the cut — linear
single-stream graphs rewrite into the ``-vf`` form
(:func:`rewrite_filter_complex`), and multi-chain graphs (upstream
scale/hstack chains, downstream overlay/drawtext/audio chains, extra
inputs) run their upstream sub-graph in the decode command and the
rest in the encode command (:func:`split_complex_graph`).  A second
crossing link IS handled when it comes from a source-fed
``split``/``asplit`` chain (the common tee shape) whose pre-split filters
are all deterministic (``TEE_SAFE_FILTERS``): the crossing branch is
re-created on the encode side from the same source input.  Other
crossing shapes error with a rewrite hint.  A multi-output command whose
input is stdin or a pipe errors too: the decode and the passthrough
processes would both read it.  ffmpeg options unknown to
the tokenizer are assumed to take one value (flag-style options are
special-cased in ``FLAG_OPTS``).
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# ffmpeg options that take NO value argument.  Everything else starting
# with "-" is assumed to consume the next token.  (ffmpeg's real parser
# knows per-option arity; this is the transcoding-relevant boolean/flag
# subset of ffmpeg's own option table — fftools `ffmpeg -h full` /
# documentation "Main options" + "Advanced options", ffmpeg 6.x —
# vendored as a fixture in tests/test_ffmpeg_arity.py.  Boolean options
# also match with a per-stream specifier (-fix_sub_duration:s:0) and in
# the -noX negated form; the tokenizer normalizes both.  NOT here:
# lookalikes that DO take a value — -apad (filter-args string),
# -stats_period, -vstats_file, -copytb, -abort_on, -seek_timestamp.)
FLAG_OPTS = {
    "-y", "-n", "-an", "-vn", "-sn", "-dn", "-hide_banner", "-stdin",
    "-stats", "-shortest", "-copyts", "-re", "-autorotate",
    "-ignore_unknown", "-copy_unknown", "-recast_media", "-xerror",
    "-benchmark", "-benchmark_all", "-accurate_seek",
    "-fix_sub_duration", "-copyinkf", "-autoscale", "-bitexact",
    "-debug_ts", "-start_at_zero", "-auto_conversion_filters",
    "-dump", "-hex", "-vstats", "-psnr", "-qphist", "-report",
}


def _is_flag_opt(a: str) -> bool:
    """True when argv token ``a`` is a no-value ffmpeg option: a
    ``FLAG_OPTS`` member, its ``-no`` negation (every ffmpeg boolean
    accepts ``-noX``), or either with a ``:stream`` specifier."""
    base = a.partition(":")[0]
    if base in FLAG_OPTS:
        return True
    return base.startswith("-no") and "-" + base[3:] in FLAG_OPTS

# global ffmpeg options hoisted to BOTH subprocesses regardless of where
# they appeared in the argv
GLOBAL_FLAGS = {"-y", "-n", "-hide_banner", "-nostdin"}


class UsageError(ValueError):
    pass


def tokenize_outputs(argv: List[str]):
    """Partition an ffmpeg argv into input groups and OUTPUT groups.

    Returns ``(inputs, outputs, globals_)`` where ``inputs`` is a list
    of ``(opts, path)`` — ``opts`` being ``(key, value|None)`` pairs
    that preceded that ``-i`` — and ``outputs`` the list of
    ``(opts, path)`` output groups in order (ffmpeg applies per-output
    options like ``-vf`` to their own output only).
    """
    inputs: List[Tuple[list, str]] = []
    outputs: List[Tuple[list, str]] = []
    globals_: List[str] = []
    cur: List[Tuple[str, Optional[str]]] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-i":
            if i + 1 >= len(argv):
                raise UsageError("-i needs a path")
            inputs.append((cur, argv[i + 1]))
            cur = []
            i += 2
        elif a in GLOBAL_FLAGS:
            globals_.append(a)
            i += 1
        elif a.startswith("-") and len(a) > 1:
            if _is_flag_opt(a):
                cur.append((a, None))
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise UsageError(f"option {a} needs a value")
                cur.append((a, argv[i + 1]))
                i += 2
        else:
            outputs.append((cur, a))
            cur = []
            i += 1
    if cur:
        raise UsageError(f"trailing options with no output file: {cur}")
    if not outputs:
        raise UsageError("no output file in the command line")
    return inputs, outputs, globals_


def tokenize(argv: List[str]):
    """Single-output form of :func:`tokenize_outputs` (the reference
    wrapper's ``tokenize``): ``(inputs, out_opts, out_path, globals_)``;
    a command with several outputs raises :class:`UsageError` (``main``
    handles those through :func:`tokenize_outputs`)."""
    inputs, outputs, globals_ = tokenize_outputs(argv)
    if len(outputs) > 1:
        raise UsageError(
            f"multiple outputs ({outputs[0][1]!r}, {outputs[1][1]!r}): only one "
            "output may carry the transform360 filter"
        )
    (out_opts, out_path), = outputs
    return inputs, out_opts, out_path, globals_


def split_filterchain(graph: str, sep: str = ",") -> List[str]:
    """Split a filtergraph on top-level ``sep`` (``,`` between filters,
    ``;`` between chains), honoring ffmpeg's ``'...'`` quoting and
    backslash escapes."""
    parts, buf, quoted = [], [], False
    i = 0
    while i < len(graph):
        c = graph[i]
        if c == "\\" and i + 1 < len(graph):
            buf.append(c)
            buf.append(graph[i + 1])
            i += 2
            continue
        if c == "'":
            quoted = not quoted
        if c == sep and not quoted:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    return [p.strip() for p in parts]


def _unquote(s: str) -> str:
    """Undo one level of ffmpeg filter-option quoting/escaping."""
    s = s.strip()
    if len(s) >= 2 and s[0] == "'" and s[-1] == "'":
        s = s[1:-1]
    return re.sub(r"\\(.)", r"\1", s)


_LBL = r"\[[^\]]+\]"
_FC_HINT = (
    "graphs split mechanically when the transform360 video stream is "
    "the only link crossing the cut — linear chains, upstream producer "
    "chains, and downstream overlay/audio chains all work; rewrite the "
    "graph so no other label spans the transform360 element"
)


def rewrite_filter_complex(out_opts):
    """Rewrite a LINEAR single-stream ``-filter_complex`` graph containing
    transform360 into the ``-vf`` form the wrapper splits.

    The reference filter runs anywhere libavfilter puts it
    (``vf_transform360.c:1013-1023``); the wrapper covers the linear
    single-stream case — one optional ``[0:v]``-style input label, the
    filter chain, one optional output label whose ``-map`` is absorbed
    (the piped video IS that stream) — and errors loudly with a rewrite
    hint on anything it cannot split mechanically.

    Returns ``(new_out_opts, needs_src_input)``: when a remaining
    ``-map 0:a...`` selects source audio it is renumbered to input 1 and
    ``needs_src_input`` tells the encode command to add the source file
    as that input.
    """
    for idx, (k, v) in enumerate(out_opts):
        if k == "-filter_complex" and "transform360" in (v or ""):
            break
    else:
        return out_opts, False
    graph = v.strip()
    if ";" in graph:
        # multi-chain graphs belong to split_complex_graph (main() tries
        # that first); reaching here means a direct caller skipped it
        raise UsageError(
            "multi-chain -filter_complex: use split_complex_graph; "
            + _FC_HINT
        )
    m = re.match(rf"^((?:{_LBL})*)(.*?)((?:{_LBL})*)$", graph, re.S)
    ins = re.findall(_LBL, m.group(1))
    outs = re.findall(_LBL, m.group(3))
    chain = m.group(2).strip()
    if len(ins) > 1 or len(outs) > 1:
        raise UsageError(
            "transform360 -filter_complex with multiple input/output "
            "labels is not supported; " + _FC_HINT
        )
    if ins and ins[0] not in ("[0:v]", "[0:v:0]", "[0]", "[v:0]"):
        raise UsageError(
            f"-filter_complex input {ins[0]} is not the first video "
            "stream; " + _FC_HINT
        )
    out_lbl = outs[0][1:-1] if outs else None

    new = []
    needs_src_input = False
    for i, (k2, v2) in enumerate(out_opts):
        if i == idx:
            new.append(("-vf", chain))
            continue
        if k2 == "-map" and v2 is not None:
            target = v2.strip().strip("'\"").strip("[]")
            if out_lbl is not None and target == out_lbl:
                continue  # the piped video IS this stream now
            if target.startswith("0:a"):
                # source audio: the encode command gets the source file
                # as input 1 (input 0 is the raw video pipe)
                new.append(("-map", "1:" + target[2:]))
                needs_src_input = True
                continue
            raise UsageError(
                f"-map {v2!r} alongside a transform360 -filter_complex "
                "selects a stream the wrapper cannot route; " + _FC_HINT
            )
        new.append((k2, v2))
    return new, needs_src_input


_SRC_RE = re.compile(r"^-?\d+(?::.*)?$")   # [0:v], [1], -map 0:a ...

# Filters that give the same frames each time they run on the same
# input: the only ones a tee'd split may run twice, once in the decode
# and once in the encode process.  Anything random or stateful across
# runs (noise, random, wall-clock drawtext, ...) would make the two
# branches disagree.
TEE_SAFE_FILTERS = {
    "scale", "crop", "pad", "format", "fps", "setpts", "setsar", "setdar",
    "hflip", "vflip", "transpose", "null",
    "anull", "aformat", "asetpts", "aresample", "volume",
}


def _parse_chain(chain: str):
    """Split one filterchain into ``(in_labels, body, out_labels)``.

    ffmpeg grammar puts link labels only at the two ends of a chain
    (links between consecutive filters inside a chain are implicit).
    """
    m = re.match(rf"^((?:{_LBL})*)(.*?)((?:{_LBL})*)$", chain.strip(), re.S)
    return (
        re.findall(_LBL, m.group(1)),
        m.group(2).strip(),
        re.findall(_LBL, m.group(3)),
    )


def _is_source(label: str) -> bool:
    """True for stream-specifier labels ([0:v], [1]) vs internal links."""
    return bool(_SRC_RE.match(label[1:-1].strip()))


def _renumber_label(label: str, shift: int) -> str:
    """[i:rest] -> [i+shift:rest] for source-specifier labels."""
    if not _is_source(label):
        return label
    body = label[1:-1].strip()
    idx, sep, rest = body.partition(":")
    return f"[{int(idx) + shift}{sep}{rest}]"


@dataclasses.dataclass
class ComplexSplit:
    """A multi-chain ``-filter_complex`` graph cut at transform360.

    ``dec_fc``/``dec_map`` select the stream ENTERING the transform in
    the decode command; ``enc_fc`` (source labels already renumbered for
    the pipe at input 0) re-attaches everything downstream in the encode
    command.  ``out_opts`` is the output group with the
    ``-filter_complex`` removed and plain ``-map`` specifiers renumbered.
    """

    t360_opts: str
    dec_fc: Optional[str]
    dec_map: str
    enc_fc: Optional[str]
    out_opts: list
    needs_src_inputs: bool
    # whether the encode-side graph consumes the raw pipe ([0:v]); when it
    # does not, build_commands_complex must map the pipe video explicitly —
    # real ffmpeg implicitly maps an unlabeled filter output, and user -map
    # options would otherwise silently drop the transformed stream
    pipe_consumed: bool = True


def split_complex_graph(out_opts):
    """Cut a MULTI-chain ``-filter_complex`` graph at its transform360.

    The reference filter runs anywhere libavfilter puts it
    (``vf_transform360.c:1013-1023``).  Any graph splits mechanically
    when the transform's video stream is the ONLY link crossing the cut:
    chains feeding the transform (transitive producers of its input
    label) run in the decode command, every other chain — overlays,
    audio chains, post filters — runs in the encode command with the
    transformed video piped in as input 0 and the source files shifted
    one input slot up.  A ``split``/``asplit`` chain fed directly by
    source streams whose branches land on both sides is TEE'd: the
    decode side keeps the transform branch, the encode side re-creates
    the crossing branch from the renumbered source (pre-split filters
    run on both sides, so each must be in ``TEE_SAFE_FILTERS``).  Any other
    crossing link errors with the rewrite hint.

    Returns a :class:`ComplexSplit`, or ``None`` when no multi-chain
    transform360 ``-filter_complex`` is present (single-chain graphs stay
    on :func:`rewrite_filter_complex`).
    """
    for idx, (k, v) in enumerate(out_opts):
        if (
            k == "-filter_complex"
            and "transform360" in (v or "")
            and ";" in v
        ):
            break
    else:
        return None
    chains = [_parse_chain(c) for c in split_filterchain(v.strip(), ";") if c]

    # locate the (single) chain holding transform360 and cut it
    t_idx = t360_opts = pre = post = None
    for ci, (ins, body, outs) in enumerate(chains):
        for j, elem in enumerate(split_filterchain(body)):
            name, _, opts = elem.partition("=")
            if name.strip() != "transform360":
                continue
            if t_idx is not None:
                raise UsageError(
                    "multiple transform360 filters in one "
                    "-filter_complex are not supported; " + _FC_HINT
                )
            t_idx, t360_opts = ci, _unquote(opts)
            elems = split_filterchain(body)
            pre, post = elems[:j], elems[j + 1:]
    if t_idx is None:
        raise UsageError(
            "transform360 inside this -filter_complex is not "
            "supported; " + _FC_HINT
        )
    t_ins, _, t_outs = chains[t_idx]
    if len(t_ins) > 1 and not pre:
        raise UsageError(
            "transform360 takes one input stream; " + _FC_HINT
        )
    if not t_ins and len(chains) > 1:
        raise UsageError(
            "the transform360 chain needs an explicit input label in a "
            "multi-chain -filter_complex; " + _FC_HINT
        )
    if len(t_outs) > 1:
        raise UsageError(
            "the transform360 chain ends in multiple output labels; "
            + _FC_HINT
        )

    # upstream closure: chains that (transitively) produce the labels the
    # pre-transform segment consumes run in the decode command
    produced = {}
    for ci, (ins, body, outs) in enumerate(chains):
        for lbl in outs:
            produced[lbl] = ci
    upstream = set()
    needed = [lbl for lbl in t_ins if not _is_source(lbl)]
    while needed:
        lbl = needed.pop()
        ci = produced.get(lbl)
        if ci is None:
            raise UsageError(
                f"-filter_complex label {lbl} has no producing chain"
            )
        if ci == t_idx:
            raise UsageError(
                f"-filter_complex label {lbl} cycles through the "
                "transform360 chain; " + _FC_HINT
            )
        if ci in upstream:
            continue
        upstream.add(ci)
        needed += [
            l for l in chains[ci][0] if not _is_source(l)
        ]

    down_idx = [
        ci for ci in range(len(chains))
        if ci != t_idx and ci not in upstream
    ]

    # the transform stream must be the ONLY link crossing the cut — with
    # one mechanical exception: a crossing label produced by a SOURCE-fed
    # chain ending in split/asplit can be tee'd (the decode side keeps
    # the pre-split body for the transform branch; the encode side
    # re-creates the crossing branch from the same source input, shifted
    # one slot).  Pre-split filters then run in both subprocesses, so
    # each must be in TEE_SAFE_FILTERS.
    crossing: Dict[int, list] = {}
    for ci in down_idx:
        for lbl in chains[ci][0]:
            if not _is_source(lbl) and produced.get(lbl) in upstream:
                ls = crossing.setdefault(produced[lbl], [])
                if lbl not in ls:
                    ls.append(lbl)
    dec_override = {}
    tee_chains = []
    tee_src = False
    for pi, lbls in crossing.items():
        ins, body, outs = chains[pi]
        elems = split_filterchain(body)
        name = elems[-1].partition("=")[0].strip()
        if name not in ("split", "asplit") or any(
            not _is_source(l) for l in ins
        ):
            raise UsageError(
                f"-filter_complex label {lbls[0]} is produced before "
                "transform360 but consumed after it — a second link "
                "would cross the transform cut; " + _FC_HINT
            )
        unsafe = [e for e in elems[:-1]  # "name@instance=args"
                  if e.partition("=")[0].partition("@")[0].strip() not in TEE_SAFE_FILTERS]
        if unsafe:
            raise UsageError(
                f"-filter_complex: the filters before {name} ({', '.join(unsafe)}) "
                "would run twice, in the decode and in the encode process, and "
                "only deterministic filters may (" + ", ".join(sorted(TEE_SAFE_FILTERS))
                + "); move them after the split, or split the source in a "
                "separate ffmpeg run first"
            )
        null = "null" if name == "split" else "anull"
        outs_up = [l for l in outs if l not in lbls]
        outs_down = [l for l in outs if l in lbls]

        def branch(pre, outs_side):
            if len(outs_side) > 1:
                pre = pre + [f"{name}={len(outs_side)}"]
            return ",".join(pre or [null]) + "".join(outs_side)

        dec_override[pi] = "".join(ins) + branch(elems[:-1], outs_up)
        tee_chains.append(
            "".join(_renumber_label(l, 1) for l in ins)
            + branch(elems[:-1], outs_down)
        )
        tee_src = tee_src or any(_is_source(l) for l in ins)
    consumed = {
        lbl
        for ins, _, _ in chains
        for lbl in ins
        if not _is_source(lbl)
    }
    for ci in upstream:
        for lbl in chains[ci][2]:
            if lbl not in consumed:
                raise UsageError(
                    f"-filter_complex label {lbl} from a pre-transform360 "
                    "chain is never consumed before the transform; "
                    + _FC_HINT
                )

    # ---- decode side: upstream chains + the pre-transform segment
    # (tee'd split chains keep only their upstream branch here)
    dec_chains = [
        dec_override.get(
            ci,
            "".join(chains[ci][0]) + chains[ci][1] + "".join(chains[ci][2]),
        )
        for ci in sorted(upstream)
    ]
    if pre:
        dec_chains.append("".join(t_ins) + ",".join(pre) + "[__t360in]")
        dec_map = "[__t360in]"
    elif t_ins and not _is_source(t_ins[0]):
        dec_map = t_ins[0]
    else:
        # a bare file index ([1]) would "-map 1" EVERY stream of that
        # input into the rawvideo pipe; qualify it to the video stream
        body = t_ins[0][1:-1].strip() if t_ins else "0:v"
        dec_map = body if ":" in body else body + ":v"
    dec_fc = ";".join(dec_chains) if dec_chains else None

    # ---- encode side: the post segment + downstream chains, with the
    # transformed video piped in as input 0 (source files shift +1)
    enc_chains = []
    if post or t_outs:
        enc_chains.append(
            "[0:v]" + ",".join(post or ["null"]) + "".join(t_outs)
        )
    for ci in down_idx:
        ins, body, outs = chains[ci]
        enc_chains.append(
            "".join(_renumber_label(l, 1) for l in ins)
            + body
            + "".join(outs)
        )
    enc_chains.extend(tee_chains)
    enc_fc = ";".join(enc_chains) if enc_chains else None

    # output options: drop the -filter_complex, renumber plain -map
    # stream specifiers (label maps pass through; labels produced only
    # on the decode side cannot be mapped into the output)
    enc_labels = {lbl for c in enc_chains for lbl in _parse_chain(c)[2]}
    new_opts = []
    needs_src = tee_src or any(
        _is_source(l) for ci in down_idx for l in chains[ci][0]
    )
    for i, (k2, v2) in enumerate(out_opts):
        if i == idx:
            continue
        if k2 == "-map" and v2 is not None:
            target = v2.strip().strip("'\"")
            if target.startswith("["):
                if target not in enc_labels:
                    raise UsageError(
                        f"-map {v2!r} selects a label on the decode side "
                        "of the transform360 cut; " + _FC_HINT
                    )
            elif _SRC_RE.match(target):
                neg = target.startswith("-")
                body = target[1:] if neg else target
                si, sep, rest = body.partition(":")
                target = f"{'-' if neg else ''}{int(si) + 1}{sep}{rest}"
                needs_src = True
            new_opts.append(("-map", target))
            continue
        new_opts.append((k2, v2))
    return ComplexSplit(
        t360_opts=t360_opts,
        dec_fc=dec_fc,
        dec_map=dec_map,
        enc_fc=enc_fc,
        out_opts=new_opts,
        needs_src_inputs=needs_src,
        pipe_consumed=bool(post or t_outs),
    )


def find_transform360(out_opts):
    """Locate the video-filter option and the transform360 element in it.

    Returns ``(vf_index, pre_chain, t360_options, post_chain)`` or
    ``None`` when the command has no transform360 filter.
    """
    for idx, (k, v) in enumerate(out_opts):
        if k == "-filter_complex" and "transform360" in v:
            raise UsageError(
                "transform360 inside this -filter_complex is not "
                "supported; " + _FC_HINT
            )
        if k == "-vf" or k == "-filter:v" or k.startswith("-filter:v:"):
            chain = split_filterchain(v)
            for j, elem in enumerate(chain):
                name, _, opts = elem.partition("=")
                if name.strip() == "transform360":
                    return idx, chain[:j], _unquote(opts), chain[j + 1:]
    return None


_OUT_RE = re.compile(r"Output #0.*?(\d{2,5})x(\d{2,5})", re.S)
_FPS_RE = re.compile(r"([\d.]+) fps")
_PIX_RE = re.compile(r"Video:[^,]+,\s*([a-z0-9_]+)")


def probe_decoded(in_opts, in_path, pre_chain):
    """Size, rate, and pixel format of the stream ENTERING transform360.

    With no preceding filters this is an ffprobe of the input; otherwise
    one frame is pushed through the pre-chain into the null muxer and the
    Output #0 stream line is parsed — ffmpeg itself reports the
    negotiated post-filter geometry and format.  Returns
    ``(w, h, fps, pix_fmt)``.
    """
    from .utils.video import _probe_ffmpeg

    if not pre_chain:
        return _probe_ffmpeg(in_path)
    cmd = ["ffmpeg", "-hide_banner", *_flatten(in_opts), "-i", in_path,
           "-vf", ",".join(pre_chain), "-frames:v", "1", "-f", "null", "-"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    tail = r.stderr.split("Output #0", 1)
    m = _OUT_RE.search("Output #0" + tail[1]) if len(tail) == 2 else None
    if r.returncode or not m:
        raise UsageError(
            "cannot determine the frame size after the pre-transform360 "
            f"filters {pre_chain}: {r.stderr.strip().splitlines()[-1:]}"
        )
    fm = _FPS_RE.search(tail[1])
    pm = _PIX_RE.search(tail[1])
    return (
        int(m.group(1)), int(m.group(2)),
        float(fm.group(1)) if fm else 30.0,
        pm.group(1) if pm else "yuv420p",
    )


def probe_decoded_complex(inputs, cs: "ComplexSplit"):
    """Size, rate, and pixel format of the stream ENTERING transform360
    for a multi-chain ``-filter_complex`` split (the decode-side graph
    pushed one frame into the null muxer, like :func:`probe_decoded`)."""
    from .utils.video import _probe_ffmpeg

    if cs.dec_fc is None and not cs.dec_map.startswith("["):
        idx = int(cs.dec_map.partition(":")[0])
        return _probe_ffmpeg(inputs[idx][1])
    cmd = ["ffmpeg", "-hide_banner"]
    for opts, path in inputs:
        cmd += [*_flatten(opts), "-i", path]
    if cs.dec_fc:
        cmd += ["-filter_complex", cs.dec_fc]
    cmd += ["-map", cs.dec_map, "-frames:v", "1", "-f", "null", "-"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    tail = r.stderr.split("Output #0", 1)
    m = _OUT_RE.search("Output #0" + tail[1]) if len(tail) == 2 else None
    if r.returncode or not m:
        raise UsageError(
            "cannot determine the frame size entering transform360 in "
            f"the -filter_complex graph: {r.stderr.strip().splitlines()[-1:]}"
        )
    fm = _FPS_RE.search(tail[1])
    pm = _PIX_RE.search(tail[1])
    return (
        int(m.group(1)), int(m.group(2)),
        float(fm.group(1)) if fm else 30.0,
        pm.group(1) if pm else "yuv420p",
    )


# Information-preserving pipe conversions for formats the pipeline does
# not process directly: ffmpeg's swscale performs them without losing
# sample information (semi-planar -> planar re-arranges bytes; 9->10 and
# 14->16 bit are left shifts).  Big-endian twins are handled generically
# (byte-order swap to the registered *le form).
LOSSLESS_PIPE = {
    "nv12": "yuv420p", "nv21": "yuv420p",          # 8-bit semi-planar
    "p010le": "yuv420p10le", "p010be": "yuv420p10le",  # 10-bit semi-planar
    "p210le": "yuv422p10le", "p410le": "yuv444p10le",
    "p012le": "yuv420p12le", "p212le": "yuv422p12le",
    "p016le": "yuv420p16le", "p216le": "yuv422p16le",
    "p416le": "yuv444p16le",
    "yuv420p9le": "yuv420p10le", "yuv422p9le": "yuv422p10le",
    "yuv444p9le": "yuv444p10le",
    "yuv420p14le": "yuv420p16le", "yuv422p14le": "yuv422p16le",
    "yuv444p14le": "yuv444p16le",
    "gray9le": "gray10le", "gray14le": "gray16le",
}


def pipe_format(src_fmt: str) -> str:
    """Raw-pipe pixel format for a probed source format.

    The reference filter declares no pix-fmt list: it processes whatever
    planar format the graph negotiates, reading plane count and chroma
    shifts from the descriptor (``vf_transform360.c:87-97,107-108``).
    Formats in the pipeline's registry pass through losslessly (yuvj*
    renamed to their byte-identical yuv* twin — the rawvideo pipe has no
    JPEG-range tag), INCLUDING the 10/12/16-bit ``*le`` planar formats,
    which the pipeline computes natively in 16-bit containers (beyond
    the reference, which wraps planes as CV_8U bytes and corrupts them —
    ``VideoFrameTransform.cpp:1331-1335``).  Formats with a lossless
    registered twin — semi-planar (nv12/p010le, the hardware-decoder
    staples), big-endian, and 9/14-bit — convert to it at the pipe,
    preserving full sample depth.  Anything else (packed RGB, alpha)
    converts to yuv420p with a loud warning.
    """
    from .config import PIXEL_FORMATS

    fmt = (src_fmt or "yuv420p").lower()
    if fmt.startswith("yuvj"):
        fmt = "yuv" + fmt[4:]
    if fmt in PIXEL_FORMATS:
        return fmt
    le = fmt[:-2] + "le" if fmt.endswith("be") else None
    target = LOSSLESS_PIPE.get(fmt) or (
        le if le in PIXEL_FORMATS else LOSSLESS_PIPE.get(le or "")
    )
    if target:
        print(
            f"info: pix_fmt {src_fmt!r} pipes as {target!r} "
            "(information-preserving conversion at the decode pipe)",
            file=sys.stderr,
        )
        return target
    print(
        f"warning: pix_fmt {src_fmt!r} has no lossless planar twin in "
        "the pipeline's registry; converting to yuv420p at the decode "
        "pipe",
        file=sys.stderr,
    )
    return "yuv420p"


def _flatten(opts) -> List[str]:
    out = []
    for k, v in opts:
        out.append(k)
        if v is not None:
            out.append(v)
    return out


def _extract_t360_opts(argv: List[str]):
    batch = int(os.environ.get("T360_BATCH", "8"))
    prefetch = int(os.environ.get("T360_PREFETCH", "1"))
    stats = False
    device = "cuda"
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--t360-batch":
            batch = int(argv[i + 1])
            i += 2
        elif a == "--t360-prefetch":
            prefetch = int(argv[i + 1])
            i += 2
        elif a == "--t360-stats":
            stats = True
            i += 1
        elif a == "--t360-device":
            device = argv[i + 1] if i + 1 < len(argv) else ""
            if device not in ("cuda", "cpu"):
                raise UsageError(f"--t360-device takes cuda or cpu, not {device!r}")
            i += 2
        else:
            rest.append(a)
            i += 1
    return batch, prefetch, stats, device, rest


def build_commands(inputs, out_opts, out_path, globals_, found, size_rate,
                   out_dims, pix_fmt="yuv420p", needs_src_input=False):
    """Assemble the decode and encode ffmpeg argvs (pure, for tests)."""
    vf_idx, pre_chain, _, post_chain = found
    (in_opts, in_path) = inputs[0]
    in_w, in_h, fps = size_rate
    out_w, out_h = out_dims

    dec = ["ffmpeg", "-v", "error", "-nostdin", *_flatten(in_opts),
           "-i", in_path]
    if pre_chain:
        dec += ["-vf", ",".join(pre_chain)]
    dec += ["-f", "rawvideo", "-pix_fmt", pix_fmt, "-"]

    enc_opts = [p for i, p in enumerate(out_opts) if i != vf_idx]
    overwrite = [f for f in globals_ if f in ("-y", "-n")]
    enc = ["ffmpeg", "-v", "error", *overwrite,
           "-f", "rawvideo", "-pix_fmt", pix_fmt,
           "-s", f"{out_w}x{out_h}", "-r", f"{fps}", "-i", "-"]
    # carry the audio (and let -c:a copy skip a useless re-encode) the way
    # the in-process reference filter graph does — unless the user routes
    # streams explicitly or the IO is raw video anyway
    user_keys = {k for k, _ in enc_opts}
    raw_io = ("-f", "rawvideo") in enc_opts or in_path.endswith(
        (".yuv", ".raw", ".i420")
    )
    if needs_src_input:
        # a rewritten -filter_complex kept explicit source-audio maps
        # (renumbered to input 1): provide that input and map the piped
        # video as stream 0
        enc += ["-i", in_path, "-map", "0:v"]
    elif (
        not raw_io
        and "-map" not in user_keys
        and "-an" not in user_keys
    ):
        enc += ["-i", in_path, "-map", "0:v", "-map", "1:a?"]
        if not ({"-c:a", "-acodec", "-c"} & user_keys):
            enc += ["-c:a", "copy"]
    enc += _flatten(enc_opts)
    if post_chain:
        enc += ["-vf", ",".join(post_chain)]
    enc += [out_path]
    return dec, enc


def build_commands_complex(inputs, cs: "ComplexSplit", out_path, globals_,
                           size_rate, out_dims, pix_fmt="yuv420p"):
    """Assemble the decode and encode argvs for a multi-chain
    ``-filter_complex`` split (pure, for tests).

    Decode command: all source inputs in their original slots, the
    upstream sub-graph, the transform's input stream mapped to a raw
    pipe.  Encode command: the raw pipe as input 0, the source files
    shifted to inputs 1..n when the downstream sub-graph or the maps
    reference them, the downstream sub-graph, then the user's output
    options (already renumbered by :func:`split_complex_graph`).
    """
    in_w, in_h, fps = size_rate
    out_w, out_h = out_dims

    dec = ["ffmpeg", "-v", "error", "-nostdin"]
    for opts, path in inputs:
        dec += [*_flatten(opts), "-i", path]
    if cs.dec_fc:
        dec += ["-filter_complex", cs.dec_fc]
    dec += ["-map", cs.dec_map,
            "-f", "rawvideo", "-pix_fmt", pix_fmt, "-"]

    overwrite = [f for f in globals_ if f in ("-y", "-n")]
    enc = ["ffmpeg", "-v", "error", *overwrite,
           "-f", "rawvideo", "-pix_fmt", pix_fmt,
           "-s", f"{out_w}x{out_h}", "-r", f"{fps}", "-i", "-"]
    user_keys = {k for k, _ in cs.out_opts}
    add_default_audio = (
        "-map" not in user_keys
        and "-an" not in user_keys
        and not inputs[0][1].endswith((".yuv", ".raw", ".i420"))
    )
    if cs.needs_src_inputs or add_default_audio:
        for opts, path in inputs:
            enc += [*_flatten(opts), "-i", path]
    if cs.enc_fc:
        enc += ["-filter_complex", cs.enc_fc]
    if not cs.pipe_consumed:
        # the encode-side graph never consumes the raw pipe (transform
        # chain ended with no output label): map the transformed video
        # explicitly, ahead of any user maps — mirroring real ffmpeg's
        # implicit mapping of an unlabeled filter output
        enc += ["-map", "0:v"]
    if add_default_audio:
        enc += ["-map", "1:a?"]
        if not ({"-c:a", "-acodec", "-c"} & user_keys):
            enc += ["-c:a", "copy"]
    enc += _flatten(cs.out_opts)
    enc += [out_path]
    return dec, enc


def build_command_extra(inputs, out_opts, out_path, globals_):
    """Passthrough ffmpeg argv for a NON-transform output of a
    multi-output command (pure, for tests).

    ffmpeg applies per-output options to their own output, so an output
    without transform360 sees only the source streams — it runs against
    the original inputs with exactly its own option group, preserving
    plain ffmpeg stream-selection semantics."""
    overwrite = [f for f in globals_ if f in ("-y", "-n")]
    cmd = ["ffmpeg", "-v", "error", "-nostdin", *overwrite]
    for opts, path in inputs:
        cmd += [*_flatten(opts), "-i", path]
    return cmd + _flatten(out_opts) + [out_path]


def _is_stream_input(path: str) -> bool:
    """True for an input that can be read only once (stdin or a pipe)."""
    return path == "-" or path.startswith("pipe:") or path == "/dev/stdin"


def _probed_inputs(inputs, cs) -> List[str]:
    """The input paths that :func:`probe_decoded` or
    :func:`probe_decoded_complex` read before the decode process starts."""
    if cs is None:
        return [inputs[0][1]]
    if cs.dec_fc is None and not cs.dec_map.startswith("["):
        return [inputs[int(cs.dec_map.partition(":")[0])][1]]
    return [p for _, p in inputs]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    try:
        batch, prefetch, want_stats, device, argv = _extract_t360_opts(argv)
        inputs, outputs, globals_ = tokenize_outputs(argv)

        def _has_t360(opts):
            return any(
                "transform360" in (v or "")
                and (
                    k in ("-vf", "-filter:v", "-filter_complex")
                    or k.startswith("-filter:v:")
                )
                for k, v in opts
            )

        extra_outputs: List[Tuple[list, str]] = []
        if len(outputs) > 1:
            # ffmpeg applies -vf per OUTPUT: the transform output runs
            # through the pipe pipeline; every other output sees only the
            # SOURCE streams, so it runs as its own passthrough ffmpeg
            # process with exactly its own options — plain ffmpeg
            # semantics, no stream-mapping surgery
            if any(
                k == "-filter_complex" and "transform360" in (v or "")
                for o, _ in outputs for k, v in o
            ) or any(
                p[0] == "-filter_complex" and "transform360" in (p[1] or "")
                for opts, _ in inputs for p in opts
            ):
                raise UsageError(
                    "multi-output commands with transform360 inside "
                    "-filter_complex are not supported; put the "
                    "transform in the -vf of its output"
                )
            t_list = [i for i, (o, _) in enumerate(outputs) if _has_t360(o)]
            if len(t_list) > 1:
                raise UsageError(
                    "transform360 appears in more than one output's "
                    "filters; the wrapper transforms one output stream"
                )
            k = t_list[0] if t_list else 0
            out_opts, out_path = outputs[k]
            extra_outputs = [o for i, o in enumerate(outputs) if i != k]
            piped = [p for _, p in inputs if _is_stream_input(p)]
            if t_list and piped:
                raise UsageError(
                    f"input {piped[0]!r} is a stream that can be read only once, "
                    "but this command has several outputs: the decode process "
                    "and each passthrough process would all read it; write the "
                    "stream to a file first, or run one command per output"
                )
        else:
            ((out_opts, out_path),) = outputs
        # -filter_complex is a global option: one parked before an -i is
        # hoisted to the output group, then rewritten like any other
        for opts, path in inputs:
            for item in [p for p in opts
                         if p[0] == "-filter_complex"
                         and "transform360" in (p[1] or "")]:
                opts.remove(item)
                out_opts.insert(0, item)
        cs = split_complex_graph(out_opts)
        if cs is None:
            out_opts, needs_src_input = rewrite_filter_complex(out_opts)
            found = find_transform360(out_opts)
        else:
            found = ("complex", None, cs.t360_opts, None)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if found is None:
        # no transform360 in the graph: behave exactly like ffmpeg
        try:
            return subprocess.call(["ffmpeg", *argv])
        except FileNotFoundError:
            print("error: no ffmpeg binary on PATH", file=sys.stderr)
            return 2

    if len(inputs) != 1 and cs is None:
        print(
            f"error: the transform360 wrapper supports exactly one input "
            f"(got {len(inputs)}) outside -filter_complex", file=sys.stderr,
        )
        return 2

    piped = [p for p in _probed_inputs(inputs, cs) if _is_stream_input(p)]
    if piped:
        # the probe would read the head of the stream, which the decode
        # process then misses (the reference wrapper's fault)
        print(
            f"error: input {piped[0]!r} is a stream that can be read only once, but "
            "the wrapper probes its size and pixel format before the decode process "
            "reads it, so the decode would miss the frames the probe consumed; write "
            "the stream to a file first", file=sys.stderr,
        )
        return 2

    from .api import open_filter
    from .config import get_pixel_format
    from .utils.profiling import StageStats
    from .utils.video import have_ffmpeg
    from .utils.yuv import read_planar_frames

    if not have_ffmpeg():
        print("error: no ffmpeg binary on PATH", file=sys.stderr)
        return 2

    in_opts, in_path = inputs[0]
    try:
        if cs is None:
            in_w, in_h, fps, src_fmt = probe_decoded(
                in_opts, in_path, found[1]
            )
        else:
            in_w, in_h, fps, src_fmt = probe_decoded_complex(inputs, cs)
    except (UsageError, subprocess.CalledProcessError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    fmt = pipe_format(src_fmt)

    t = open_filter(found[2], in_w, in_h, pix_fmt=fmt, device=device)
    out_w, out_h = t.output_dims()
    if cs is None:
        dec_cmd, enc_cmd = build_commands(
            inputs, out_opts, out_path, globals_, found,
            (in_w, in_h, fps), (out_w, out_h), pix_fmt=fmt,
            needs_src_input=needs_src_input,
        )
    else:
        dec_cmd, enc_cmd = build_commands_complex(
            inputs, cs, out_path, globals_,
            (in_w, in_h, fps), (out_w, out_h), pix_fmt=fmt,
        )

    from .cli import batched_outputs, start_reader, tail_frames

    stats = StageStats(stream=sys.stderr)
    t0 = time.perf_counter()
    # non-transform outputs of a multi-output command run concurrently
    # as their own passthrough ffmpeg processes against the source
    extra_procs = [
        subprocess.Popen(build_command_extra(inputs, o, p, globals_))
        for o, p in extra_outputs
    ]
    dec = subprocess.Popen(dec_cmd, stdout=subprocess.PIPE)
    enc = subprocess.Popen(enc_cmd, stdin=subprocess.PIPE)
    pf = get_pixel_format(fmt)
    inq, stop = start_reader(
        read_planar_frames(dec.stdout, in_w, in_h, 0, pf), batch
    )
    try:
        for planes in batched_outputs(
            t.transform_async, inq, pf.n_planes, batch, prefetch, stats,
            lambda n: tail_frames(n, batch, t.device),
        ):
            for p in planes:
                p = np.ascontiguousarray(p)
                if p.dtype == np.uint16:
                    p = p.astype("<u2")  # deep formats pipe 16-bit LE
                else:
                    p = p.astype(np.uint8, copy=False)
                enc.stdin.write(p.tobytes())
    finally:
        stop.set()
        dec.stdout.close()
        enc.stdin.close()
        rc_dec, rc_enc = dec.wait(), enc.wait()
        rc_extra = [p.wait() for p in extra_procs]
    dt = time.perf_counter() - t0

    if rc_dec or rc_enc or any(rc_extra):
        print(
            f"error: ffmpeg subprocess failed (decode rc={rc_dec}, "
            f"encode rc={rc_enc}"
            + (f", extra outputs rc={rc_extra}" if rc_extra else "")
            + ")",
            file=sys.stderr,
        )
        return rc_dec or rc_enc or max(rc_extra)
    if want_stats:
        stats.emit(
            in_size=f"{in_w}x{in_h}", out_size=f"{out_w}x{out_h}",
            wall_seconds=round(dt, 3),
        )
    else:
        print(
            f"{stats.frames} frames {in_w}x{in_h} -> {out_w}x{out_h} "
            f"in {dt:.2f}s", file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
