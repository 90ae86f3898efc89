"""The plane executors on the CPU (``pipeline.plane_executor``).

On the CPU an executor runs the plain program, with the cache behaviour
it has on the card: one executor per plane plan (by key and content)
and device, shared by every engine that opens an equal plan, and one
``_by_shape`` entry per input shape.  Where the card replays graphs, the
CLI pads a short tail batch to the steady shape, so a run leaves one
shape per executor (the port's version of ``tests/test_cli_io.py``'s
tail-batch test); elsewhere the tail runs unpadded.
``transform_planes`` equals the JAX package's on the same plan
(``plan_from_jax``) byte for byte at this size and seed (elsewhere a
fused multiply-add in XLA's jitted program may flip a rounding tie,
ROADMAP C).  The graph path itself (replay against eager, launch counts,
nested and failing captures) is held on the card in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from transform360_tpu import pipeline as jax_pipeline
from transform360_tpu.config import Interpolation as JInterpolation
from transform360_tpu.config import StereoFormat as JStereo
from transform360_tpu.config import TransformConfig as JConfig
from transform360_tpu.plan import build_plan as jax_build_plan
import transform360_tpu_torch as P
from transform360_tpu_torch import cli, pipeline
from transform360_tpu_torch.cli import main as cli_main
from transform360_tpu_torch.ops import blur, nodes, window
from transform360_tpu_torch.ops.sources import Source
from transform360_tpu_torch.plan import clear_plan_cache, plan_from_jax
from transform360_tpu_torch.utils.profiling import COUNTERS
from transform360_tpu_torch.utils.yuv import read_yuv420_batch, write_yuv420_batch

IN_W, IN_H, OUT_W, OUT_H = 256, 128, 96, 64


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, the same plan in the port): 256x128 -> 96x64 cubemap,
    cubic, prefilter on (the flagship's options at a small size)."""
    cfg = JConfig(interpolation_alg=JInterpolation.CUBIC, enable_low_pass_filter=True,
                  input_stereo_format=JStereo.MONO, output_stereo_format=JStereo.MONO)
    jp = jax_build_plan(cfg, IN_W, IN_H, OUT_W, OUT_H)
    return jp, plan_from_jax(jp)


def _planes(b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, IN_H, IN_W), dtype=np.uint8),
            rng.integers(0, 256, (b, IN_H // 2, IN_W // 2), dtype=np.uint8),
            rng.integers(0, 256, (b, IN_H // 2, IN_W // 2), dtype=np.uint8))


def _entries(plan):
    """The cached executors that hold ``plan``'s own plane plans."""
    return {k: ex for k, ex in pipeline._EXEC_CACHE.items()
            if ex.pp is plan.luma or ex.pp is plan.chroma}


def test_transform_planes_equals_the_jax_package(plans):
    jp, tp = plans
    y, u, v = _planes(3)
    want = jax_pipeline.transform_planes(jp, y, u, v)
    got = pipeline.transform_planes(tp, y, u, v, device="cpu")
    for g, w, name in zip(got, want, "YUV"):
        assert g.dtype == torch.uint8 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_one_executor_per_plane_plan_and_device(plans):
    _, tp = plans
    pipeline.clear_executor_cache()
    assert not pipeline._EXEC_CACHE
    y, u, v = _planes(2)
    for _ in range(3):
        pipeline.transform_batch(tp, y, u, v, device="cpu")
    pipeline.transform_batch(tp, torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(v))
    ents = _entries(tp)
    assert sorted(ents) == sorted([(tp.luma.key, "cpu"), (tp.chroma.key, "cpu")])
    assert len(pipeline._EXEC_CACHE) == 2
    assert pipeline.plane_executor(tp.luma, "cpu") is ents[(tp.luma.key, "cpu")]
    pipeline.clear_executor_cache()
    assert not pipeline._EXEC_CACHE


def test_one_shape_per_batch_size(plans):
    _, tp = plans
    pipeline.clear_executor_cache()
    for b in (1, 2, 2, 5, 1):
        pipeline.transform_batch(tp, *_planes(b), device="cpu")
    luma = pipeline.plane_executor(tp.luma, "cpu")
    chroma = pipeline.plane_executor(tp.chroma, "cpu")
    assert sorted(k[0][0] for k in luma._by_shape) == [1, 2, 5]
    assert sorted(k[0][0] for k in chroma._by_shape) == [2, 4, 10]  # U and V stacked
    assert all(g is None for g in luma._by_shape.values())  # the CPU runs eagerly
    pipeline.transform_frame(tp, *(p[0] for p in _planes(1)), device="cpu")  # [H, W] planes
    assert len(luma._by_shape) == 3


def test_outputs_of_two_calls_never_alias(plans):
    _, tp = plans
    a = pipeline.transform_batch(tp, *_planes(2, seed=1), device="cpu")
    keep = [o.clone() for o in a]
    b = pipeline.transform_batch(tp, *_planes(2, seed=2), device="cpu")
    for x, y, k in zip(a, b, keep):
        assert x.data_ptr() != y.data_ptr()
        assert torch.equal(x, k)
    assert not all(torch.equal(x, y) for x, y in zip(a, b))


def test_drop_executors_on_a_new_plan(plans):
    """``use_plan`` drops the executors of the plan it replaces."""
    jp, tp = plans
    pipeline.clear_executor_cache()
    eng = P.Transform360(P.parse_options("cube_edge_length=32").config, device="cpu")
    eng.use_plan(tp)
    eng.transform(*_planes(1))
    assert len(_entries(tp)) == 2
    other = plan_from_jax(jp)
    eng.use_plan(other)
    assert not _entries(tp)
    eng.transform(*_planes(1))
    assert len(_entries(other)) == 2


def test_engines_with_one_config_share_executors(plans):
    """Engines opened and dropped one after another on equal plans (each
    built anew) leave one executor per plane, and free every plan but the
    one those executors hold."""
    vf = "cube_edge_length=32:input_stereo_format=mono"
    pipeline.clear_executor_cache()
    planes = _planes(2, seed=4)
    refs, outs = [], []
    for _ in range(5):
        clear_plan_cache()
        eng = P.open_filter(vf, IN_W, IN_H, device="cpu")
        outs.append(eng.transform(*planes))
        refs.append(weakref.ref(eng.plan.luma))
        del eng
    assert len(pipeline._EXEC_CACHE) == 2
    clear_plan_cache()
    gc.collect()
    assert [r() is not None for r in refs] == [True, False, False, False, False]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_a_plan_of_other_content_under_one_key_replaces_it(plans):
    _, tp = plans
    spec = dataclasses.replace(tp.luma.spec, frac_x=np.zeros_like(tp.luma.spec.frac_x))
    luma = dataclasses.replace(tp.luma, spec=spec)  # a device cache of its own
    assert luma._cache is not tp.luma._cache
    assert luma.key == tp.luma.key and luma.digest() != tp.luma.digest()
    x = torch.from_numpy(_planes(1, seed=5)[0])
    pipeline.clear_executor_cache()
    first = pipeline.plane_executor(tp.luma, "cpu")(x)
    got = pipeline.plane_executor(luma, "cpu")(x)
    assert torch.equal(got, pipeline._plane_program(luma, x))
    assert not torch.equal(got, first)
    assert list(pipeline._EXEC_CACHE) == [(tp.luma.key, "cpu")]
    assert pipeline._EXEC_CACHE[(tp.luma.key, "cpu")].pp is luma


G = pipeline.GRAPH_MAX_BATCH


@pytest.mark.parametrize("n, batch, device, backend, shards, want", [
    (1, 2, "cuda", "auto", 1, 2),  # the steady batch replays a graph: padded
    (1, 2, "cuda:1", "auto", 1, 2),
    (3, 4, "cuda", "auto", 2, 4),  # 2 frames a shard replay graphs
    (3, G, "cuda", "auto", 1, G),  # the largest batch that replays one
    (3, 2 * G, "cuda", "auto", 1, 3),  # eager above GRAPH_MAX_BATCH: as it is
    (3, 4 * G, "cuda", "auto", 2, 4),  # eager: a multiple of the mesh's size
    (1, 2, "cpu", "auto", 1, 1),
    (1, 2, "cuda", "native", 1, 1),  # the host's engine has no graphs
])
def test_tail_frames(n, batch, device, backend, shards, want):
    assert cli.tail_frames(n, batch, device, backend, shards) == want


def _run_cli(tmp_path, batch, n):
    vf = ("cube_edge_length=32:input_stereo_format=mono:interpolation_alg=linear:"
          "enable_low_pass_filter=0")
    y, u, v = _planes(n, seed=3)
    src, out = tmp_path / "in.yuv", tmp_path / "out.yuv"
    write_yuv420_batch(str(src), y, u, v)
    pipeline.clear_executor_cache()
    rc = cli_main(["--vf", vf, "--input-size", f"{IN_W}x{IN_H}", "-i", str(src), "-o", str(out),
                   "--batch", str(batch), "--device", "cpu", "--stats"])
    assert rc == 0
    assert len(pipeline._EXEC_CACHE) == 2  # luma and chroma
    shapes = {ex.pp.key[-2:]: sorted(k[0][0] for k in ex._by_shape)
              for ex in pipeline._EXEC_CACHE.values()}
    got = read_yuv420_batch(str(out), OUT_W, OUT_H)
    want = P.open_filter(vf, IN_W, IN_H, device="cpu").transform(y, u, v)
    assert got[0].shape[0] == n  # padded frames never reach the output
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    return shapes


def test_cli_tail_batch_leaves_one_shape_per_executor(tmp_path, capsys, monkeypatch):
    # as on the card, where the steady batch of 2 replays a graph
    real = cli.tail_frames
    monkeypatch.setattr(cli, "tail_frames",
                        lambda n, batch, device, backend, shards: real(n, batch, "cuda", backend,
                                                                       shards))
    # the 1-frame tail was padded to 2 frames: no second shape
    assert _run_cli(tmp_path, 2, 5) == {"p0": [2], "p1": [4]}


def test_cli_eager_tail_runs_unpadded(tmp_path, capsys):
    assert _run_cli(tmp_path, 4, 5) == {"p0": [1, 4], "p1": [2, 8]}


# -- the graph key and the re-pointing of a captured program's nodes --

H, W = IN_H, IN_W


def _src(ptr=1 << 20, frames=2, stride=None, aligned=True):
    return Source(ptr, frames, H * W if stride is None else stride, aligned)


@pytest.mark.parametrize("frames", [(1,), (2,), (2, 2)])
def test_graph_key_of_packed_aligned_card_planes_is_the_shape_key(frames):
    # where every plane is packed and 16-byte aligned on the card, the key
    # is the one an eager call records: (stacked shape, dtype, device,
    # each plane's frames); a plane's pointer is not in it
    dev = torch.device("cuda", 0)
    want = ((sum(frames), H, W), torch.uint8, "cuda:0", frames)
    for ptr in (1 << 20, 1 << 30):
        described = tuple(_src(ptr + i * (1 << 24), b) for i, b in enumerate(frames))
        assert pipeline.graph_key(torch.uint8, dev, H, W, frames, described) == want


def test_graph_key_holds_alignment_frame_stride_and_host_planes():
    dev = torch.device("cuda", 0)
    key = lambda *d: pipeline.graph_key(torch.uint8, dev, H, W, (2, 2), d)  # noqa: E731
    packed = key(_src(), _src(1 << 24))
    # each differs from the packed, aligned pair in one respect of one plane
    others = [
        key(_src(), _src(1 << 24, aligned=False)),  # a base off 16 bytes
        key(_src(), _src(1 << 24, stride=3 * H * W // 2)),  # a frame stride of a packed yuv420p frame
        key(_src(), _src(1 << 24, stride=3 * H * W // 2 + 8, aligned=False)),  # that stride off 16
        key(_src(), None),  # a plane from the host
        key(None, _src(1 << 24)),
        key(None, None),
    ]
    assert len({packed, *others}) == 1 + len(others)
    assert all(k[:4] == packed for k in others)
    assert others[3][4:] == ((1, "host"),)
    assert others[1][4:] == ((1, 3 * H * W // 2, True),)
    # one frame has no frame stride: only its alignment counts
    one = lambda s: pipeline.graph_key(torch.uint8, dev, H, W, (1,), (s,))  # noqa: E731
    assert one(_src(frames=1, stride=5 * H * W)) == one(_src(frames=1))
    assert one(_src(frames=1, aligned=False)) != one(_src(frames=1))


class _Library:
    """A K1 and K3 library's stand-in: each launch returns the next node
    handle; each update logs (node, source 0's base, output) as the seam
    pointed its call, or, for the nodes in ``refuse``, fails."""

    def __init__(self):
        self.handles, self.log, self.refuse = 0, [], set()

    def _launch(self, call, stream, node):
        self.handles += 1
        node._obj.value = self.handles
        return 0

    def _update(self, exec_, node, call):
        if node in self.refuse:
            return 1
        self.log.append((node, call._obj.src0, call._obj.dst))
        return 0

    t360_blur = t360_window = _launch
    t360_blur_update = t360_window_update = _update

    def t360_error_string(self, err):
        return b"refused"


def _program(src, out):
    """A program of four nodes recorded through the seam -- K1 reading
    ``src``, a node between that touches neither, two K3 launches writing
    ``out`` -- and the library whose updates log them."""
    lib, mid = _Library(), 7 << 20
    with nodes.recording() as recorded:
        blur.KERNEL.launch(lib, blur.BlurCall(), src, mid, 0)
        window.KERNEL.launch(lib, window.WindowCall(), (_src(mid),), mid + 1, 0)
        for _ in range(2):
            window.KERNEL.launch(lib, window.WindowCall(), (_src(mid + 1),), out, 0)
    return nodes.Program(recorded, src, out), lib


def test_program_repoints_only_the_nodes_on_the_callers_memory():
    src, out = (_src(),), 9 << 20
    prog, lib = _program(src, out)
    assert [(n.handle, r, w) for n, r, w in prog.nodes] == [(1, True, False), (3, False, True),
                                                           (4, False, True)]
    u0 = COUNTERS["nodes.updates"]
    prog.repoint(0, src, out)  # where the capture left them: nothing to update
    assert lib.log == [] and COUNTERS["nodes.updates"] == u0
    prog.repoint(0, (_src(ptr=3 << 20),), out)
    assert lib.log == [(1, 3 << 20, 7 << 20)]
    lib.log.clear()
    prog.repoint(0, (_src(ptr=3 << 20),), 10 << 20)  # the output alone: the writers
    mid = (7 << 20) + 1  # node 2's output, which nodes 3 and 4 read
    assert lib.log == [(3, mid, 10 << 20), (4, mid, 10 << 20)]
    prog.repoint(0, src, 9 << 20)  # other planes and another output: every node
    assert COUNTERS["nodes.updates"] - u0 == 1 + 2 + 3


def test_program_after_a_failed_update_repoints_every_node():
    src, out = (_src(),), 9 << 20
    lib = _Library()
    with nodes.recording() as recorded:
        blur.KERNEL.launch(lib, blur.BlurCall(), src, 7 << 20, 0)
        lib.handles = 2
        window.KERNEL.launch(lib, window.WindowCall(), (_src(7 << 20),), out, 0)
    prog = nodes.Program(recorded, src, out)
    lib.refuse.add(3)
    with pytest.raises(RuntimeError, match="window kernel node update failed: refused"):
        prog.repoint(0, (_src(3 << 20),), 10 << 20)
    assert [h for h, _, _ in lib.log] == [1]
    lib.refuse.clear()
    prog.repoint(0, src, out)  # the capture's pointers again, but not known to hold
    assert [h for h, _, _ in lib.log] == [1, 1, 3]


def test_a_program_without_a_node_on_the_callers_memory_is_refused():
    src, out = (_src(),), 9 << 20
    with nodes.recording() as other:
        blur.KERNEL.launch(_Library(), blur.BlurCall(), (_src(5 << 20),), 6 << 20, 0)
    with pytest.raises(RuntimeError, match="no node that reads"):
        nodes.Program(other, src, out)
