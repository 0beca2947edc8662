"""The compiled-program API and the batched path of the port against the JAX
package's, on the CPU.

The same graphs and the same seeded numpy batches go through the JAX
package's `compile_graph` / `parallel.BatchedGraph` /
`parallel.BatchedLiveSession` (vmap of the fused program, the jnp path) and
the port's (one evaluation over `[B, H, W]` planes, each kernel's plain
version for the batch). Every f32 plane must be bit-identical (int32 view)
and every u8 export identical; each batched canvas must equal the port's
single-canvas render. The port's batch meshes here are CPU devices
(`make_mesh(devices=["cpu"] * n, axes=("batch",))`).
"""

import os

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu import compiler as ref_compiler
from kanter_core_tpu import models as ref_models
from kanter_core_tpu import parallel as ref_parallel
from kanter_core_tpu_torch import compiler as port_compiler
from kanter_core_tpu_torch import graphs as port_graphs
from kanter_core_tpu_torch import models as port_models
from kanter_core_tpu_torch import parallel as port_parallel
from kanter_core_tpu_torch.convert import planes_from_numpy
from kanter_core_tpu_torch.ops import blur as port_blur
from kanter_core_tpu_torch.ops import distance as port_distance
from kanter_core_tpu_torch.ops import warp as port_warp
from kanter_core_tpu_torch.parallel import MESH_COUNTERS
from __graft_entry__ import _flagship

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _batch(b, h, w, seed, n=1):
    rng = np.random.default_rng(seed)
    return [rng.random((b, h, w), dtype=np.float32) for _ in range(n)]


def _host(plane):
    if isinstance(plane, port_parallel.BatchShards):
        plane = plane.gather("cpu")
    return plane


def _check_against_ref(got: dict, want: dict, u8: bool = False) -> None:
    """Every target of the port's result equals the JAX package's."""
    assert set(got) == set(want)
    for key, value in got.items():
        if u8:
            assert _same(_host(value), np.asarray(want[key])), key
        else:
            assert len(value) == len(want[key]), key
            for p, q in zip(value, want[key]):
                assert _same(_host(p), np.asarray(q)), key


def _mix_graph(pkg, mix_type_name: str, value: float):
    """InputGray (left) · Value (right) → OutputGray."""
    graph = pkg.NodeGraph()
    gin = graph.add_node(pkg.Node(pkg.NodeType.InputGray("in")))
    gain = graph.add_node(pkg.Node(pkg.NodeType.Value(value)))
    mix = graph.add_node(pkg.Node(pkg.NodeType.Mix(getattr(pkg.MixType, mix_type_name))))
    out = graph.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    graph.connect(gin, mix, pkg.SlotId(0), pkg.SlotId(0))
    graph.connect(gain, mix, pkg.SlotId(0), pkg.SlotId(1))
    graph.connect(mix, out, pkg.SlotId(0), pkg.SlotId(0))
    return graph, gin, gain, mix, out


def _one_minus_graph(pkg):
    """Value 1.0 (left) − InputGray (right) → OutputGray
    (`tests/test_compiler.py`'s batched graph)."""
    graph = pkg.NodeGraph()
    gin = graph.add_node(pkg.Node(pkg.NodeType.InputGray("in")))
    val = graph.add_node(pkg.Node(pkg.NodeType.Value(1.0)))
    sub = graph.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.SUBTRACT)))
    out = graph.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    graph.connect(val, sub, pkg.SlotId(0), pkg.SlotId(0))
    graph.connect(gin, sub, pkg.SlotId(0), pkg.SlotId(1))
    graph.connect(sub, out, pkg.SlotId(0), pkg.SlotId(0))
    return graph, gin, out


def _batch_mesh(n):
    return port_parallel.make_mesh(devices=["cpu"] * n, axes=("batch",))


# --- tests/test_compiler.py's batched tests on the port -------------------


def test_batched_graph_vmap():
    """`test_compiler.py::test_batched_graph_vmap`: B canvases in one
    evaluation, equal to the JAX package's vmapped program."""
    (batch,) = _batch(4, 32, 32, 0)
    results = []
    for pkg, bg_cls, kw in ((ref, ref_parallel.BatchedGraph, {}),
                            (port, port_parallel.BatchedGraph, {"device": "cpu"})):
        graph, gin, out = _one_minus_graph(pkg)
        key = f"input_{int(gin)}"
        bg = bg_cls(graph, batch_keys={key}, targets=[(out, pkg.SlotId(0))], **kw)
        results.append(bg(**{key: (batch,)}))
    want, got = results
    _check_against_ref(got, want)
    (plane,) = next(iter(got.values()))
    assert plane.shape == (4, 32, 32)
    assert _same(plane, np.float32(1.0) - batch)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_batch_eval(n):
    """`test_compiler.py::test_sharded_batch_eval` over a batch mesh of `n`
    CPU shards: each output a `BatchShards` over the mesh, bit-identical to
    the JAX package's sharded result; one `batch` gather per gathered
    plane and no other."""
    (batch,) = _batch(8, 32, 32, 0)
    graph, gin, out = _one_minus_graph(ref)
    key = f"input_{int(gin)}"
    rbg = ref_parallel.BatchedGraph(graph, batch_keys={key}, targets=[(out, ref.SlotId(0))],
                                    mesh=ref_parallel.make_mesh(8))
    want = rbg(**{key: (rbg.shard_batch_arg(batch),)})

    graph, gin, out = _one_minus_graph(port)
    mesh = _batch_mesh(n)
    bg = port_parallel.BatchedGraph(graph, batch_keys={key}, targets=[(out, port.SlotId(0))],
                                    mesh=mesh)
    MESH_COUNTERS.reset()
    got = bg(**{key: (bg.shard_batch_arg(batch),)})
    (plane,) = got[(out, port.SlotId(0))]
    assert isinstance(plane, port_parallel.BatchShards) and plane.mesh == mesh
    assert [s.shape[0] for s in plane.shares] == [8 // n] * n
    assert MESH_COUNTERS.snapshot()["gathers"]["batch"] == 0
    _check_against_ref(got, want)
    snap = MESH_COUNTERS.snapshot()
    assert snap["gathers"] == {**dict.fromkeys(MESH_COUNTERS.CAUSES, 0), "batch": 1}
    assert snap["exchanges"] == 0


def _vmap_cases():
    from kanter_core_tpu import Size as RefSize
    from kanter_core_tpu.node import ResizeFilter as RefFilter
    from kanter_core_tpu.ops.blur import blur_plane as ref_blur
    from kanter_core_tpu.ops.height_to_normal import h2n_traceable
    from kanter_core_tpu.ops.resize import resample_plane as ref_resample
    from kanter_core_tpu_torch.ops.height_to_normal import h2n_planes
    from kanter_core_tpu_torch.ops.resize import resample_plane

    return {
        # every plane of the normal map: XLA refuses a program that keeps
        # only some of them differently (1,775 of 6,144 nx bits differ at
        # 64×96 when nx alone is jitted)
        "h2n": (h2n_traceable, h2n_planes),
        "blur": (lambda x: (ref_blur(x, 1.5),), lambda x: (port_blur.blur_plane(x, 1.5),)),
        "resample": (
            lambda x: (ref_resample(x, RefSize(48, 32), RefFilter.LANCZOS3),),
            lambda x: (resample_plane(x, port.Size(48, 32), port.ResizeFilter.LANCZOS3),),
        ),
    }


@pytest.mark.parametrize("case", ["h2n", "blur", "resample", "pow"])
def test_vmap_bit_transparent(case):
    """`test_compiler.py::test_vmap_bit_transparent` on the port: an op on
    a `[B, H, W]` batch gives the bits of the op on each canvas, and the
    JAX package's vmap of the function its fused program traces."""
    import jax

    from kanter_core_tpu.ops.mix import _gray_kernel
    from kanter_core_tpu_torch.ops.mix import _binary

    batch, b2 = _batch(4, 64, 96, 0, n=2)
    if case == "pow":
        ref_fn, port_fn = _gray_kernel(ref.MixType.POW), _binary(port.MixType.POW)
        want = [np.asarray(jax.jit(jax.vmap(ref_fn))(batch, b2))]
        got = [port_fn(torch.from_numpy(batch), torch.from_numpy(b2))]
        single = [torch.stack([port_fn(torch.from_numpy(p), torch.from_numpy(q))
                               for p, q in zip(batch, b2)])]
    else:
        ref_fn, port_fn = _vmap_cases()[case]
        want = [np.asarray(w) for w in jax.jit(jax.vmap(ref_fn))(batch)]
        got = port_fn(torch.from_numpy(batch))
        single = [torch.stack(planes) for planes in
                  zip(*(port_fn(torch.from_numpy(p)) for p in batch))]
    assert len(got) == len(single) == len(want)
    for g, s, w in zip(got, single, want):
        assert _same(g, s)
        assert _same(g, w)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_unsharded_golden(n):
    """`test_compiler.py::test_sharded_matches_unsharded_golden` on the
    port: the invert graph, nested, over a batch of 8 on one device and
    over a batch mesh, bit-identical to each other and to the JAX
    package."""
    (batch,) = _batch(8, 48, 48, 3)
    results = []
    for pkg in (ref, port):
        inner = (ref.graphs if pkg is ref else port_graphs).invert_graph()
        outer = pkg.NodeGraph()
        gin = outer.add_node(pkg.Node(pkg.NodeType.InputGray("in")))
        gnode = outer.add_node(pkg.Node(pkg.NodeType.Graph(inner)))
        gout = outer.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
        outer.connect(gin, gnode, pkg.SlotId(0), inner.input_slot_id_with_name("in"))
        outer.connect(gnode, gout, inner.output_slot_id_with_name("out"), pkg.SlotId(0))
        key, target = f"input_{int(gin)}", [(gout, pkg.SlotId(0))]
        if pkg is ref:
            results.append(ref_parallel.BatchedGraph(outer, {key}, target)(**{key: (batch,)}))
            continue
        plain = port_parallel.BatchedGraph(outer, {key}, target, device="cpu")
        sharded = port_parallel.BatchedGraph(outer, {key}, target, mesh=_batch_mesh(n))
        results.append(plain(**{key: (batch,)}))
        results.append(sharded(**{key: (sharded.shard_batch_arg(batch),)}))
    want, plain, sharded = results
    _check_against_ref(plain, want)
    _check_against_ref(sharded, want)


def _session_sequence(pkg, session_cls, **kw):
    graph, gin, gain, mix, out = _mix_graph(pkg, "MULTIPLY", 1.0)
    session = session_cls(graph, [gin], targets=[(out, pkg.SlotId(0))], **kw)
    (batch,) = _batch(8, 16, 16, 0)
    session.set_input(gin, batch)
    reads = [session.render()[(out, pkg.SlotId(0))][0]]
    session.set_value(gain, 0.5)
    reads.append(session.render()[(out, pkg.SlotId(0))][0])
    programs = [len(session._programs)]
    session.edit(lambda g: g.set_mix_type(mix, pkg.MixType.SUBTRACT))
    session.set_value(gain, 1.0)
    reads.append(session.render()[(out, pkg.SlotId(0))][0])
    programs.append(len(session._programs))
    return batch, [np.asarray(_host(r)) for r in reads], programs


@pytest.mark.parametrize("mesh", [None, 2, 4])
def test_batched_live_session(mesh):
    """`test_compiler.py::test_batched_live_session` on the port, on one
    device and over batch meshes: value edits re-run the cached program,
    the structural edit builds one more, and every read equals the JAX
    package's session."""
    _, want, want_programs = _session_sequence(ref, ref_parallel.BatchedLiveSession)
    kw = {"device": "cpu"} if mesh is None else {"mesh": _batch_mesh(mesh)}
    batch, got, programs = _session_sequence(port, port_parallel.BatchedLiveSession, **kw)
    assert programs == want_programs == [1, 2]
    for g, w in zip(got, want):
        assert _same(g, w)
    assert _same(got[1], batch * np.float32(0.5))
    assert _same(got[2], batch - np.float32(1.0))


def test_batched_live_session_indivisible_batch_on_a_mesh():
    """A batch that does not divide over the mesh stays whole on its first
    device (the JAX package replicates it); the result is that of one
    device."""
    graph, gin, gain, _, out = _mix_graph(port, "MULTIPLY", 0.25)
    session = port_parallel.BatchedLiveSession(graph, [gin], targets=[(out, port.SlotId(0))],
                                               mesh=_batch_mesh(2))
    (batch,) = _batch(3, 16, 16, 2)
    session.set_input(gin, batch)
    (plane,) = session.render()[(out, port.SlotId(0))]
    assert isinstance(plane, torch.Tensor)
    assert _same(plane, batch * np.float32(0.25))


def test_batched_graph_progressive_input_binding():
    """`test_compiler.py::test_batched_graph_progressive_input_binding`: a
    call missing a bound input raises and a later full call works."""
    graph = port.NodeGraph()
    in1 = graph.add_node(port.Node(port.NodeType.InputGray("a")))
    in2 = graph.add_node(port.Node(port.NodeType.InputGray("b")))
    mix = graph.add_node(port.Node(port.NodeType.Mix(port.MixType.ADD)))
    out = graph.add_node(port.Node(port.NodeType.OutputGray("out")))
    graph.connect(in1, mix, port.SlotId(0), port.SlotId(0))
    graph.connect(in2, mix, port.SlotId(0), port.SlotId(1))
    graph.connect(mix, out, port.SlotId(0), port.SlotId(0))
    k1, k2 = f"input_{int(in1)}", f"input_{int(in2)}"
    bg = port_parallel.BatchedGraph(graph, batch_keys={k1, k2}, targets=[(out, port.SlotId(0))],
                                    device="cpu")
    (batch,) = _batch(4, 16, 16, 1)
    with pytest.raises(port.TexProError):
        bg(**{k1: (batch,)})
    (plane,) = bg(**{k1: (batch,), k2: (batch,)})[(out, port.SlotId(0))]
    assert _same(plane, batch + batch)


def test_batched_live_session_rows_only_mesh_is_not_yet_ported():
    """`test_compiler.py::test_batched_live_session_rows_only_mesh`: a
    session or a BatchedGraph over a `"rows"` mesh (the JAX package's vmap
    of the row-sharded kernels) is refused as not yet ported."""
    graph, gin, _, _, out = _mix_graph(port, "MULTIPLY", 0.25)
    rows = port_parallel.make_mesh(devices=["cpu"] * 2)
    with pytest.raises(port.TexProError, match="not yet ported"):
        port_parallel.BatchedLiveSession(graph, [gin], targets=[(out, port.SlotId(0))],
                                         mesh=rows)
    with pytest.raises(port.TexProError, match="not yet ported"):
        port_parallel.BatchedGraph(graph, {f"input_{int(gin)}"}, mesh=rows)
    with pytest.raises(port.TexProError, match="not yet ported"):
        port_parallel.make_mesh(devices=["cpu"] * 4, axes=("batch", "rows"))
    with pytest.raises(port.TexProError):
        port.TextureProcessor(device="cpu", mesh=_batch_mesh(2))


def test_batched_live_session_tracks_image_file(tmp_path):
    """`test_compiler.py::test_batched_live_session_tracks_image_file`: a
    file rewritten in place is read again on the next render, with no edit
    in between, as the JAX package's session does."""
    from PIL import Image as PILImage

    path = str(tmp_path / "tex.png")
    reads = {}
    for pkg, cls, kw in ((ref, ref_parallel.BatchedLiveSession, {}),
                         (port, port_parallel.BatchedLiveSession, {"device": "cpu"})):
        PILImage.fromarray(np.full((8, 8, 4), 64, np.uint8)).save(path)
        os.utime(path, ns=(3, 3))
        graph = pkg.NodeGraph()
        gin = graph.add_node(pkg.Node(pkg.NodeType.InputGray("in")))
        img = graph.add_node(pkg.Node(pkg.NodeType.Image(path)))
        sep = graph.add_node(pkg.Node(pkg.NodeType.SeparateRgba()))
        mix = graph.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.ADD)))
        out = graph.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
        graph.connect(img, sep, pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(gin, mix, pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(sep, mix, pkg.SlotId(0), pkg.SlotId(1))
        graph.connect(mix, out, pkg.SlotId(0), pkg.SlotId(0))
        session = cls(graph, [gin], targets=[(out, pkg.SlotId(0))], **kw)
        session.set_input(gin, np.zeros((2, 8, 8), np.float32))
        first = np.asarray(session.render()[(out, pkg.SlotId(0))][0])
        PILImage.fromarray(np.full((8, 8, 4), 192, np.uint8)).save(path)
        os.utime(path, ns=(1, 1))
        second = np.asarray(session.render()[(out, pkg.SlotId(0))][0])
        third = np.asarray(session.render()[(out, pkg.SlotId(0))][0])
        reads[pkg.__name__] = (first, second, third)
    for g, w in zip(reads[port.__name__], reads[ref.__name__]):
        assert _same(g, w)
    first, second, _ = reads[port.__name__]
    assert np.allclose(first, 64.0 / 255.0) and np.allclose(second, 192.0 / 255.0)


# --- whole graphs, batched ------------------------------------------------


def _single_canvas(graph, keys, batch_args: dict, i: int, targets, include_u8=False):
    """Canvas `i` through the port's single-canvas `CompiledGraph`."""
    prog = port_compiler.CompiledGraph(graph, targets, include_u8, device="cpu")
    args = {k: (v[0][i],) if isinstance(v, tuple) else np.float32(v[i])
            for k, v in batch_args.items()}
    return prog(**args)


def _run_both(build, batch_args: dict, targets_of=None, include_u8=False, mesh=None,
              batch_keys=None):
    """`(port result, JAX result, port graph, port targets)` of one graph
    over the batch: `build(pkg)` → `(graph, {name: node id})`,
    `batch_args` by argument key (plane batches as 1-tuples, Value vectors
    as arrays), all of them batch keys unless `batch_keys` says which."""
    keys = set(batch_args) if batch_keys is None else set(batch_keys)
    results = []
    for pkg in (ref, port):
        graph, ids = build(pkg)
        targets = None if targets_of is None else targets_of(pkg, ids)
        if pkg is ref:
            bg = ref_parallel.BatchedGraph(graph, keys, targets, include_u8)
        elif mesh is None:
            bg = port_parallel.BatchedGraph(graph, keys, targets, include_u8, device="cpu")
        else:
            bg = port_parallel.BatchedGraph(graph, keys, targets, include_u8,
                                            mesh=_batch_mesh(mesh))
        results.append(bg(**batch_args))
    want, got = results
    return got, want, graph, targets


def _flagship_build(n):
    def build(pkg):
        if pkg is ref:
            graph, inputs, out = _flagship(n)
        else:
            graph, inputs, out = port_graphs.flagship_graph(n)
        return graph, {"inputs": inputs, "out": out}
    return build


@pytest.fixture(scope="module")
def flagship_batch():
    build = _flagship_build(64)
    graph, ids = build(port)
    planes = _batch(3, 64, 64, 0, n=4)
    args = {f"input_{int(n)}": (p,) for n, p in zip(ids["inputs"], planes)}
    got, want, graph, _ = _run_both(build, args)
    return graph, ids, args, got, want


def test_flagship_batched_matches_reference(flagship_batch):
    """`graphs.flagship_graph(64)` over a batch of 3 on its four inputs
    (the Warp's planes batched, its Noise strength and the Distance's
    Pattern mask not): bit-identical to the JAX package's BatchedGraph."""
    graph, ids, args, got, want = flagship_batch
    _check_against_ref(got, want)
    (target,) = got
    assert [tuple(p.shape) for p in got[target]] == [(3, 64, 64)] * 4


@pytest.mark.parametrize("i", [0, 2])
def test_flagship_batched_canvas_equals_single_canvas(flagship_batch, i):
    graph, ids, args, got, _ = flagship_batch
    single = _single_canvas(graph, ids, args, i, None)
    for key, planes in single.items():
        for p, q in zip(planes, got[key]):
            assert _same(q[i], p)


def test_flagship_batched_distance_runs_once_unbatched(flagship_batch, monkeypatch):
    """The Distance's mask comes from the Pattern alone: the evaluator
    propagates one unbatched state, not one per canvas."""
    graph, _, args, _, _ = flagship_batch
    shapes = []
    real = port_distance.jfa_propagate

    def spy(state):
        shapes.append(tuple(state.shape))
        return real(state)

    monkeypatch.setattr(port_distance, "jfa_propagate", spy)
    port_parallel.BatchedGraph(graph, set(args), device="cpu")(**args)
    assert shapes == [(64, 64)]


def _pbr_build(pkg):
    graph = (ref_models if pkg is ref else port_models).pbr_material_graph()
    height = next(n.node_id for n in graph.nodes if n.node_type.kind == pkg.NodeTypeKind.INPUT_GRAY)
    return graph, {"height": height}


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_pbr_batched_matches_reference(u8):
    """`models.pbr_material_graph()` with its height batched (B=4, 64²):
    all four maps bit-identical to the JAX package, f32 and u8, and canvas
    3 equal to the single-canvas render."""
    graph, ids = _pbr_build(port)
    (height,) = _batch(4, 64, 64, 5)
    args = {f"input_{int(ids['height'])}": (height,)}
    got, want, graph, _ = _run_both(_pbr_build, args, include_u8=u8)
    _check_against_ref(got, want, u8=u8)
    assert len(got) == 4
    single = _single_canvas(graph, ids, args, 3, None, include_u8=u8)
    for key, value in single.items():
        if u8:
            assert _same(got[key][3], value)
        else:
            for p, q in zip(value, got[key]):
                assert _same(q[3], p)


def kernel_graph(pkg):
    """InputGray height → Blur 6.0, → Distance 512, and Warp(37°, 5) of the
    Distance's output by the blurred height: the three kernels on batched
    operands."""
    graph = pkg.NodeGraph()
    height = graph.add_node(pkg.Node(pkg.NodeType.InputGray("height")))
    blur = graph.add_node(pkg.Node(pkg.NodeType.Blur(6.0)))
    dist = graph.add_node(pkg.Node(pkg.NodeType.Distance(512.0)))
    warp = graph.add_node(pkg.Node(pkg.NodeType.Warp(37.0, 5.0)))
    out = graph.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    graph.connect(height, blur, pkg.SlotId(0), pkg.SlotId(0))
    graph.connect(height, dist, pkg.SlotId(0), pkg.SlotId(0))
    graph.connect(dist, warp, pkg.SlotId(0), pkg.SlotId(0))
    graph.connect(blur, warp, pkg.SlotId(0), pkg.SlotId(1))
    graph.connect(warp, out, pkg.SlotId(0), pkg.SlotId(0))
    return graph, {"height": height, "warp": warp, "out": out}


@pytest.mark.parametrize("mesh", [None, 2, 4])
def test_kernel_graph_batched_matches_reference(mesh):
    """The kernel graph at B=4, 48×40 (a seed mask at density 1e-2): on one
    device and over batch meshes, bit-identical to the JAX package and,
    canvas by canvas, to the single-canvas render."""
    rng = np.random.default_rng(11)
    height = (rng.random((4, 48, 40)) < 0.01).astype(np.float32) + rng.random(
        (4, 48, 40), dtype=np.float32) * np.float32(0.4)
    graph, ids = kernel_graph(port)
    args = {f"input_{int(ids['height'])}": (height,)}
    got, want, graph, _ = _run_both(kernel_graph, args, mesh=mesh)
    _check_against_ref(got, want)
    for i in range(4):
        for key, planes in _single_canvas(graph, ids, args, i, None).items():
            for p, q in zip(planes, got[key]):
                assert _same(_host(q)[i], p)


def test_batched_value_key():
    """A Value as a batch key (`value_<id>`, one value per canvas): each
    canvas takes its own constant, as in the JAX package."""
    (batch,) = _batch(3, 24, 24, 7)
    values = np.asarray([0.25, 0.5, 0.75], np.float32)

    def build(pkg):
        graph, gin, gain, _, out = _mix_graph(pkg, "MULTIPLY", 1.0)
        return graph, {"in": gin, "gain": gain}

    graph, ids = build(port)
    args = {f"input_{int(ids['in'])}": (batch,), f"value_{int(ids['gain'])}": values}
    got, want, _, _ = _run_both(build, args)
    _check_against_ref(got, want)
    (plane,) = next(iter(got.values()))
    assert _same(plane, batch * values[:, None, None])
    # a Value vector alone (the input shared by every canvas)
    args[f"input_{int(ids['in'])}"] = (batch[0],)
    got, want, _, _ = _run_both(build, args, batch_keys=[f"value_{int(ids['gain'])}"])
    _check_against_ref(got, want)
    (plane,) = next(iter(got.values()))
    assert _same(plane, batch[0] * values[:, None, None])


def test_unbatched_targets_broadcast_to_the_batch():
    """A target that no batched argument reaches (a Pattern, a Value) comes
    out as `[B, ...]`, as `jax.vmap`'s `out_axes=0` gives it, in f32 and in
    u8."""
    def build(pkg):
        graph = pkg.NodeGraph()
        gin = graph.add_node(pkg.Node(pkg.NodeType.InputGray("in")))
        inv = graph.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.SUBTRACT)))
        one = graph.add_node(pkg.Node(pkg.NodeType.Value(1.0)))
        pat = graph.add_node(pkg.Node(pkg.NodeType.Pattern(16, 16, "Checker", cells_x=4,
                                                           cells_y=4, mortar=0.1, bevel=0.0,
                                                           seed=1)))
        outs = [graph.add_node(pkg.Node(pkg.NodeType.OutputGray(f"o{i}"))) for i in range(3)]
        graph.connect(one, inv, pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(gin, inv, pkg.SlotId(0), pkg.SlotId(1))
        graph.connect(inv, outs[0], pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(pat, outs[1], pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(one, outs[2], pkg.SlotId(0), pkg.SlotId(0))
        return graph, {"in": gin, "outs": outs}

    graph, ids = build(port)
    (batch,) = _batch(5, 16, 16, 9)
    args = {f"input_{int(ids['in'])}": (batch,)}
    for u8 in (False, True):
        got, want, _, _ = _run_both(build, args, include_u8=u8)
        _check_against_ref(got, want, u8=u8)
        shapes = {tuple((v if u8 else v[0]).shape) for v in got.values()}
        assert shapes == ({(5, 16, 16, 4), (5, 1, 1, 4)} if u8 else {(5, 16, 16), (5, 1, 1)})


# --- the plain kernels, batched ------------------------------------------


@pytest.mark.parametrize("sigma", [0.8, 6.0, 12.0])
def test_blur_plain_batched_equals_per_canvas(sigma):
    (batch,) = _batch(3, 37, 29, 1)
    x = torch.from_numpy(batch)
    got = port_blur.blur_plane_plain(x, sigma)
    for i in range(3):
        assert _same(got[i], port_blur.blur_plane_plain(x[i], sigma))


@pytest.mark.parametrize("h,w,density", [(40, 48, 1e-2), (33, 17, 0.05), (1, 9, 0.3)])
def test_jfa_plain_batched_equals_per_canvas(h, w, density):
    rng = np.random.default_rng(4)
    mask = torch.from_numpy((rng.random((3, h, w)) < density).astype(np.float32))
    state = port_distance.pack_seeds(mask)
    got = port_distance.jfa_propagate_plain(state)
    for i in range(3):
        assert _same(got[i], port_distance.jfa_propagate_plain(port_distance.pack_seeds(mask[i])))
    fade = port_distance.distance_plane(mask, np.float32(8.0))
    for i in range(3):
        assert _same(fade[i], port_distance.distance_plane(mask[i], np.float32(8.0)))


@pytest.mark.parametrize("batched", ["planes", "strength", "both"])
def test_warp_plain_batched_equals_per_canvas(batched):
    """Batched planes by a shared strength map (the batched flagship's
    Warp), a batched map over shared planes, and both batched."""
    rng = np.random.default_rng(6)
    planes = [torch.from_numpy(rng.random((3, 21, 34), dtype=np.float32)) for _ in range(4)]
    strength = torch.from_numpy(rng.random((3, 21, 34), dtype=np.float32) * 1.4 - 0.2)
    strength[0, 3, 4] = float("nan")
    if batched == "planes":
        strength = strength[1]
    elif batched == "strength":
        planes = [p[2] for p in planes]
    k = port_warp.warp_bindings((37.0, 5.0))["k"]
    got = port_warp.warp_planes_plain(planes, strength, k)
    for i in range(3):
        one = port_warp.warp_planes_plain([p if p.dim() == 2 else p[i] for p in planes],
                                          strength if strength.dim() == 2 else strength[i], k)
        for g, o in zip(got, one):
            assert g.shape == (3, 21, 34) and _same(g[i], o)


# --- the compiled-program API -------------------------------------------


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    """A seeded 24×20 RGBA PNG."""
    from PIL import Image as PILImage

    path = str(tmp_path_factory.mktemp("img") / "tex.png")
    pixels = np.random.default_rng(12).integers(0, 256, (24, 20, 4), dtype=np.uint8)
    PILImage.fromarray(pixels).save(path)
    return path


def _invert_main_graph(pkg, path):
    """`test_compiler.py`'s nested invert graph: Image → SeparateRgba →
    Graph(invert) → OutputGray."""
    inner = (ref.graphs if pkg is ref else port_graphs).invert_graph()
    main = pkg.NodeGraph()
    img = main.add_node(pkg.Node(pkg.NodeType.Image(path)))
    sep = main.add_node(pkg.Node(pkg.NodeType.SeparateRgba()))
    gn = main.add_node(pkg.Node(pkg.NodeType.Graph(inner)))
    out = main.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    main.connect(img, sep, pkg.SlotId(0), pkg.SlotId(0))
    main.connect(sep, gn, pkg.SlotId(0), inner.input_slot_id_with_name("in"))
    main.connect(gn, out, inner.output_slot_id_with_name("out"), pkg.SlotId(0))
    return main, inner, gn, out


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_compile_graph_matches_reference(image_path, u8):
    """`test_compiler.py::test_fused_matches_golden` on the port: the
    nested invert graph of an Image through `compile_graph` equals the JAX
    package's, f32 and u8."""
    main, _, _, out = _invert_main_graph(port, image_path)
    got = port.compile_graph(main, include_u8=u8, device="cpu")()
    ref_main, _, _, ref_out = _invert_main_graph(ref, image_path)
    want = ref_compiler.compile_graph(ref_main, include_u8=u8)()
    _check_against_ref(got, want, u8=u8)
    assert tuple(got[(out, port.SlotId(0))].shape if u8 else
                 got[(out, port.SlotId(0))][0].shape) == ((24, 20, 4) if u8 else (24, 20))


def test_compile_graph_cache_hands_out_independent_bindings(image_path):
    """`test_compiler.py::test_program_cache_hit`: a hit shares the program
    but owns its bindings, refreshed from its own graph's Values; an edit
    through one handle never reaches another."""
    main, inner, gn, out = _invert_main_graph(port, image_path)
    prog1 = port.compile_graph(main, device="cpu")
    prog2 = port.compile_graph(main, device="cpu")
    assert prog1._compiler is prog2._compiler
    assert prog1._bindings is not prog2._bindings
    inner_value = next(n.node_id for n in inner.nodes if n.node_type.kind == port.NodeTypeKind.VALUE)
    key = f"g{int(gn)}_value_{int(inner_value)}"
    main2, inner2, _, _ = _invert_main_graph(port, image_path)
    next(n for n in inner2.nodes if n.node_type.kind == port.NodeTypeKind.VALUE).node_type = (
        port.NodeType.Value(0.5))
    prog3 = port.compile_graph(main2, device="cpu")
    assert prog3._compiler is prog1._compiler
    assert float(prog3._bindings[key]) == 0.5 and float(prog1._bindings[key]) == 1.0
    base = prog1()[(out, port.SlotId(0))][0]
    assert not _same(prog3()[(out, port.SlotId(0))][0], base)
    assert _same(prog1()[(out, port.SlotId(0))][0], base)
    # a value override, then the bindings again
    half = prog1(**{key: np.float32(0.5)})[(out, port.SlotId(0))][0]
    assert _same(half, prog3()[(out, port.SlotId(0))][0])


def test_compile_graph_default_and_empty_targets_are_distinct(image_path):
    """`targets=None` (the default outputs) and `[]` (nothing) are distinct
    cache keys; explicit targets are keyed by value, in any order."""
    main, _, _, out = _invert_main_graph(port, image_path)
    default = port.compile_graph(main, device="cpu")
    empty = port.compile_graph(main, targets=[], device="cpu")
    assert default._compiler is not empty._compiler
    assert empty() == {} and set(default()) == {(out, port.SlotId(0))}
    explicit = port.compile_graph(main, targets=[(out, port.SlotId(0))], device="cpu")
    assert explicit._compiler is port.compile_graph(
        main, targets=[(int(out), 0)], device="cpu")._compiler
    assert port.compile_graph(main, device="cpu", cache=False)._compiler is not default._compiler


def test_default_targets_are_the_terminal_nodes_without_outputs():
    """No Output node: every terminal node's slot 0 except a Write's, as in
    the JAX package."""
    for pkg in (ref, port):
        graph = pkg.NodeGraph()
        v = graph.add_node(pkg.Node(pkg.NodeType.Value(0.5)))
        blur = graph.add_node(pkg.Node(pkg.NodeType.Blur(1.0)))
        w = graph.add_node(pkg.Node(pkg.NodeType.Write("/nonexistent/x.png")))
        graph.connect(v, blur, pkg.SlotId(0), pkg.SlotId(0))
        graph.connect(v, w, pkg.SlotId(0), pkg.SlotId(0))
        cls = ref_compiler.CompiledGraph if pkg is ref else port_compiler.CompiledGraph
        kw = {} if pkg is ref else {"device": "cpu"}
        assert [(int(n), int(s)) for n, s in cls(graph, **kw).targets] == [(int(blur), 0)]


def test_bind_input_and_embed_and_rgba():
    """`bind_input`, `bind_input_rgba` and `bind_embed` feed the program as
    the JAX package's do."""
    rng = np.random.default_rng(8)
    planes = [rng.random((12, 10), dtype=np.float32) for _ in range(4)]
    results = []
    for pkg in (ref, port):
        graph = pkg.graphs.normal_map_graph() if pkg is ref else port_graphs.normal_map_graph()
        kw = {} if pkg is ref else {"device": "cpu"}
        cls = ref_compiler.CompiledGraph if pkg is ref else port_compiler.CompiledGraph
        prog = cls(graph, **kw)
        prog.bind_input_rgba(planes)
        results.append(prog())
        g2, gin, _, _, out = _mix_graph(pkg, "ADD", 0.0)
        prog2 = cls(g2, **kw)
        prog2.bind_input(gin, planes[:1])
        results.append(prog2())
    _check_against_ref(results[2], results[0])
    _check_against_ref(results[3], results[1])

    graph = port.NodeGraph()
    emb = graph.add_node(port.Node(port.NodeType.Embed(port.EmbeddedSlotDataId(7))))
    out = graph.add_node(port.Node(port.NodeType.OutputRgba("out")))
    graph.connect(emb, out, port.SlotId(0), port.SlotId(0))
    prog = port_compiler.CompiledGraph(graph, device="cpu")
    with pytest.raises(port.TexProError):
        prog()
    prog.bind_embed(port.EmbeddedSlotDataId(7), planes)
    got = prog()[(out, port.SlotId(0))]
    assert all(_same(p, q) for p, q in zip(got, planes))


def test_set_value_refusals():
    """`CompiledGraph.set_value` on a key that is not a Value binding and
    `BatchedLiveSession.set_value` on a node that is not a Value raise
    `INVALID_NODE_TYPE`; a Value re-binds without a new program."""
    graph, gin, gain, mix, out = _mix_graph(port, "MULTIPLY", 1.0)
    prog = port_compiler.CompiledGraph(graph, device="cpu")
    for bad in (mix, gin, 999):
        with pytest.raises(port.TexProError) as e:
            prog.set_value(bad, 0.5)
        assert e.value.kind == port.ErrorKind.INVALID_NODE_TYPE
    prog.bind_input(gin, [np.full((4, 4), 0.5, np.float32)])
    prog.set_value(gain, 0.5)
    assert _same(prog()[(out, port.SlotId(0))][0], np.full((4, 4), 0.25, np.float32))
    session = port_parallel.BatchedLiveSession(graph, [gin], device="cpu")
    for bad in (mix, gin, 999):
        with pytest.raises(port.TexProError) as e:
            session.set_value(bad, 0.5)
        assert e.value.kind == port.ErrorKind.INVALID_NODE_TYPE


def test_bf16_is_not_yet_ported():
    graph, gin, *_ = _mix_graph(port, "MULTIPLY", 1.0)
    calls = [
        lambda: port_compiler.CompiledGraph(graph, dtype="bfloat16", device="cpu"),
        lambda: port.compile_graph(graph, dtype="bfloat16", device="cpu"),
        lambda: port_parallel.BatchedGraph(graph, {f"input_{int(gin)}"}, dtype="bfloat16",
                                           device="cpu"),
        lambda: port_parallel.BatchedLiveSession(graph, [gin], dtype="bfloat16", device="cpu"),
    ]
    for call in calls:
        with pytest.raises(port.TexProError, match="not yet ported"):
            call()
    assert port_compiler.CompiledGraph(graph, dtype="float32", device="cpu").dtype == torch.float32


def test_entry_points_default_to_the_card():
    """With no device, the compiled API and the batched path run on the
    card and raise where there is none: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    graph, gin, *_ = _mix_graph(port, "MULTIPLY", 1.0)
    for call in (lambda: port.compile_graph(graph),
                 lambda: port_compiler.CompiledGraph(graph),
                 lambda: port_parallel.BatchedGraph(graph, {f"input_{int(gin)}"}),
                 lambda: port_parallel.BatchedLiveSession(graph, [gin])):
        with pytest.raises(port.TexProError, match="cuda"):
            call()


def test_targets_drop_dead_planes():
    """A call with targets keeps no node's planes past their last consumer:
    the evaluator returns the targets only, and the intermediate planes are
    freed while it runs."""
    import weakref

    graph, ids = kernel_graph(port)
    prog = port_compiler.CompiledGraph(graph, device="cpu")
    refs = []
    real = port_compiler.GraphCompiler._emit

    def spy(self, node, by_slot, args, prefix, outer):
        out = real(self, node, by_slot, args, prefix, outer)
        refs.extend((int(node.node_id), weakref.ref(p)) for _, img in out for p in img.planes)
        return out

    try:
        port_compiler.GraphCompiler._emit = spy
        (height,) = _batch(2, 16, 16, 1)
        result = prog(**{f"input_{int(ids['height'])}": (height,)})
    finally:
        port_compiler.GraphCompiler._emit = real
    assert set(result) == {(ids["out"], port.SlotId(0))}
    alive = {nid for nid, r in refs if r() is not None}
    # the Output re-keys the Warp's planes; the Blur's and the Distance's
    # are gone
    assert alive == {int(ids["warp"]), int(ids["out"])}


def test_raw_fn_is_the_program_over_a_whole_argument_dict():
    """`_raw_fn(args)` is what `__call__` computes from the bindings and
    the overrides, as the JAX package's `_raw_fn` (`bench.py` vmaps it)."""
    graph, gin, gain, _, out = _mix_graph(port, "MULTIPLY", 0.5)
    prog = port_compiler.CompiledGraph(graph, device="cpu")
    (batch,) = _batch(3, 8, 8, 4)
    args = dict(prog._bindings, **{f"input_{int(gin)}": (batch,)})
    (got,) = prog._raw_fn(args)[(out, port.SlotId(0))]
    assert _same(got, batch * np.float32(0.5))
    (called,) = prog(**{f"input_{int(gin)}": (batch,)})[(out, port.SlotId(0))]
    assert _same(called, got)


def test_planes_from_numpy_takes_batches():
    (batch,) = _batch(3, 5, 7, 0)
    (t,) = planes_from_numpy([batch], "cpu")
    assert t.shape == (3, 5, 7) and t.dtype == torch.float32 and _same(t, batch)


def test_port_imports_no_jax():
    """`compile_graph` and the batched path import without JAX."""
    import subprocess
    import sys

    code = ("import sys; from kanter_core_tpu_torch import compile_graph; "
            "from kanter_core_tpu_torch.parallel import BatchedGraph, BatchedLiveSession, "
            "shard_planes_batch; assert 'jax' not in sys.modules, 'jax imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
