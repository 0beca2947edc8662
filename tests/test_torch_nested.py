"""Nested Graph nodes, against the JAX package on the CPU.

A Graph node runs its embedded graph: on the fused route inlined into the
outer evaluation (argument keys under `g<node id>_`, nesting the prefixes),
on the per-node route as a throwaway live graph on the same processor.
Outer input slot n feeds inner Input node n, and the outputs are keyed
`SlotId(inner output node id)`. Each read must be bit-identical (f32 as
int32, and u8) to the JAX package's fused route and, where the nesting
only wraps it, to the flat graph. A Graph that nests a Write runs on the
per-node route on both packages.
"""

import os

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu import models as ref_models
from kanter_core_tpu_torch.compiler import CompiledGraph, collect_value_bindings
from test_torch_pernode import _check_reads, _edit, sessions  # noqa: F401 — fixture

torch.set_num_threads(1)

N = 32
ROUTES = ["fused", "auto_update", "no_fuse", "mesh2"]
SPECS = {"fused": ("fused", None), "auto_update": ("auto_update", None),
         "no_fuse": ("no_fuse", None), "mesh2": ("fused", 2)}


def _wrap(inner, input_slots, output_id, name="out"):
    """An outer graph: one InputGray per `input_slots` entry feeding that
    slot of a Graph node holding `inner`, whose output `output_id` feeds an
    OutputGray. Returns (graph, [input ids], Graph node id, output id)."""
    g = ref.NodeGraph()
    inputs = [g.add_node(ref.Node(ref.NodeType.InputGray(f"in{i}"))) for i in range(len(input_slots))]
    node = g.add_node(ref.Node(ref.NodeType.Graph(inner)))
    for inp, slot in zip(inputs, input_slots):
        g.connect(inp, node, ref.SlotId(0), ref.SlotId(slot))
    out = g.add_node(ref.Node(ref.NodeType.OutputGray(name)))
    g.connect(node, out, ref.SlotId(output_id), ref.SlotId(0))
    return g, [int(i) for i in inputs], int(node), int(out)


def _emboss_output(graph) -> int:
    (out,) = graph.output_ids()
    return int(out)


def _planes(count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((N, N), dtype=np.float32) for _ in range(count)]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("depth", [1, 2])
def test_nested_emboss_matches_flat_and_reference(sessions, depth, route):  # noqa: F811
    """The emboss graph wrapped once and twice: bit-identical to the flat
    emboss graph and to the JAX package."""
    emboss = ref_models.emboss_graph()
    inner, out_id = emboss, _emboss_output(emboss)
    for _ in range(depth):
        inner, _, _, out_id = _wrap(inner, [0], out_id)
    graph, (inp,), _, out = _wrap(inner, [0], out_id)
    (height,) = _planes(1)
    flat = ref_models.emboss_graph()
    flat_in = next(int(n.node_id) for n in flat.nodes
                   if n.node_type.kind == ref.NodeTypeKind.INPUT_GRAY)
    nested = sessions(graph, {inp: [height]}, [(ref, "fused", None), (port, *SPECS[route])])
    flat_port = sessions(flat, {flat_in: [height]}, [(port, "fused", None)])[0]
    _check_reads(nested, [out], "render")
    (got_u8, got), = [nested[1].read(out)]
    want_u8, want = flat_port.read(_emboss_output(flat))
    assert np.array_equal(got_u8, want_u8)
    assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))


@pytest.mark.parametrize("route", ROUTES)
def test_outer_slot_n_feeds_inner_input_n(sessions, route):  # noqa: F811
    """Inner graph `in1 − in0` (Input node ids 0 and 1), fed crosswise:
    outer input A on slot 1 and B on slot 0; and an inner InputRgba that
    takes the first outer input."""
    inner = ref.NodeGraph()
    in0 = inner.add_node(ref.Node(ref.NodeType.InputGray("in0")))
    in1 = inner.add_node(ref.Node(ref.NodeType.InputGray("in1")))
    mix = inner.add_node(ref.Node(ref.NodeType.Mix(ref.MixType.SUBTRACT)))
    inner.connect(in1, mix, ref.SlotId(0), ref.SlotId(0))
    inner.connect(in0, mix, ref.SlotId(0), ref.SlotId(1))
    diff = inner.add_node(ref.Node(ref.NodeType.OutputGray("diff")))
    inner.connect(mix, diff, ref.SlotId(0), ref.SlotId(0))
    graph, (a, b), node, out = _wrap(inner, [1, 0], int(diff))
    planes = _planes(2, seed=1)
    opened = sessions(graph, {a: [planes[0]], b: [planes[1]]},
                      [(ref, "fused", None), (port, *SPECS[route])])
    _check_reads(opened, [out], "crosswise")
    u8, (got,) = opened[1].read(out)
    assert np.array_equal(got, planes[0] - planes[1])  # slot 1 (A) is in1


def test_fused_argument_keys_nest_under_prefixes():
    """The inlined nested graphs' arguments carry their Graph node ids as
    prefixes, and the cached evaluator re-binds them."""
    emboss = port.models.emboss_graph()
    out_id = _emboss_output(emboss)
    inner = port.NodeGraph()
    inp = inner.add_node(port.Node(port.NodeType.InputGray("h")))
    g1 = inner.add_node(port.Node(port.NodeType.Graph(emboss)))
    inner.connect(inp, g1, port.SlotId(0), port.SlotId(0))
    o = inner.add_node(port.Node(port.NodeType.OutputGray("o")))
    inner.connect(g1, o, port.SlotId(out_id), port.SlotId(0))
    outer = port.NodeGraph()
    oin = outer.add_node(port.Node(port.NodeType.InputGray("h")))
    g0 = outer.add_node(port.Node(port.NodeType.Graph(inner)))
    outer.connect(oin, g0, port.SlotId(0), port.SlotId(0))
    keys = set(collect_value_bindings(outer))
    strength = f"g{int(g0)}_g{int(g1)}_value_"
    assert {k for k in keys if k.startswith(strength)} and all(
        k.startswith(f"g{int(g0)}_g{int(g1)}_") for k in keys)
    prog = CompiledGraph(outer, emit_all=True, device="cpu")
    (height,) = _planes(1)
    planes, layout = prog.call_with_layout(**{f"input_{int(oin)}": (torch.from_numpy(height),)})
    (idx,) = layout[(g0, port.SlotId(int(o)))]
    assert planes[idx].shape == (N, N)


def _write_graph(pkg, path):
    """InputGray → Blur → Graph{Input 0 → Write(path); Input 0 → Mix
    multiply by 0.5 → Output} → Output."""
    inner = pkg.NodeGraph()
    inp = inner.add_node(pkg.Node(pkg.NodeType.InputGray("h")))
    write = inner.add_node(pkg.Node(pkg.NodeType.Write(path)))
    inner.connect(inp, write, pkg.SlotId(0), pkg.SlotId(0))
    half = inner.add_node(pkg.Node(pkg.NodeType.Value(0.5)))
    mix = inner.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.MULTIPLY)))
    inner.connect(inp, mix, pkg.SlotId(0), pkg.SlotId(0))
    inner.connect(half, mix, pkg.SlotId(0), pkg.SlotId(1))
    o = inner.add_node(pkg.Node(pkg.NodeType.OutputGray("o")))
    inner.connect(mix, o, pkg.SlotId(0), pkg.SlotId(0))
    g = pkg.NodeGraph()
    h = g.add_node(pkg.Node(pkg.NodeType.InputGray("h")))
    blur = g.add_node(pkg.Node(pkg.NodeType.Blur(1.5)))
    g.connect(h, blur, pkg.SlotId(0), pkg.SlotId(0))
    node = g.add_node(pkg.Node(pkg.NodeType.Graph(inner)))
    g.connect(blur, node, pkg.SlotId(0), pkg.SlotId(0))
    out = g.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    g.connect(node, out, pkg.SlotId(int(o)), pkg.SlotId(0))
    return g, h, out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "no_fuse"])
def test_write_inside_graph_runs_per_node(tmp_path, fused):
    """The Graph node nesting a Write runs on the per-node route; its
    output matches the JAX package's. As there, the nested live graph
    renders only what its outputs need, so the Write, upstream of no
    output, writes no file on either package."""
    (height,) = _planes(1, seed=2)
    reads, written = [], []
    for pkg in (ref, port):
        path = str(tmp_path / f"{pkg.__name__}.png")
        graph, h, out = _write_graph(pkg, path)
        tp = (pkg.TextureProcessor(100_000_000, device="cpu") if pkg is port
              else pkg.TextureProcessor(100_000_000))
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.fuse_subgraphs = fused
                g.set_node_graph(graph)
                plane = torch.from_numpy(height) if pkg is port else height
                g.add_input_slot_data(pkg.SlotData(h, pkg.SlotId(0), pkg.SlotImage.Gray(plane)))
            u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(lg, out, pkg.SlotId(0)))
            sd = lg.slot_data(out, pkg.SlotId(0))
            reads.append((u8, np.asarray(sd.image.planes[0].host_data())))
        finally:
            tp.shutdown_now()
        written.append(os.path.exists(path))
    (want_u8, want), (got_u8, got) = reads
    assert np.array_equal(got_u8, want_u8) and np.array_equal(got.view(np.int32), want.view(np.int32))
    assert written == [False, False]


def test_nested_value_edit_reruns_cached_evaluator(sessions):  # noqa: F811
    """An edit inside a nested graph (replacing the Graph node's payload)
    re-renders bit-identically on both packages."""
    emboss = ref_models.emboss_graph()
    graph, (inp,), node, out = _wrap(emboss, [0], _emboss_output(emboss))
    (height,) = _planes(1, seed=3)
    opened = sessions(graph, {inp: [height]}, [(ref, "fused", None), (port, "fused", None)])
    _check_reads(opened, [out], "render")

    def edit(pkg, lg):
        inner = pkg.models.emboss_graph(strength=0.9)
        with lg.write() as g:
            g.node_mut(pkg.NodeId(node)).node_type = pkg.NodeType.Graph(inner)

    _edit(opened, edit)
    _check_reads(opened, [out], "strength edit")


def test_nested_graph_completes_with_admission_cap_one(tmp_path):
    """`test_concurrency_fixes.py::test_nested_graph_completes_with_
    admission_cap_one` on the port: a Graph node's worker blocks while its
    inner graph runs, so Graph packs bypass a cap of one admission slot;
    Image → SeparateRgba → Graph(invert) → Output completes node by node,
    with the JAX package's pixels."""
    from test_torch_image_io import _image

    path = tmp_path / "in.png"
    path.write_bytes(_image(6, 8, False, False, (4,), shape=(16, 20)))
    reads = []
    for pkg in (ref, port):
        tp = (pkg.TextureProcessor(10_000_000, device="cpu") if pkg is port
              else pkg.TextureProcessor(10_000_000))
        try:
            tp.set_max_processing_nodes(1)
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.fuse_subgraphs = False
                img = g.add_node(pkg.Node(pkg.NodeType.Image(str(path))))
                sep = g.add_node(pkg.Node(pkg.NodeType.SeparateRgba()))
                g.connect(img, sep, pkg.SlotId(0), pkg.SlotId(0))
                inner = pkg.graphs.invert_graph()
                node = g.add_node(pkg.Node(pkg.NodeType.Graph(inner)))
                g.connect(sep, node, pkg.SlotId(0), inner.input_slot_id_with_name("in"))
                out = g.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
                g.connect(node, out, inner.output_slot_id_with_name("out"), pkg.SlotId(0))
            reads.append(np.asarray(pkg.TextureProcessor.buffer_rgba(lg, out, pkg.SlotId(0))))
        finally:
            tp.shutdown_now()
    assert reads[0].shape == (16 * 20 * 4,) and np.array_equal(reads[0], reads[1])
