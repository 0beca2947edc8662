"""Graph model parity: the port's node kinds, NodeGraph and serde against the
JAX package (the pattern of `tests/test_graph.py::test_json_format_compat`).

The JSON a graph exports must be byte-identical between the two packages,
`convert.node_graph_from_reference` must round-trip the JAX package's JSON,
and the serde clamps of saved payloads must agree.
"""

import json

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu import graphs as ref_graphs
from kanter_core_tpu import models as ref_models
from kanter_core_tpu_torch import graphs as port_graphs
from kanter_core_tpu_torch import models as port_models
from kanter_core_tpu_torch.compiler import CompiledGraph
from kanter_core_tpu_torch.convert import node_graph_from_reference

torch.set_num_threads(1)

GRAPHS = {
    "pbr_material": (ref_models.pbr_material_graph, port_models.pbr_material_graph),
    "ambient_occlusion": (ref_models.ambient_occlusion_graph, port_models.ambient_occlusion_graph),
    "invert": (ref_graphs.invert_graph, port_graphs.invert_graph),
    "blend": (ref_graphs.blend_graph, port_graphs.blend_graph),
    "normal_map": (ref_graphs.normal_map_graph, port_graphs.normal_map_graph),
    "resize_pyramid": (ref_graphs.resize_pyramid_graph, port_graphs.resize_pyramid_graph),
    "bounded_chain": (
        lambda: ref_graphs.bounded_chain_graph(16)[0],
        lambda: port_graphs.bounded_chain_graph(16)[0],
    ),
}


def _dumps(graph) -> str:
    return json.dumps(graph.to_json())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_json_export_byte_identical(name):
    make_ref, make_port = GRAPHS[name]
    assert _dumps(make_ref()) == _dumps(make_port())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_node_graph_from_reference_round_trips(name):
    text = _dumps(GRAPHS[name][0]())
    graph = node_graph_from_reference(text)
    assert isinstance(graph, port.NodeGraph)
    assert _dumps(graph) == text
    # ids resume after the largest one, like NodeGraph.from_path
    assert int(graph.new_id()) == max(int(n.node_id) for n in graph.nodes) + 1


# one constructor call per node kind (all 26), as (name, args)
KINDS = [
    ("InputGray", ("h",)), ("InputRgba", ("c",)), ("OutputGray", ("o",)),
    ("OutputRgba", ("o",)), ("Image", ("img.png",)), ("Embed", (3,)),
    ("Write", ("out.png",)), ("Value", (0.25,)), ("Mix", (None,)),
    ("HeightToNormal", ()), ("SeparateRgba", ()), ("CombineRgba", ()),
    ("Blur", (2.5,)), ("Levels", (0.1, 0.9, 1.0, 0.0, 1.0)),
    ("Noise", (64, 32, 4, 3, 7)), ("GradientMap", ([(0, 0, 0, 0, 1), (1, 1, 1, 1, 1)],)),
    ("Transform", (1.0, 2.0, 30.0, 1.0, 1.0)), ("Warp", (45.0, 8.0)),
    ("Pattern", (64, 64, "Brick", 4, 8, 0.1, 0.05, 3)), ("Curvature", (2.0,)),
    ("Hsv", (30.0, 0.5, 1.0)), ("AmbientOcclusion", (1.5, 3.0)),
    ("Distance", (8.0,)), ("Voronoi", (64, 64, 8, 8, 0.5, 2)),
    ("Ramp", (64, 64, "Radial", 0.0, 0.5, 0.5, 1.0)),
]


def _graph_of_kind(pkg, kind, args):
    if kind == "Embed":
        args = (pkg.EmbeddedSlotDataId(args[0]),)
    graph = pkg.NodeGraph()
    graph.add_node(pkg.Node(getattr(pkg.NodeType, kind)(*args)))
    return graph


@pytest.mark.parametrize("kind,args", KINDS + [("Graph", ())], ids=lambda v: str(v)[:24])
def test_every_node_kind_serializes_like_reference(kind, args):
    if kind == "Graph":
        make = lambda pkg, g: pkg.NodeType.Graph(g)  # noqa: E731
        inner = {
            ref: ref_graphs.invert_graph(), port: port_graphs.invert_graph(),
        }
        graphs = {}
        for pkg in (ref, port):
            graphs[pkg] = pkg.NodeGraph()
            graphs[pkg].add_node(pkg.Node(make(pkg, inner[pkg])))
    else:
        graphs = {pkg: _graph_of_kind(pkg, kind, args) for pkg in (ref, port)}
    text = _dumps(graphs[ref])
    assert _dumps(graphs[port]) == text
    # slot signatures agree too
    (ref_node,), (port_node,) = graphs[ref].nodes, graphs[port].nodes
    for side in ("input_slots", "output_slots"):
        want = [(s.name, int(s.slot_id), s.slot_type.value) for s in getattr(ref_node, side)()]
        got = [(s.name, int(s.slot_id), s.slot_type.value) for s in getattr(port_node, side)()]
        assert got == want
    assert _dumps(node_graph_from_reference(text)) == text


@pytest.mark.parametrize(
    "node_type",
    [
        {"Blur": 300.0}, {"Blur": -1.0}, {"Blur": 1e-9},
        {"AmbientOcclusion": {"strength": 1.0, "radius": 99.0}},
        {"Noise": {"width": 2**40, "height": 0, "cells": 2**29, "octaves": 30,
                   "seed": -5, "persistence": 0.5}},
        {"Voronoi": {"width": 8, "height": 8, "cells_x": 0, "cells_y": 3,
                     "jitter": 7.0, "seed": "x"}},
    ],
    ids=lambda v: next(iter(v)),
)
def test_serde_clamps_match_reference(node_type):
    data = {"nodes": [{"node_id": 0, "node_type": node_type,
                       "resize_policy": "MostPixels", "resize_filter": "Triangle"}],
            "edges": []}
    want = _dumps(ref.NodeGraph.from_json(data))
    assert _dumps(port.NodeGraph.from_json(data)) == want


def test_name_dedup_and_slot_typing_match_reference():
    def build(pkg):
        g = pkg.NodeGraph()
        a = g.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
        b = g.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
        c = g.add_node(pkg.Node(pkg.NodeType.InputRgba("in")))
        h2n = g.add_node(pkg.Node(pkg.NodeType.HeightToNormal()))
        with pytest.raises(pkg.TexProError) as err:
            g.connect(c, h2n, pkg.SlotId(0), pkg.SlotId(0))  # Rgba → Gray slot
        assert err.value.kind.value == "InvalidSlotType"
        return g.output_names(), _dumps(g), int(a), int(b)

    assert build(port) == build(ref)


def _compiled_pair(build):
    """The slot-0 planes of the graph's one output, from the JAX package's
    `CompiledGraph` and from the port's, on the CPU."""
    ref_graph, ref_out = build(ref)
    want = ref.CompiledGraph(ref_graph)()[(ref_out, ref.SlotId(0))]
    graph, out = build(port)
    planes, layout = CompiledGraph(graph, emit_all=True, device="cpu").call_with_layout()
    got = [planes[i] for i in layout[(out, port.SlotId(0))]]
    return got, want


def _value_into(pkg, node_type):
    graph = pkg.NodeGraph()
    value = graph.add_node(pkg.Node(pkg.NodeType.Value(0.5)))
    node = graph.add_node(pkg.Node(node_type(pkg)))
    graph.connect(value, node, pkg.SlotId(0), pkg.SlotId(0))
    out = graph.add_node(pkg.Node(pkg.NodeType.OutputGray("out")))
    graph.connect(node, out, pkg.SlotId(0), pkg.SlotId(0))
    return graph, out


def test_levels_evaluates_as_reference():
    got, want = _compiled_pair(
        lambda pkg: _value_into(pkg, lambda p: p.NodeType.Levels(0.1, 0.9, 2.2, 0.0, 1.0)))
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0].numpy().view(np.int32), np.asarray(want[0]).view(np.int32))


def test_mix_pow_evaluates_as_reference():
    got, want = _compiled_pair(
        lambda pkg: _value_into(pkg, lambda p: p.NodeType.Mix(p.MixType.POW)))
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0].numpy().view(np.int32), np.asarray(want[0]).view(np.int32))


def test_compiled_graph_layout_keeps_aliasing():
    """Output re-keying and SeparateRgba alias their producer's planes: the
    layout reports each plane once."""
    graph = port_graphs.normal_map_graph()
    prog = CompiledGraph(graph, emit_all=True, device="cpu")
    plane = torch.from_numpy(np.random.default_rng(0).random((8, 8), dtype=np.float32))
    planes, layout = prog.call_with_layout(input_rgba_first=(plane, plane, plane, plane))
    inp, sep, h2n, out = (n.node_id for n in graph.nodes)
    assert layout[(out, port.SlotId(0))] == layout[(h2n, port.SlotId(0))]
    assert layout[(sep, port.SlotId(0))] == (layout[(inp, port.SlotId(0))][0],)
    assert len(planes) == len({i for idxs in layout.values() for i in idxs})
