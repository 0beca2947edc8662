"""The material templates and their three node kinds, against the JAX
package on the CPU.

The six templates the port gained with Levels, GradientMap and Transform
(`emboss`, `wood`, `stone`, `metal`, `brick`, `cobblestone`), at 48², go
through the port's fused route, both per-node routes (`auto_update`,
`fuse_subgraphs=False`) and the fused route over a CPU mesh of two shards;
each read must be bit-identical (f32 as int32, and u8) to the JAX package's
fused route, after the render and after each of `chip_smoke.py` phase 11's
edits (a Levels gamma, a GradientMap stop colour, a Transform rotation, a
Blur sigma). Their JSON round-trips through the port's serde as the JAX
package writes it. Below that, each new op against its JAX function on
seeded planes, edge parameters included.
"""

import json

import jax
import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu import models as ref_models
from kanter_core_tpu.ops import gradient as ref_gradient
from kanter_core_tpu.ops import levels as ref_levels
from kanter_core_tpu.ops import transform as ref_transform
from kanter_core_tpu_torch import models as port_models
from kanter_core_tpu_torch.ops import gradient as port_gradient
from kanter_core_tpu_torch.ops import levels as port_levels
from kanter_core_tpu_torch.ops import transform as port_transform
from kanter_core_tpu_torch.ops import warp as port_warp
from kanter_core_tpu_torch.parallel import MESH_COUNTERS
from test_torch_pernode import _check_reads, _edit, _node, sessions  # noqa: F401 — fixture

torch.set_num_threads(1)

CANVAS = 48
K = ref.NodeTypeKind


def _levels_gamma(node_id, gamma):
    def edit(pkg, lg):
        in_lo, in_hi, _, out_lo, out_hi = lg.node(pkg.NodeId(node_id)).node_type.payload
        lg.set_levels(pkg.NodeId(node_id), in_lo, in_hi, gamma, out_lo, out_hi)
    return edit


def _stop_colour(node_id, stop, rgba):
    def edit(pkg, lg):
        stops = [list(s) for s in lg.node(pkg.NodeId(node_id)).node_type.payload]
        stops[stop][1:] = rgba
        lg.set_gradient_map(pkg.NodeId(node_id), [tuple(s) for s in stops])
    return edit


def _rotation(node_id, degrees):
    def edit(pkg, lg):
        ox, oy, _, sx, sy = lg.node(pkg.NodeId(node_id)).node_type.payload
        lg.set_transform(pkg.NodeId(node_id), ox, oy, degrees, sx, sy)
    return edit


def _case(name):
    """`(graph, {input id: planes}, [(label, edit)])` of a template at
    CANVAS², in the JAX package's model."""
    if name == "emboss":
        graph = ref_models.emboss_graph()
        inp = _node(graph, K.INPUT_GRAY)
        height = np.random.default_rng(0).random((CANVAS, CANVAS), dtype=np.float32)
        blur = _node(graph, K.BLUR)
        return graph, {inp: [height]}, [
            ("blur sigma", lambda pkg, lg: lg.set_blur_sigma(pkg.NodeId(blur), 2.0))]
    graph = getattr(ref_models, f"{name}_material_graph")(size=CANVAS)
    levels = lambda gamma: _node(graph, K.LEVELS,  # noqa: E731
                                 lambda p: np.float32(p[2]) == np.float32(gamma))
    edits = {
        "wood": lambda: [("levels gamma", _levels_gamma(levels(1.6), 2.0)),
                         ("transform rotation", _rotation(_node(graph, K.TRANSFORM), 30.0))],
        "stone": lambda: [("levels gamma", _levels_gamma(levels(2.4), 1.8))],
        "metal": lambda: [("levels gamma", _levels_gamma(levels(3.2), 2.5)),
                          ("transform rotation", _rotation(_node(graph, K.TRANSFORM), 15.0))],
        "brick": lambda: [("stop colour", _stop_colour(_node(graph, K.GRADIENT_MAP), 3,
                                                       (0.75, 0.25, 0.2, 1.0)))],
        "cobblestone": lambda: [("stop colour", _stop_colour(_node(graph, K.GRADIENT_MAP), 2,
                                                             (0.5, 0.52, 0.4, 1.0)))],
    }[name]()
    return graph, {}, edits


TEMPLATES = ["emboss", "wood", "stone", "metal", "brick", "cobblestone"]
ROUTES = {"fused": ("fused", None), "auto_update": ("auto_update", None),
          "no_fuse": ("no_fuse", None), "mesh2": ("fused", 2)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", TEMPLATES)
def test_template_matches_reference(sessions, name, route):  # noqa: F811
    graph, inputs, edits = _case(name)
    outputs = [int(o) for o in graph.output_ids()]
    port_route, shards = ROUTES[route]
    opened = sessions(graph, inputs, [(ref, "fused", None), (port, port_route, shards)],
                      keep=True)
    MESH_COUNTERS.reset()  # process-wide
    _check_reads(opened, outputs, "render")
    for label, edit in edits:
        _edit(opened, edit)
        _check_reads(opened, outputs, label)
    if shards:
        gathers = opened[1].tp.metrics()["mesh"]["gathers"]
        transforms = sum(1 for n in graph.nodes if n.node_type.kind == K.TRANSFORM)
        rotations = sum(label == "transform rotation" for label, _ in edits)
        # one gray plane gathered per Transform evaluation; a Warp whose
        # halo does not fit the 24-row blocks gathers its plane and strength
        assert gathers["transform"] == transforms + rotations
        unfit = sum(1 for n in graph.nodes if n.node_type.kind == K.WARP
                    and not port_warp.fits_mesh(CANVAS, shards,
                                                port_warp.warp_halo(n.node_type.payload[1])))
        assert gathers["warp_gate"] == 2 * unfit
        assert gathers["blur_gate"] == gathers["resize"] == 0, gathers


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_serde_round_trip(name):
    make = "emboss_graph" if name == "emboss" else f"{name}_material_graph"
    text = json.dumps(getattr(port_models, make)().to_json())
    assert text == json.dumps(getattr(ref_models, make)().to_json())
    again = port.NodeGraph.from_json(json.loads(text))
    assert json.dumps(again.to_json()) == text
    assert int(again.new_id()) == max(int(n.node_id) for n in again.nodes) + 1


# --- the ops ------------------------------------------------------------------


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same(got, want) -> bool:
    return _bits(got).shape == _bits(want).shape and np.array_equal(_bits(got), _bits(want))


def _plane(seed, shape=(37, 53), lo=-0.2, hi=1.2):
    p = np.random.default_rng(seed).random(shape, dtype=np.float32)
    p = p * np.float32(hi - lo) + np.float32(lo)
    p.flat[::41] = np.nan
    return p


LEVELS = {
    "identity": (0.0, 1.0, 1.0, 0.0, 1.0),
    "gamma 1 remap": (0.2, 0.8, 1.0, 0.1, 0.9),
    "gamma 1.6": (0.2, 0.8, 1.6, 0.0, 1.0),
    "gamma 0.45 inverted out": (0.1, 0.95, 0.45, 0.85, 0.45),
    "degenerate span": (0.5, 0.5, 2.0, 0.0, 1.0),
    "constant out": (0.0, 1.0, 1.0, 0.92, 0.92),
}


@pytest.mark.parametrize("params", list(LEVELS))
def test_levels_plane_matches_reference(params):
    x = _plane(1)
    b = np.asarray(LEVELS[params], np.float32)
    want = jax.jit(ref_levels.levels_plane)(x, b)
    got = port_levels.levels_plane(torch.from_numpy(x), port_levels.levels_bindings(b))
    assert _same(got, want)


GRADIENTS = {
    "two stops": [(0.0, 0.0, 0.1, 0.2, 1.0), (1.0, 1.0, 0.9, 0.8, 0.5)],
    "wood": [(0.0, 0.26, 0.15, 0.06, 1.0), (0.42, 0.45, 0.28, 0.13, 1.0),
             (0.72, 0.60, 0.42, 0.22, 1.0), (1.0, 0.72, 0.55, 0.34, 1.0)],
    "degenerate stop": [(0.0, 0.0, 0.0, 0.0, 1.0), (0.5, 0.2, 0.4, 0.6, 1.0),
                        (0.5, 0.9, 0.1, 0.3, 1.0), (1.0, 1.0, 1.0, 1.0, 1.0)],
    "inner stops": [(0.1, 0.5, 0.25, 0.125, 0.75), (0.4, 0.2, 0.6, 0.3, 1.0),
                    (0.9, 0.95, 0.85, 0.05, 0.5)],
}


@pytest.mark.parametrize("stops", list(GRADIENTS))
def test_gradient_planes_match_reference(stops):
    x = _plane(2)
    b = ref_gradient.gradient_bindings(GRADIENTS[stops])
    want = jax.jit(ref_gradient.gradient_planes)(x, b["pos"], b["colors"])
    got = port_gradient.gradient_planes([torch.from_numpy(x)],
                                        port_gradient.gradient_bindings(GRADIENTS[stops]))
    assert len(got) == 4 and all(_same(g, w) for g, w in zip(got, want))


def test_gradient_map_refuses_rgba():
    planes = [torch.zeros((4, 4))] * 4
    with pytest.raises(port.TexProError) as err:
        port_gradient.gradient_planes(planes, port_gradient.gradient_bindings(GRADIENTS["wood"]))
    assert err.value.kind == port.ErrorKind.INVALID_BUFFER_COUNT


TRANSFORMS = {
    "stretch y": (0.0, 0.0, 0.0, 1.0, 6.0),
    "stretch x": (0.0, 0.0, 0.0, 24.0, 1.0),
    "rotate 37 offset": (3.5, -7.25, 37.0, 1.3, 0.7),
    "quarter turns": (0.0, 0.0, 270.0, 1.0, 1.0),
    "negative angle": (-11.0, 5.0, -30.0, 2.0, 2.0),
    "zero scale": (0.0, 0.0, 10.0, 0.0, 1.0),
}


@pytest.mark.parametrize("shape", [(37, 53), (1, 1), (64, 17)], ids=str)
@pytest.mark.parametrize("payload", list(TRANSFORMS))
def test_transform_planes_match_reference(payload, shape):
    planes = [_plane(3 + i, shape, 0.0, 1.0) for i in range(4)]
    h, w = shape
    b = ref_transform.transform_bindings(TRANSFORMS[payload])
    want = jax.jit(ref_transform.transform_planes, static_argnums=(6, 7))(
        tuple(planes), np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32),
        b["cs"], b["inv_s"], b["off"], h, w,
    )
    pb = port_transform.transform_bindings(TRANSFORMS[payload])
    for key in ("cs", "inv_s", "off"):
        assert _same(pb[key], b[key])
    got = port_transform.transform_planes([torch.from_numpy(p) for p in planes], pb)
    assert all(_same(g, w) for g, w in zip(got, want))


KIND_EDITS = {
    "Levels": (lambda p: p.NodeType.Levels(0.1, 0.9, 1.7, 0.0, 1.0),
               lambda lg, n: lg.set_levels(n, 0.1, 0.9, 2.3, 0.0, 1.0),
               lambda lg, n: lg.set_levels(n, 0.1, 0.9, 1.7, 0.0, 1.0)),
    "GradientMap": (lambda p: p.NodeType.GradientMap(GRADIENTS["wood"]),
                    lambda lg, n: lg.set_gradient_map(n, GRADIENTS["two stops"]),
                    lambda lg, n: lg.set_gradient_map(n, GRADIENTS["wood"])),
    "Transform": (lambda p: p.NodeType.Transform(3.0, -2.0, 37.0, 1.5, 0.8),
                  lambda lg, n: lg.set_transform(n, 3.0, -2.0, 52.0, 1.5, 0.8),
                  lambda lg, n: lg.set_transform(n, 3.0, -2.0, 37.0, 1.5, 0.8)),
}


@pytest.mark.parametrize("route", ["fused", "no_fuse"])
@pytest.mark.parametrize("kind", list(KIND_EDITS))
def test_parameter_undo_is_served_from_the_recipe_cache(kind, route):
    """An edit of the node's parameters and its undo: the undo's read is a
    recipe-cache hit (the keys of `recipe_cache.node_recipe` hash every
    parameter of the three kinds) and gives the first read's bits."""
    make, edit, undo = KIND_EDITS[kind]
    tp = port.TextureProcessor(100_000_000, device="cpu")
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.fuse_subgraphs = route == "fused"
            inp = g.add_node(port.Node(port.NodeType.InputGray("h")))
            node = g.add_node(port.Node(make(port)))
            g.connect(inp, node, port.SlotId(0), port.SlotId(0))
            out = g.add_node(port.Node(port.NodeType.OutputRgba("out")))
            g.connect(node, out, port.SlotId(0), port.SlotId(0))
            g.add_input_slot_data(port.SlotData(inp, port.SlotId(0), port.SlotImage.Gray(
                torch.from_numpy(_plane(5, (24, 40), 0.0, 1.0)))))

        def read():
            u8 = port.TextureProcessor.buffer_rgba(lg, out, port.SlotId(0))
            return u8, tp.metrics()["recipe_cache"]["hits"]

        first, _ = read()
        edit(lg, node)
        edited, hits_before = read()
        undo(lg, node)
        again, hits_after = read()
        assert not np.array_equal(edited, first)
        assert np.array_equal(again, first) and hits_after > hits_before
    finally:
        tp.shutdown_now()
