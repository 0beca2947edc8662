"""The port's per-node route against the JAX package's, on the CPU.

The per-node route is taken under `auto_update` (every dirty node
re-renders and becomes Clean on its own) and with `fuse_subgraphs=False`.
The same graph (the port's copy made from the JAX package's JSON) and the
same seeded input planes go through the JAX package's `TextureProcessor` on
that route, through the port's on that route (on one device and over its
CPU mesh of 2 and 4 shards) and through the port's fused route. Every read
must give bit-identical f32 planes (int32 view) and equal u8 exports, after
the render and after every edit.

Also here: the JAX package's per-node behaviours (scheduling, commit-time
cancel, priorities, Distance under `auto_update`), the parity of the kinds
the first slices refused, the error parity of RGBA inputs on Gray-only
nodes, and the Pattern constructor's refusal of a non-finite groove.
"""

import json
import math
import threading
import time

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from __graft_entry__ import _flagship
from kanter_core_tpu import graphs as ref_graphs
from kanter_core_tpu import models as ref_models
from kanter_core_tpu_torch.convert import node_graph_from_reference, planes_from_numpy
from kanter_core_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

CANVAS = 64
MESH_CANVAS = 128  # 32-row blocks over four shards hold every blur's radius
ROUTES = ["auto_update", "no_fuse"]


class _Session:
    """One processor holding `graph_json` on one route (`"auto_update"`,
    `"no_fuse"` or `"fused"`), with `{input node id: [planes]}` bound: the
    JAX package's (`pkg=ref`), or the port's on the CPU, over a CPU mesh of
    `shards` when given."""

    def __init__(self, pkg, graph_json, inputs, route, shards=None, keep=False):
        self.pkg = pkg
        if pkg is port:
            mesh = None if shards is None else make_mesh(devices=["cpu"] * shards)
            self.tp = port.TextureProcessor(100_000_000, device="cpu", mesh=mesh)
            graph = node_graph_from_reference(graph_json)
        else:
            self.tp = ref.TextureProcessor(100_000_000)
            graph = ref.NodeGraph.from_json(json.loads(graph_json))
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
            g.use_cache = keep
            g.auto_update = route == "auto_update"
            g.fuse_subgraphs = route == "fused"
            g.set_node_graph(graph)
            for node_id, planes in inputs.items():
                if pkg is port:
                    planes = planes_from_numpy(planes, "cpu")
                image = (pkg.SlotImage.Gray(planes[0]) if len(planes) == 1
                         else pkg.SlotImage.Rgba(planes))
                g.add_input_slot_data(pkg.SlotData(pkg.NodeId(node_id), pkg.SlotId(0), image))

    def read(self, node_id):
        """(u8 bytes, [f32 planes]) of the node's slot 0."""
        pkg = self.pkg
        u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(self.lg, pkg.NodeId(node_id), pkg.SlotId(0)))
        sd = self.lg.slot_data(pkg.NodeId(node_id), pkg.SlotId(0))
        return u8, [np.asarray(p.host_data()) for p in sd.image.planes]

    def close(self):
        self.tp.shutdown_now()


@pytest.fixture
def sessions():
    opened = []

    def open_all(graph, inputs, specs, keep=False):
        """One session per `(pkg, route, shards)` of `specs`."""
        text = json.dumps(graph.to_json())
        for pkg, route, shards in specs:
            opened.append(_Session(pkg, text, inputs, route, shards, keep))
        return opened[-len(specs):]

    yield open_all
    for session in opened:
        session.close()


def _check_reads(sessions, outputs, label):
    """Every session's reads equal the first's, bit for bit."""
    for node_id in outputs:
        (want_u8, want), *others = [s.read(node_id) for s in sessions]
        for got_u8, got in others:
            assert got_u8.dtype == np.uint8 and np.array_equal(got_u8, want_u8), (label, node_id)
            assert len(got) == len(want), (label, node_id)
            for g, w in zip(got, want):
                assert g.shape == w.shape, (label, node_id)
                assert int((g.view(np.int32) != w.view(np.int32)).sum()) == 0, (label, node_id)


def _node(graph, kind, pred=lambda p: True):
    return next(int(n.node_id) for n in graph.nodes
                if n.node_type.kind == kind and pred(n.node_type.payload))


def _edit(sessions, fn):
    for s in sessions:
        fn(s.pkg, s.lg)


def _pbr_case(n=CANVAS):
    graph = ref_models.pbr_material_graph()
    inp = _node(graph, ref.NodeTypeKind.INPUT_GRAY)
    height = np.random.default_rng(0).random((n, n), dtype=np.float32)
    return graph, {inp: [height]}, [int(o) for o in graph.output_ids()]


def _run_pbr(sessions, n=CANVAS):
    """The PBR slice's render, AO-strength Value edit and AO sigma edit."""
    graph, _, outputs = _pbr_case(n)
    _check_reads(sessions, outputs, "render")
    ao_strength = _node(graph, ref.NodeTypeKind.VALUE, lambda p: p == 0.75)

    def value_edit(pkg, lg):
        with lg.write() as g:
            g.node_mut(pkg.NodeId(ao_strength)).node_type = pkg.NodeType.Value(0.6)

    _edit(sessions, value_edit)
    _check_reads(sessions, outputs, "value edit")
    ao_blur = _node(graph, ref.NodeTypeKind.BLUR, lambda p: p == 6.0)
    _edit(sessions, lambda pkg, lg: lg.set_blur_sigma(pkg.NodeId(ao_blur), 4.0))
    _check_reads(sessions, outputs, "sigma edit")


def _flagship_case(n=CANVAS):
    graph, ref_inputs, out = _flagship(n)
    rng = np.random.default_rng(0)
    inputs = {int(i): [rng.random((n, n), dtype=np.float32)] for i in ref_inputs}
    return graph, inputs, [int(out)]


def _run_flagship(sessions, n=CANVAS):
    """The flagship's render, chain Value edit, Distance edit and Warp edit."""
    graph, _, outputs = _flagship_case(n)
    K = ref.NodeTypeKind
    v = _node(graph, K.VALUE, lambda p: float(p) == np.float32(0.96))
    dist, warp = _node(graph, K.DISTANCE), _node(graph, K.WARP)
    _check_reads(sessions, outputs, "render")

    def value_edit(pkg, lg):
        with lg.write() as g:
            g.node_mut(pkg.NodeId(v)).node_type = pkg.NodeType.Value(0.93)

    _edit(sessions, value_edit)
    _check_reads(sessions, outputs, "value edit")
    _edit(sessions, lambda pkg, lg: lg.set_distance(pkg.NodeId(dist), n / 16.0))
    _check_reads(sessions, outputs, "distance edit")
    _edit(sessions, lambda pkg, lg: lg.set_warp(pkg.NodeId(warp), 37.0, 9.0))
    _check_reads(sessions, outputs, "warp edit")


@pytest.mark.parametrize("route", ROUTES)
def test_pbr_per_node_matches_reference_and_fused(sessions, route):
    graph, inputs, _ = _pbr_case()
    opened = sessions(graph, inputs, [(ref, route, None), (port, route, None),
                                      (port, "fused", None)])
    _run_pbr(opened)
    assert opened[1].tp.metrics()["fused_programs"] == 0  # no fused dispatch ran


@pytest.mark.parametrize("route", ROUTES)
def test_flagship_per_node_matches_reference_and_fused(sessions, route):
    graph, inputs, _ = _flagship_case()
    opened = sessions(graph, inputs, [(ref, route, None), (port, route, None),
                                      (port, "fused", None)], keep=True)
    _run_flagship(opened)
    assert opened[1].tp.metrics()["fused_programs"] == 0


def _small_case(name):
    """(graph, {input node id: planes}, [output ids]) for the five small
    graphs of the ROADMAP's slice-1 milestone."""
    rng = np.random.default_rng(len(name))

    def planes(k, n=48):
        return [rng.random((n, n), dtype=np.float32) for _ in range(k)]

    if name == "bounded_chain":
        graph, inputs, _, out = ref_graphs.bounded_chain_graph(16)
        return graph, {int(i): planes(1) for i in inputs}, [int(out)]
    graph = {
        "invert": ref_graphs.invert_graph,
        "blend": lambda: ref_graphs.blend_graph(ref.MixType.SCREEN),
        "normal_map": ref_graphs.normal_map_graph,
        "resize_pyramid": lambda: ref_graphs.resize_pyramid_graph((96, 40, 17)),
    }[name]()
    bound = {}
    for node in graph.nodes:
        if node.node_type.kind == ref.NodeTypeKind.INPUT_GRAY:
            bound[int(node.node_id)] = planes(1)
        elif node.node_type.kind == ref.NodeTypeKind.INPUT_RGBA:
            bound[int(node.node_id)] = planes(4)
    return graph, bound, [int(o) for o in graph.output_ids()]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "name", ["invert", "blend", "normal_map", "resize_pyramid", "bounded_chain"]
)
def test_small_graph_per_node_matches_reference_and_fused(sessions, name, route):
    graph, inputs, outputs = _small_case(name)
    opened = sessions(graph, inputs, [(ref, route, None), (port, route, None),
                                      (port, "fused", None)])
    _check_reads(opened, outputs, name)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("slice_name", ["pbr", "flagship"])
def test_per_node_mesh_matches_reference(sessions, slice_name, shards):
    """The port's per-node route over a CPU mesh against the JAX package's
    single-device per-node route and the port's single-device fused route
    (the JAX mesh engine's own per-node test needs its image decode and a
    TPU-sized mesh). Distance gathers once per evaluation; nothing else
    gathers but the exports."""
    from kanter_core_tpu_torch.parallel import MESH_COUNTERS

    case, run = (_pbr_case, _run_pbr) if slice_name == "pbr" else (_flagship_case, _run_flagship)
    graph, inputs, outputs = case(MESH_CANVAS)
    opened = sessions(graph, inputs, [(ref, "auto_update", None), (port, "auto_update", shards),
                                      (port, "fused", None)], keep=True)
    MESH_COUNTERS.reset()
    run(opened, MESH_CANVAS)
    metrics = opened[1].tp.metrics()["mesh"]
    assert metrics["exchanges"] > 0
    gathers = metrics["gathers"]
    assert gathers["blur_gate"] == gathers["warp_gate"] == gathers["resize"] == 0
    reads = len(outputs) * (3 if slice_name == "pbr" else 4)
    assert gathers["export"] == reads
    # the flagship's Distance runs on the render and on its own edit (its
    # mask comes from the Pattern, which the chain Value edit does not reach)
    assert gathers["distance"] == (0 if slice_name == "pbr" else 2)


# --- the JAX package's per-node behaviours -----------------------------------


def _processor():
    return port.TextureProcessor(10_000_000, device="cpu")


def _render(lg, node_id):
    return port.TextureProcessor.buffer_rgba(lg, node_id, port.SlotId(0))


def _rgba_input(g, n=12, seed=0):
    """An InputRgba node with seeded planes bound (the port has no Image
    decode; the reference tests read an image file here)."""
    node = g.add_node(port.Node(port.NodeType.InputRgba("in")))
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.random((n, n), dtype=np.float32)) for _ in range(4)]
    g.add_input_slot_data(port.SlotData(node, port.SlotId(0), port.SlotImage.Rgba(planes)))
    return node


def _intermediate_clean_is_observable():
    """`test_state.py::test_input_output_intercept`: under auto_update an
    intermediate node is observably Clean before the final output."""
    from kanter_core_tpu_torch import ResizeFilter, ResizePolicy, Size

    tp = _processor()
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.auto_update = True
            prev = _rgba_input(g)
            chain = []
            for size in (10, 20, 30):
                node = g.add_node(
                    port.Node(port.NodeType.Mix())
                    .with_resize_filter(ResizeFilter.LANCZOS3)
                    .with_resize_policy(ResizePolicy.SpecificSize(Size(size, size)))
                )
                g.connect(prev, node, port.SlotId(0), port.SlotId(0))
                chain.append(node)
                prev = node
            out = g.add_node(port.Node(port.NodeType.OutputRgba("out")))
            g.connect(prev, out, port.SlotId(0), port.SlotId(0))
        deadline = time.time() + 60
        while time.time() < deadline:
            with lg.read() as g:
                if g.node_state(out) == port.NodeState.CLEAN:
                    return False
                if g.node_state(chain[0]) == port.NodeState.CLEAN:
                    return True
        return False
    finally:
        tp.shutdown_now()


def _dangling_node_does_not_wedge():
    """`test_state.py::test_unconnected_node`."""
    tp = _processor()
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            value = g.add_node(port.Node(port.NodeType.Value(0.0)))
            g.add_node(port.Node(port.NodeType.Value(0.0)))
            out = g.add_node(port.Node(port.NodeType.OutputGray("out")))
            g.connect(value, out, port.SlotId(0), port.SlotId(0))
            g.auto_update = True
        time.sleep(0.2)
        return _render(lg, out).tolist() == [0, 0, 0, 255]
    finally:
        tp.shutdown_now()


def _connect_order_with_use_cache():
    """`test_state.py::test_connect_ordering_race`: downstream connected
    first, then upstream, under auto_update and use_cache."""
    tp = _processor()
    try:
        lg = port.LiveGraph(tp.buffer_queue)
        lg.auto_update = True
        lg.use_cache = True
        tp.push_live_graph(lg)
        with lg.write() as g:
            value = g.add_node(port.Node(port.NodeType.Value(0.5)))
            combine = g.add_node(port.Node(port.NodeType.CombineRgba()))
            separate = g.add_node(port.Node(port.NodeType.SeparateRgba()))
            g.connect(combine, separate, port.SlotId(0), port.SlotId(0))
            time.sleep(0.1)
            g.connect(value, combine, port.SlotId(0), port.SlotId(0))
            time.sleep(0.1)
        with port.LiveGraph.await_clean_read(lg, combine) as g:
            size_ok = g.slot_data_size(combine, port.SlotId(0)) == port.Size(1, 1)
        with port.LiveGraph.await_clean_read(lg, separate) as g:
            red = g.slot_data(separate, port.SlotId(0)).image.to_u8().tolist()
        return size_ok and red == [127, 127, 127, 255]
    finally:
        tp.shutdown_now()


def _commit_time_cancel():
    """`test_state.py::test_midflight_edit_discards_commit`: an edit while a
    node is Processing discards its result at commit, and the node is
    evaluated again with the new topology."""
    from kanter_core_tpu_torch import ops as ops_mod

    slow_started, release = threading.Event(), threading.Event()
    real_process_node = ops_mod.process_node

    def slow_process_node(node, *args, **kwargs):
        if node.node_type.kind == port.NodeTypeKind.MIX:
            slow_started.set()
            release.wait(timeout=20)
        return real_process_node(node, *args, **kwargs)

    ops_mod.process_node = slow_process_node
    tp = _processor()
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.fuse_subgraphs = False
            g.memoize = False
            a = g.add_node(port.Node(port.NodeType.Value(0.25)))
            b = g.add_node(port.Node(port.NodeType.Value(0.75)))
            mix = g.add_node(port.Node(port.NodeType.Mix(port.MixType.ADD)))
            out = g.add_node(port.Node(port.NodeType.OutputGray("out")))
            g.connect(a, mix, port.SlotId(0), port.SlotId(0))
            g.connect(mix, out, port.SlotId(0), port.SlotId(0))
            g.request(out)
        assert slow_started.wait(timeout=20), "mix never started processing"
        with lg.write() as g:
            g.connect(b, mix, port.SlotId(0), port.SlotId(0))
        release.set()
        pixels = _render(lg, out).tolist()
        return pixels == [191, 191, 191, 255] and tp.timeline.counters().get("discarded", 0) >= 1
    finally:
        ops_mod.process_node = real_process_node
        release.set()
        tp.shutdown_now()


def _per_node_end_to_end_with_admission_cap_one():
    """`test_concurrency_fixes.py::test_nested_graph_completes_with_
    admission_cap_one`, without the nested Graph and the image decode the
    port does not have: with one admission slot and `fuse_subgraphs=False`,
    a Separate → invert → Output chain completes node by node."""
    tp = _processor()
    try:
        tp.set_max_processing_nodes(1)
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.fuse_subgraphs = False
            img = _rgba_input(g, n=16, seed=3)
            sep = g.add_node(port.Node(port.NodeType.SeparateRgba()))
            g.connect(img, sep, port.SlotId(0), port.SlotId(0))
            one = g.add_node(port.Node(port.NodeType.Value(1.0)))
            inv = g.add_node(port.Node(port.NodeType.Mix(port.MixType.SUBTRACT)))
            g.connect(one, inv, port.SlotId(0), port.SlotId(0))
            g.connect(sep, inv, port.SlotId(0), port.SlotId(1))
            out = g.add_node(port.Node(port.NodeType.OutputGray("out")))
            g.connect(inv, out, port.SlotId(0), port.SlotId(0))
        pixels = _render(lg, out)
        return pixels.shape == (16 * 16 * 4,)
    finally:
        tp.shutdown_now()


def _large_finishes_first(large_priority: int) -> bool:
    """`test_priority.py::_priority_internal` with one admission slot: True
    iff the large node finished before both small siblings."""
    from kanter_core_tpu_torch import ResizeFilter, ResizePolicy, Size

    size = 24
    tp = _processor()
    try:
        tp.set_max_processing_nodes(1)
        lg = tp.new_live_graph()
        with lg.write() as g:
            value = g.add_node(port.Node(port.NodeType.Value(0.5)))

            def resize_node(n):
                return (port.Node(port.NodeType.Mix())
                        .with_resize_filter(ResizeFilter.NEAREST)
                        .with_resize_policy(ResizePolicy.SpecificSize(Size(n, n))))

            small_1 = g.add_node(resize_node(size))
            small_2 = g.add_node(resize_node(size + 1))
            large = g.add_node(resize_node(size + 2))
            g.node(large).priority.set_priority(large_priority)
            for node in (small_1, large, small_2):
                g.connect(value, node, port.SlotId(0), port.SlotId(0))
            g.auto_update = True
        with port.LiveGraph.await_clean_read(lg, large) as g:
            return not (g.node_state(small_1) == port.NodeState.CLEAN
                        and g.node_state(small_2) == port.NodeState.CLEAN)
    finally:
        tp.shutdown_now()


def _distance_under_auto_update():
    """`test_distance.py::test_distance_four_consumer_parity`, its fused and
    per-node consumers: the same pixels from both routes."""
    pixels = {}
    for auto in (False, True):
        tp = _processor()
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                pat = g.add_node(port.Node(port.NodeType.Pattern(
                    97, 83, "Checker", cells_x=4, cells_y=3, mortar=0.3, bevel=0.0, seed=2)))
                ds = g.add_node(port.Node(port.NodeType.Distance(8.0)))
                g.connect(pat, ds, port.SlotId(0), port.SlotId(0))
                out = g.add_node(port.Node(port.NodeType.OutputGray("out")))
                g.connect(ds, out, port.SlotId(0), port.SlotId(0))
                g.auto_update = auto
            pixels[auto] = _render(lg, out)
        finally:
            tp.shutdown_now()
    return np.array_equal(pixels[False], pixels[True]) and pixels[True].size == 97 * 83 * 4


BEHAVIOURS = {
    "intermediate_clean_observable": (_intermediate_clean_is_observable, True),
    "dangling_node_does_not_wedge": (_dangling_node_does_not_wedge, True),
    "connect_order_with_use_cache": (_connect_order_with_use_cache, True),
    "commit_time_cancel": (_commit_time_cancel, True),
    "end_to_end_admission_cap_one": (_per_node_end_to_end_with_admission_cap_one, True),
    "priority_high_runs_first": (lambda: _large_finishes_first(1), True),
    "priority_low_runs_last": (lambda: _large_finishes_first(-1), False),
    "distance_under_auto_update": (_distance_under_auto_update, True),
}


@pytest.mark.parametrize("name", list(BEHAVIOURS))
def test_reference_per_node_behaviour(name):
    fn, expected = BEHAVIOURS[name]
    assert fn() is expected


# --- error parity -------------------------------------------------------------


def _kind_graph(pkg, kind):
    """(graph, node to read) with one node of `kind` (the kinds the first
    slices of the port refused) feeding an output, and a Value feeding it
    where it takes an input."""
    g = pkg.NodeGraph()
    value = g.add_node(pkg.Node(pkg.NodeType.Value(0.5)))
    node_type = {
        "Levels": lambda: pkg.NodeType.Levels(0.1, 0.9, 2.2, 0.0, 1.0),
        "GradientMap": lambda: pkg.NodeType.GradientMap([(0.0, 0.0, 0.0, 0.0, 1.0),
                                                         (1.0, 1.0, 1.0, 1.0, 1.0)]),
        "Transform": lambda: pkg.NodeType.Transform(0.1, 0.0, 90.0, 1.0, 1.0),
        "Image": lambda: pkg.NodeType.Image("missing.png"),
        "MixPow": lambda: pkg.NodeType.Mix(pkg.MixType.POW),
    }[kind]()
    node = g.add_node(pkg.Node(node_type))
    if kind != "Image":
        g.connect(value, node, pkg.SlotId(0), pkg.SlotId(0))
    out = g.add_node(pkg.Node(pkg.NodeType.OutputRgba("out") if kind in ("Image", "GradientMap")
                              else pkg.NodeType.OutputGray("out")))
    g.connect(node, out, pkg.SlotId(0), pkg.SlotId(0))
    return g, out


@pytest.mark.parametrize("route", ["fused"] + ROUTES)
@pytest.mark.parametrize("kind", ["Levels", "GradientMap", "Transform", "Image", "MixPow"])
def test_formerly_unported_kind_matches_reference_on_every_route(sessions, kind, route):
    """Each kind the port once refused ("not yet ported") now renders on
    every route bit-identically to the JAX package's same route (a missing
    Image file is the magenta placeholder on both)."""
    graph, out = _kind_graph(ref, kind)
    opened = sessions(graph, {}, [(ref, route, None), (port, route, None)])
    _check_reads(opened, [int(out)], kind)
    assert not opened[1].tp.shutdown.load()


def _rgba_into_gray_only(pkg, kind, n=8):
    """InputRgba → Mix (passes RGBA through a GRAY_OR_RGBA output) → a
    Gray-only `kind` → output: the connect checks cannot see the RGBA."""
    g = pkg.NodeGraph()
    inp = g.add_node(pkg.Node(pkg.NodeType.InputRgba("in")))
    mix = g.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.ADD)))
    node_type = {
        "HeightToNormal": pkg.NodeType.HeightToNormal,
        "Curvature": lambda: pkg.NodeType.Curvature(1.0),
        "AmbientOcclusion": lambda: pkg.NodeType.AmbientOcclusion(1.0, 1.0),
        "Distance": lambda: pkg.NodeType.Distance(4.0),
    }[kind]()
    node = g.add_node(pkg.Node(node_type))
    out = g.add_node(pkg.Node(pkg.NodeType.OutputGray("out")
                              if kind != "HeightToNormal" else pkg.NodeType.OutputRgba("out")))
    g.connect(inp, mix, pkg.SlotId(0), pkg.SlotId(0))
    g.connect(mix, node, pkg.SlotId(0), pkg.SlotId(0))
    g.connect(node, out, pkg.SlotId(0), pkg.SlotId(0))
    planes = [np.full((n, n), 0.5, np.float32) for _ in range(4)]
    return g, inp, out, planes


@pytest.mark.parametrize("route", ["fused"] + ROUTES)
@pytest.mark.parametrize("kind", ["HeightToNormal", "Curvature", "AmbientOcclusion", "Distance"])
def test_rgba_into_gray_only_node_fails_like_reference(kind, route):
    """The JAX package's per-node op returns no output for an RGBA input and
    its output-count check raises INVALID_BUFFER_COUNT, which shuts the
    processor down; the port raises the same kind, with the same fatality,
    on each route."""
    kinds, shut = {}, {}
    for pkg in (ref, port):
        graph, inp, out, planes = _rgba_into_gray_only(pkg, kind)
        if pkg is port:
            planes = [torch.from_numpy(p) for p in planes]
            tp = _processor()
        else:
            tp = ref.TextureProcessor(10_000_000)
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.set_node_graph(graph)
                g.auto_update = route == "auto_update" or pkg is ref
                g.fuse_subgraphs = route == "fused" and pkg is port
                g.add_input_slot_data(pkg.SlotData(inp, pkg.SlotId(0), pkg.SlotImage.Rgba(planes)))
            with pytest.raises(pkg.TexProError) as err:
                pkg.TextureProcessor.buffer_rgba(lg, out, pkg.SlotId(0))
            kinds[pkg] = err.value.kind.name
            shut[pkg] = tp.shutdown.load()
        finally:
            tp.shutdown_now()
    assert kinds[port] == kinds[ref] == "INVALID_BUFFER_COUNT"
    assert shut[port] and shut[ref]


# --- the Pattern constructor ----------------------------------------------------


@pytest.mark.parametrize("value", [math.inf, -math.inf, math.nan])
@pytest.mark.parametrize("field", ["mortar", "bevel"])
def test_pattern_rejects_non_finite_groove(field, value):
    """A deliberate divergence from the JAX package, whose constructor
    accepts `+inf`: serde clamps a non-finite groove to 0.0, so an accepted
    `+inf` would not survive `export_json`/`from_path`. The port refuses
    every non-finite `mortar` and `bevel` with the constructor's GENERIC
    error."""
    with pytest.raises(port.TexProError) as err:
        port.NodeType.Pattern(64, 64, **{field: value})
    assert err.value.kind == port.ErrorKind.GENERIC


@pytest.mark.parametrize("value", [0.0, 1e-30, 0.3, 2.5, 1e30])
def test_pattern_finite_groove_round_trips(tmp_path, value):
    """Every finite groove ≥ 0 the constructor accepts round-trips through
    serde unchanged, bit for bit."""
    g = port.NodeGraph()
    node = g.add_node(port.Node(port.NodeType.Pattern(32, 16, "Brick", mortar=value,
                                                      bevel=value / 2)))
    path = str(tmp_path / "pattern.json")
    g.export_json(path)
    back = port.NodeGraph.from_path(path).node(node).node_type.payload
    assert back[5] == value and back[6] == value / 2
    assert math.copysign(1.0, back[5]) == 1.0


@pytest.mark.parametrize("route", ROUTES)
def test_worker_error_fails_the_graph_without_fallback(monkeypatch, route):
    """A kernel that raises in a worker (as a CUDA error or a failed build
    does) fails the graph and shuts the processor down; the node is not
    rerun on another version."""
    from kanter_core_tpu_torch.ops import blur as blur_mod

    calls = []

    def failing_blur(plane, sigma):
        calls.append(sigma)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(blur_mod, "blur_plane", failing_blur)
    tp = _processor()
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.auto_update = route == "auto_update"
            g.fuse_subgraphs = False
            value = g.add_node(port.Node(port.NodeType.Value(0.5)))
            node = g.add_node(port.Node(port.NodeType.Blur(2.0)))
            out = g.add_node(port.Node(port.NodeType.OutputGray("out")))
            g.connect(value, node, port.SlotId(0), port.SlotId(0))
            g.connect(node, out, port.SlotId(0), port.SlotId(0))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            _render(lg, out)
        assert calls == [2.0] and tp.shutdown.load()
    finally:
        tp.shutdown_now()
