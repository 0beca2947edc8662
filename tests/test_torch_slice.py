"""The port's main path against the JAX package's, end to end on the CPU.

The same graph (the port's copy made from the JAX package's JSON through
`convert.node_graph_from_reference`) and the same seeded input planes go
through both `TextureProcessor`s → `LiveGraph` → fused evaluation →
`buffer_rgba`. Every output's f32 planes must be bit-identical (int32 view)
and its u8 export identical, on the first render and after each edit.
"""

import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu import graphs as ref_graphs
from kanter_core_tpu import models as ref_models
from kanter_core_tpu_torch.convert import node_graph_from_reference, planes_from_numpy

torch.set_num_threads(1)


class _Session:
    """One package's processor + live graph holding `graph_json`, with the
    given `{input node id: [planes]}` bound."""

    def __init__(self, pkg, graph_json: str, inputs: dict):
        self.pkg = pkg
        if pkg is port:
            self.tp = port.TextureProcessor(10_000_000, device="cpu")
            graph = node_graph_from_reference(graph_json)
        else:
            self.tp = ref.TextureProcessor(10_000_000)
            graph = ref.NodeGraph.from_json(json.loads(graph_json))
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
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

    def open_both(graph, inputs):
        text = json.dumps(graph.to_json())
        pair = [_Session(ref, text, inputs), _Session(port, text, inputs)]
        opened.extend(pair)
        return pair

    yield open_both
    for session in opened:
        session.close()


def _assert_same_outputs(ref_session, port_session, node_ids):
    for node_id in node_ids:
        want_u8, want = ref_session.read(node_id)
        got_u8, got = port_session.read(node_id)
        assert got_u8.dtype == np.uint8 and np.array_equal(got_u8, want_u8), node_id
        assert len(got) == len(want), node_id
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert int((g.view(np.int32) != w.view(np.int32)).sum()) == 0, node_id


def _height(n, seed=0):
    return np.random.default_rng(seed).random((n, n), dtype=np.float32)


def test_pbr_material_slice_matches_reference(sessions):
    graph = ref_models.pbr_material_graph()
    (inp,) = [n.node_id for n in graph.nodes if n.node_type.kind == ref.NodeTypeKind.INPUT_GRAY]
    outputs = {graph.node(o).node_type.payload: o for o in graph.output_ids()}
    assert set(outputs) == {"normal", "ao", "roughness", "albedo"}
    r, p = sessions(graph, {int(inp): [_height(128)]})
    _assert_same_outputs(r, p, [outputs[k] for k in ("normal", "ao", "roughness", "albedo")])

    (ao_strength,) = [n.node_id for n in graph.nodes
                      if n.node_type.kind == ref.NodeTypeKind.VALUE and n.node_type.payload == 0.75]
    (ao_blur,) = [n.node_id for n in graph.nodes
                  if n.node_type.kind == ref.NodeTypeKind.BLUR and n.node_type.payload == 6.0]
    for s in (r, p):
        with s.lg.write() as g:
            g.node_mut(s.pkg.NodeId(ao_strength)).node_type = s.pkg.NodeType.Value(0.6)
    _assert_same_outputs(r, p, [outputs["ao"], outputs["roughness"]])

    for s in (r, p):
        s.lg.set_blur_sigma(s.pkg.NodeId(ao_blur), 4.0)
    _assert_same_outputs(r, p, [outputs["ao"], outputs["roughness"], outputs["normal"]])
    assert p.tp.metrics()["recipe_cache"]["hits"] > 0  # memoize is on the path


def _roadmap_case(name):
    """(graph, {input node id: planes}, [output ids]) for the five graphs
    of the ROADMAP's slice-1 milestone."""
    rng = np.random.default_rng(len(name))

    def planes(k, n=48):
        return [rng.random((n, n), dtype=np.float32) for _ in range(k)]

    if name == "bounded_chain":
        graph, inputs, _, out = ref_graphs.bounded_chain_graph(16)
        return graph, {int(i): planes(1) for i in inputs}, [out]
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
    return graph, bound, graph.output_ids()


@pytest.mark.parametrize(
    "name", ["invert", "blend", "normal_map", "resize_pyramid", "bounded_chain"]
)
def test_roadmap_graph_matches_reference(sessions, name):
    graph, inputs, outputs = _roadmap_case(name)
    r, p = sessions(graph, inputs)
    _assert_same_outputs(r, p, outputs)


def test_slice_under_eviction_matches_resident_run():
    """With a zero device budget and a zero host budget the memory manager
    evicts every idle plane device→host→disk while the slice renders and
    is edited; faulted-back planes must give the same maps as a run that
    keeps everything resident."""
    graph = ref_models.pbr_material_graph()
    (inp,) = [n.node_id for n in graph.nodes if n.node_type.kind == ref.NodeTypeKind.INPUT_GRAY]
    (value,) = [n.node_id for n in graph.nodes
                if n.node_type.kind == ref.NodeTypeKind.VALUE and n.node_type.payload == 0.75]
    text, height = json.dumps(graph.to_json()), [_height(40)]
    resident = _Session(port, text, {int(inp): height})
    evicting = _Session(port, text, {int(inp): height})
    evicting.tp.memory_threshold.store(0)
    evicting.tp.buffer_queue.host_threshold = port.AtomicUsize(0)
    try:
        for step in range(2):
            for node_id in graph.output_ids():
                want_u8, want = resident.read(node_id)
                got_u8, got = evicting.read(node_id)
                assert np.array_equal(got_u8, want_u8)
                assert all(np.array_equal(g.view(np.int32), w.view(np.int32))
                           for g, w in zip(got, want))
            for s in (resident, evicting):
                with s.lg.write() as g:
                    g.node_mut(port.NodeId(value)).node_type = port.NodeType.Value(0.5)
        assert evicting.tp.metrics()["bytes_storage"] + evicting.tp.metrics()["bytes_host"] > 0
    finally:
        resident.close()
        evicting.close()


def test_concurrent_reads_and_edits_settle_to_a_fresh_render():
    """Readers on four threads and Value edits on the main thread share one
    live graph; once they stop, every output equals a fresh render of the
    final graph (a lost commit or a stale cache hit would break this)."""
    graph = ref_models.pbr_material_graph()
    (inp,) = [n.node_id for n in graph.nodes if n.node_type.kind == ref.NodeTypeKind.INPUT_GRAY]
    (value,) = [n.node_id for n in graph.nodes
                if n.node_type.kind == ref.NodeTypeKind.VALUE and n.node_type.payload == 0.75]
    text, height = json.dumps(graph.to_json()), [_height(48)]
    live = _Session(port, text, {int(inp): height})
    outputs = live.lg.node_graph.output_ids()
    errors = []
    stop = threading.Event()

    def reader(node_id):
        try:
            while not stop.is_set():
                port.TextureProcessor.buffer_rgba(live.lg, node_id, port.SlotId(0))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(o,)) for o in outputs]
    try:
        for t in threads:
            t.start()
        for i in range(20):
            with live.lg.write() as g:
                g.node_mut(port.NodeId(value)).node_type = port.NodeType.Value(0.5 + i / 50)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old_interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    final = json.dumps(live.lg.node_graph.to_json())
    fresh = _Session(port, final, {int(inp): height})
    try:
        for node_id in outputs:
            got_u8, got = live.read(node_id)
            want_u8, want = fresh.read(node_id)
            assert np.array_equal(got_u8, want_u8)
            assert all(np.array_equal(g.view(np.int32), w.view(np.int32))
                       for g, w in zip(got, want))
    finally:
        live.close()
        fresh.close()


def test_import_pulls_in_no_jax():
    code = (
        "import sys, kanter_core_tpu_torch, kanter_core_tpu_torch.parallel; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'kanter_core_tpu' or m.startswith('kanter_core_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize(
    "option", [{"mesh": object()}, {"tile_bytes": 1 << 20}, {"bucket_sizes": True},
               {"precision": "bfloat16"}],
    ids=lambda o: next(iter(o)),
)
def test_unported_routes_raise(option):
    """The tiled, bucketed and bf16 routes are not ported; the mesh route
    is (`tests/test_torch_mesh.py`), and a mesh that is not a
    `parallel.Mesh` raises."""
    with pytest.raises(port.TexProError) as err:
        port.TextureProcessor(device="cpu", **option)
    if "mesh" in option:
        assert "mesh must be" in str(err.value)
    else:
        assert "not yet ported" in str(err.value)


def test_cuda_processor_without_card_raises():
    """No silent CPU fallback: asking for CUDA without a card fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(port.TexProError):
        port.TextureProcessor(device="cuda")
