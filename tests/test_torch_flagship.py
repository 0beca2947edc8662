"""The flagship composition through the port against the JAX package's, on
the CPU.

`graphs.flagship_graph` is the port's copy of `__graft_entry__._flagship`:
its JSON must equal the original's. The same graph and four seeded gray
inputs go through both `TextureProcessor`s → `LiveGraph` → fused
evaluation → `buffer_rgba`; the output's f32 planes must be bit-identical
(int32 view) and its u8 export identical after the render and after each of
three edits (the chain's Value, the Distance spread, the Warp intensity).
The per-stage liveness checks of `tests/test_flagship_liveness.py` are
repeated on the port: one perturbation per stage must change the pixels.
"""

import json

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from __graft_entry__ import _flagship
from kanter_core_tpu_torch.compiler import CompiledGraph, collect_value_bindings
from kanter_core_tpu_torch.convert import node_graph_from_reference, planes_from_numpy
from kanter_core_tpu_torch.graphs import flagship_graph

torch.set_num_threads(1)

CANVAS = 64
K = port.NodeTypeKind


def _inputs(n=CANVAS):
    rng = np.random.default_rng(0)
    return [rng.random((n, n), dtype=np.float32) for _ in range(4)]


def test_flagship_graph_is_the_reference_graph():
    graph, inputs, out = flagship_graph(CANVAS)
    want_graph, want_inputs, want_out = _flagship(CANVAS)
    text = json.dumps(graph.to_json(), sort_keys=True)
    assert text == json.dumps(want_graph.to_json(), sort_keys=True)
    assert [int(i) for i in inputs] == [int(i) for i in want_inputs]
    assert int(out) == int(want_out)
    converted = node_graph_from_reference(json.dumps(want_graph.to_json()))
    assert json.dumps(converted.to_json(), sort_keys=True) == text


def _node_of(graph, kind, pred=lambda p: True):
    return next(n.node_id for n in graph.nodes
                if n.node_type.kind == kind and pred(n.node_type.payload))


class _Run:
    """One package's processor holding the flagship at CANVAS²."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg is port:
            self.tp = port.TextureProcessor(100_000_000, device="cpu")
            graph, inputs, self.out = flagship_graph(CANVAS)
        else:
            self.tp = ref.TextureProcessor(100_000_000)
            graph, inputs, self.out = _flagship(CANVAS)
        self.graph = graph
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
            g.set_node_graph(graph)
            for node, plane in zip(inputs, _inputs()):
                if pkg is port:
                    (plane,) = planes_from_numpy([plane], "cpu")
                g.add_input_slot_data(
                    pkg.SlotData(node, pkg.SlotId(0), pkg.SlotImage.Gray(plane))
                )

    def read(self):
        pkg = self.pkg
        u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(self.lg, self.out, pkg.SlotId(0)))
        planes = self.lg.slot_data(self.out, pkg.SlotId(0)).image.planes
        return u8, [np.asarray(p.host_data()) for p in planes]

    def edit(self, step):
        pkg, kinds = self.pkg, self.pkg.NodeTypeKind
        if step == "value":
            v = _node_of(self.graph, kinds.VALUE, lambda p: float(p) == np.float32(0.96))
            with self.lg.write() as g:
                g.node_mut(v).node_type = pkg.NodeType.Value(0.93)
        elif step == "distance":
            self.lg.set_distance(_node_of(self.graph, kinds.DISTANCE), CANVAS / 16.0)
        elif step == "warp":
            self.lg.set_warp(_node_of(self.graph, kinds.WARP), 37.0, 9.0)

    def close(self):
        self.tp.shutdown_now()


def test_flagship_matches_reference_through_render_and_edits():
    runs = [_Run(ref), _Run(port)]
    try:
        seen = []
        for step in (None, "value", "distance", "warp"):
            if step is not None:
                for run in runs:
                    run.edit(step)
            (want_u8, want), (got_u8, got) = runs[0].read(), runs[1].read()
            assert got_u8.dtype == np.uint8 and np.array_equal(got_u8, want_u8), step
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert int((g.view(np.int32) != w.view(np.int32)).sum()) == 0, step
            assert np.isfinite(np.stack(got)).all()
            seen.append(got_u8)
        # every edit reached the pixels
        assert all(not np.array_equal(a, b) for a, b in zip(seen, seen[1:]))
        assert runs[1].lg.fatal_error is None
    finally:
        for run in runs:
            run.close()


@pytest.fixture(scope="module")
def flagship():
    graph, inputs, out = flagship_graph(CANVAS)
    prog = CompiledGraph(graph, emit_all=True, device="cpu")
    args = {f"input_{int(n)}": (torch.from_numpy(p),) for n, p in zip(inputs, _inputs())}
    return graph, inputs, out, prog, args, _render(prog, out, args, {})


def _render(prog, out, args, overrides):
    planes, layout = prog.call_with_layout(**args, **overrides)
    return torch.stack([planes[i] for i in layout[(out, port.SlotId(0))]])


def test_chain_value_and_inputs_are_live(flagship):
    graph, inputs, out, prog, args, base = flagship
    v = _node_of(graph, K.VALUE, lambda p: float(p) != 1.0)
    assert not torch.equal(_render(prog, out, args, {f"value_{int(v)}": np.float32(0.93)}), base)
    rolled = dict(args)
    key = f"input_{int(inputs[0])}"
    rolled[key] = (torch.roll(args[key][0], 7, dims=0),)
    assert not torch.equal(_render(prog, out, rolled, {}), base)


@pytest.mark.parametrize("kind,field", [
    (K.NOISE, "persistence"),
    (K.PATTERN, "mortar"),  # the brick mask is seed-independent; mortar shapes it
    (K.VORONOI, "jitter"),
    (K.RAMP, "k"),
    (K.DISTANCE, None),
    (K.CURVATURE, None),
    (K.AMBIENT_OCCLUSION, None),
    (K.HSV, None),
    (K.WARP, "k"),
])
def test_each_stage_is_live(flagship, kind, field):
    """Perturbing each stage's evaluator argument changes the output."""
    graph, inputs, out, prog, args, base = flagship
    node = _node_of(graph, kind)
    bindings = collect_value_bindings(graph)
    key = next(k for k in bindings if k.endswith(f"_{int(node)}"))
    old = bindings[key]
    if field is None:
        new = np.asarray(old, np.float32) * np.float32(0.5)
    else:
        new = dict(old)
        if field == "k":
            new[field] = np.asarray(old[field], np.float32) * np.float32(0.8)
        else:
            new[field] = np.float32(float(old[field]) * 0.5 + 0.1)
    assert not torch.equal(_render(prog, out, args, {key: new}), base), (
        f"{kind.value} does not reach the pixels"
    )


def _fingerprint_after(edit):
    from kanter_core_tpu_torch.compiler import graph_fingerprint

    graph, _, _ = flagship_graph(CANVAS)
    ids = {kind: _node_of(graph, kind) for kind in (
        K.DISTANCE, K.HSV, K.NOISE, K.PATTERN, K.VORONOI, K.RAMP, K.CURVATURE,
        K.AMBIENT_OCCLUSION, K.WARP, K.BLUR,
    )}
    if edit is not None:
        edit(graph, ids)
    return graph_fingerprint(graph)


@pytest.mark.parametrize("edit", [
    lambda g, i: g.set_distance(i[K.DISTANCE], 3.0),
    lambda g, i: g.set_hsv(i[K.HSV], -40.0, 0.5, 1.2),
    lambda g, i: g.set_noise(i[K.NOISE], CANVAS, CANVAS, 7, 3, 1, 0.25),
    lambda g, i: g.set_pattern(i[K.PATTERN], CANVAS, CANVAS, "Brick", 3, 5, 0.2, 0.1, 8),
    lambda g, i: g.set_voronoi(i[K.VORONOI], CANVAS, CANVAS, 4, 9, 0.3, 2),
    lambda g, i: g.set_ramp(i[K.RAMP], CANVAS, CANVAS, "Radial", 15.0, 0.2, 0.7, 1.5),
    lambda g, i: g.set_curvature(i[K.CURVATURE], 2.0),
    lambda g, i: g.set_ambient_occlusion(i[K.AMBIENT_OCCLUSION], 0.5, 1.0),
    lambda g, i: g.set_warp(i[K.WARP], 200.0, 77.0),
], ids=["distance", "hsv", "noise", "pattern", "voronoi", "ramp", "curvature", "ao",
        "warp"])
def test_argument_edits_reuse_the_cached_evaluator(edit):
    """An edit of an argument field keeps the structure fingerprint, so the
    engine re-runs its cached evaluator with new bindings."""
    assert _fingerprint_after(edit) == _fingerprint_after(None)


@pytest.mark.parametrize("edit", [
    lambda g, i: g.set_blur_sigma(i[K.BLUR], 2.0),
    lambda g, i: g.set_ambient_occlusion(i[K.AMBIENT_OCCLUSION], 2.0, 3.0),
    lambda g, i: g.set_noise(i[K.NOISE], CANVAS, CANVAS, 4, 2, 9, 0.5),
    lambda g, i: g.set_pattern(i[K.PATTERN], CANVAS, CANVAS, "Checker", 4, 8, 0.12, 0.06, 3),
    lambda g, i: g.set_ramp(i[K.RAMP], CANVAS, CANVAS, "Box", 0.0, 0.5, 0.5, 0.9),
], ids=["blur-sigma", "ao-radius", "noise-octaves", "pattern-kind", "ramp-kind"])
def test_structure_edits_change_the_fingerprint(edit):
    assert _fingerprint_after(edit) != _fingerprint_after(None)
