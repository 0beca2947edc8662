"""Random graphs over the port's node kinds, through every route.

The JAX package holds its routes together with a random-graph generator
(`tests/test_fuzz_equivalence.py`). This generator draws over the port's
kinds: Input planes, Value, Mix (every mode but POW), Separate/Combine,
HeightToNormal, Blur up to σ 12, the procedural sources (Noise, Pattern,
Voronoi, Ramp), Hsv, Curvature, AmbientOcclusion, Distance and Warp, with
random resize policies, filters and slot wiring, on small irregular
canvases. The seeds from 16 on (`extended`) also draw Levels (gamma 1 and
others), GradientMap, Transform and Mix POW; the first 16 seeds draw as
they always did.

Each graph's outputs are read through the JAX package's fused and per-node
routes and the port's fused and per-node routes, on one device and over a
CPU mesh of two shards; every u8 export and every f32 plane (int32 view)
must be bit-identical. Grow the generator with each node kind the port
gains.
"""

import json

import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu_torch.convert import node_graph_from_reference, planes_from_numpy
from kanter_core_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

# (width, height): a few shapes only, so the JAX package's per-node
# kernels are compiled once per shape and reused across seeds; even heights
# shard over two devices, 9 rows do not
SIZES = [(16, 16), (24, 16), (12, 20), (8, 9)]
MIX_MODES = [m for m in ref.MixType if m != ref.MixType.POW]


def _random_graph(seed: int, extended: bool = False):
    """`(graph, {input node id: [planes]}, [output node ids])`, built in the
    JAX package's model; `extended` also draws the kinds of the later
    slices (Levels, GradientMap, Transform, Mix POW)."""
    mix_modes = list(ref.MixType) if extended else MIX_MODES
    rng = np.random.default_rng(seed)
    g = ref.NodeGraph()
    producers = []  # (node id, slot id, runtime RGBA?)
    inputs = {}

    def size():
        return SIZES[rng.integers(len(SIZES))]

    def pick(rgba=None, pool=None):
        options = [p for p in (producers if pool is None else pool)
                   if rgba is None or p[2] == rgba]
        return None if not options else options[rng.integers(len(options))]

    def add(node_type, outs, resize=True, inputs_count=1):
        node = ref.Node(node_type)
        if resize:
            r = rng.integers(6)
            node.resize_policy = [
                ref.ResizePolicy.MostPixels, ref.ResizePolicy.LeastPixels,
                ref.ResizePolicy.LargestAxes, ref.ResizePolicy.SmallestAxes,
                lambda: ref.ResizePolicy.SpecificSlot(ref.SlotId(int(rng.integers(inputs_count)))),
                lambda: ref.ResizePolicy.SpecificSize(ref.Size(*size())),
            ][r]()
            node.resize_filter = list(ref.ResizeFilter)[rng.integers(len(ref.ResizeFilter))]
        node_id = g.add_node(node)
        producers.extend((node_id, ref.SlotId(s), rgba) for s, rgba in outs)
        return node_id

    def connect(src, node_id, slot):
        g.connect(src[0], node_id, src[1], ref.SlotId(slot))

    # leaves: at most one InputRgba (it reads the first bound input), gray
    # inputs, a Value and one procedural source
    if rng.random() < 0.6:
        node_id = add(ref.NodeType.InputRgba("rgba"), [(0, True)], resize=False)
        w, h = size()
        inputs[int(node_id)] = [rng.random((h, w), dtype=np.float32) for _ in range(4)]
    for _ in range(int(rng.integers(1, 3))):
        node_id = add(ref.NodeType.InputGray(f"gray{len(inputs)}"), [(0, False)], resize=False)
        w, h = size()
        inputs[int(node_id)] = [rng.random((h, w), dtype=np.float32)]
    add(ref.NodeType.Value(float(rng.random())), [(0, False)], resize=False)
    w, h = size()
    source = rng.integers(4)
    seed_arg = int(rng.integers(1 << 16))
    if source == 0:
        add(ref.NodeType.Noise(w, h, cells=int(rng.integers(2, 6)), octaves=int(rng.integers(1, 4)),
                               seed=seed_arg, persistence=float(rng.random())),
            [(0, False)], resize=False)
    elif source == 1:
        add(ref.NodeType.Pattern(w, h, ["Checker", "Brick", "Stripe"][rng.integers(3)],
                                 cells_x=int(rng.integers(1, 5)), cells_y=int(rng.integers(1, 5)),
                                 mortar=float(rng.random() * 0.3), bevel=float(rng.random() * 0.2),
                                 seed=seed_arg),
            [(0, False), (1, False)], resize=False)
    elif source == 2:
        add(ref.NodeType.Voronoi(w, h, cells_x=int(rng.integers(1, 5)),
                                 cells_y=int(rng.integers(1, 5)), jitter=float(rng.random()),
                                 seed=seed_arg),
            [(0, False), (1, False), (2, False)], resize=False)
    else:
        angle = float(rng.integers(0, 4) * 90.0) if rng.random() < 0.5 else float(rng.random() * 360.0)
        add(ref.NodeType.Ramp(w, h, ["Linear", "Radial", "Box"][rng.integers(3)], angle=angle,
                              cx=float(rng.random()), cy=float(rng.random()),
                              scale=float(0.5 + rng.random())),
            [(0, False)], resize=False)

    for _ in range(int(rng.integers(4, 9))):
        pool = list(producers)  # only earlier nodes: the graph stays acyclic
        op = rng.integers(15 if extended else 11)
        if op in (0, 1):  # Mix, with its slot wiring in either order
            mode = mix_modes[rng.integers(len(mix_modes))]
            wiring = [(0, 0.9), (1, 0.7)]
            if rng.random() < 0.5:
                wiring.reverse()
            chosen = {slot: pick(pool=pool) for slot, prob in wiring if rng.random() < prob}
            left, right = chosen.get(0), chosen.get(1)
            rgba = left[2] if left is not None else (right[2] if right is not None else False)
            node_id = add(ref.NodeType.Mix(mode), [(0, rgba)], inputs_count=2)
            for slot, _ in wiring:
                if slot in chosen:
                    connect(chosen[slot], node_id, slot)
        elif op == 2:  # CombineRgba
            node_id = add(ref.NodeType.CombineRgba(), [(0, True)], inputs_count=4)
            for slot in range(4):
                src = pick(False, pool)
                if src is not None and rng.random() < 0.6:
                    connect(src, node_id, slot)
        elif op == 3:  # SeparateRgba
            src = pick(True, pool)
            node_id = add(ref.NodeType.SeparateRgba(), [(i, False) for i in range(4)])
            if src is not None:
                connect(src, node_id, 0)
        elif op in (4, 5, 6, 7):  # Gray-only: HeightToNormal, Curvature, AO, Distance
            src = pick(False, pool)
            if src is None:
                continue
            node_type, rgba = [
                (ref.NodeType.HeightToNormal(), True),
                (ref.NodeType.Curvature(float(rng.random() * 8.0)), False),
                (ref.NodeType.AmbientOcclusion(float(rng.random() * 3.0),
                                               float(0.5 + rng.random() * 2.5)), False),
                (ref.NodeType.Distance(float(1.0 + rng.random() * 12.0)), False),
            ][op - 4]
            connect(src, add(node_type, [(0, rgba)]), 0)
        elif op == 8:  # Blur, either type
            src = pick(pool=pool)
            sigma = round(float(0.3 + rng.random() * 11.7), 2)
            connect(src, add(ref.NodeType.Blur(sigma), [(0, src[2])]), 0)
        elif op == 9:  # Hsv, either type
            src = pick(pool=pool)
            node_type = ref.NodeType.Hsv(float(rng.random() * 720.0 - 360.0),
                                         float(rng.random() * 2.0), float(rng.random() * 2.0))
            connect(src, add(node_type, [(0, src[2])]), 0)
        elif op == 11:  # Levels, either type; gamma 1 half the time
            src = pick(pool=pool)
            lo, hi = sorted(float(v) for v in rng.random(2))
            gamma = 1.0 if rng.random() < 0.5 else float(0.3 + rng.random() * 3.0)
            out_lo, out_hi = (float(v) for v in rng.random(2))
            connect(src, add(ref.NodeType.Levels(lo, hi, gamma, out_lo, out_hi), [(0, src[2])]), 0)
        elif op == 12:  # GradientMap of a Gray input
            src = pick(False, pool)
            if src is None:
                continue
            count = int(rng.integers(2, 6))
            stops = [(float(p), *(float(c) for c in rng.random(4)))
                     for p in sorted(rng.random(count))]
            connect(src, add(ref.NodeType.GradientMap(stops), [(0, True)]), 0)
        elif op == 13:  # Transform, either type
            src = pick(pool=pool)
            angle = float(rng.integers(0, 4) * 90.0) if rng.random() < 0.3 else float(
                rng.random() * 720.0 - 360.0)
            node_type = ref.NodeType.Transform(
                float(rng.random() * 20.0 - 10.0), float(rng.random() * 20.0 - 10.0), angle,
                float(0.25 + rng.random() * 4.0), float(0.25 + rng.random() * 4.0))
            connect(src, add(node_type, [(0, src[2])]), 0)
        else:  # Warp (and, extended, a second Mix POW draw): an image of either type
            if op == 14:
                src, other = pick(pool=pool), pick(pool=pool)
                node_id = add(ref.NodeType.Mix(ref.MixType.POW), [(0, src[2])], inputs_count=2)
                connect(src, node_id, 0)
                connect(other, node_id, 1)
                continue
            src = pick(pool=pool)
            node_id = add(ref.NodeType.Warp(float(rng.random() * 360.0), float(rng.random() * 12.0)),
                          [(0, src[2])], inputs_count=2)
            connect(src, node_id, 0)
            strength = pick(False, pool)
            if strength is not None and rng.random() < 0.8:
                connect(strength, node_id, 1)

    targets = []
    for rgba, name in ((False, "g"), (True, "r")):
        src = pick(rgba)
        if src is not None:
            kind = ref.NodeType.OutputRgba if rgba else ref.NodeType.OutputGray
            out = g.add_node(ref.Node(kind(name)))
            connect(src, out, 0)
            targets.append(int(out))
    return g, inputs, targets


def _reads(pkg, graph_json, inputs, targets, fused, shards=None):
    """`{target: (u8, [f32 planes])}` through one processor and route."""
    if pkg is port:
        mesh = None if shards is None else make_mesh(devices=["cpu"] * shards)
        tp = port.TextureProcessor(100_000_000, device="cpu", mesh=mesh)
        graph = node_graph_from_reference(graph_json)
    else:
        tp = ref.TextureProcessor(100_000_000)
        graph = ref.NodeGraph.from_json(json.loads(graph_json))
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.fuse_subgraphs = fused
            g.set_node_graph(graph)
            # the InputRgba (registered first) reads the first bound input
            for node_id, planes in sorted(inputs.items(), key=lambda kv: len(kv[1]) != 4):
                if pkg is port:
                    planes = planes_from_numpy(planes, "cpu")
                image = (pkg.SlotImage.Gray(planes[0]) if len(planes) == 1
                         else pkg.SlotImage.Rgba(planes))
                g.add_input_slot_data(pkg.SlotData(pkg.NodeId(node_id), pkg.SlotId(0), image))
        out = {}
        for target in targets:
            u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(lg, pkg.NodeId(target), pkg.SlotId(0)))
            sd = lg.slot_data(pkg.NodeId(target), pkg.SlotId(0))
            out[target] = (u8, [np.asarray(p.host_data()) for p in sd.image.planes])
        return out
    finally:
        tp.shutdown_now()


@pytest.mark.parametrize("seed", range(28))
def test_random_graph_every_route_bit_identical(seed):
    graph, inputs, targets = _random_graph(seed, extended=seed >= 16)
    assert targets
    text = json.dumps(graph.to_json())
    want = _reads(ref, text, inputs, targets, fused=True)
    routes = {
        "jax per-node": _reads(ref, text, inputs, targets, fused=False),
        "port fused": _reads(port, text, inputs, targets, fused=True),
        "port per-node": _reads(port, text, inputs, targets, fused=False),
        "port mesh fused": _reads(port, text, inputs, targets, fused=True, shards=2),
        "port mesh per-node": _reads(port, text, inputs, targets, fused=False, shards=2),
    }
    for name, got in routes.items():
        for target in targets:
            (want_u8, want_planes), (got_u8, got_planes) = want[target], got[target]
            assert np.array_equal(got_u8, want_u8), (name, seed, target)
            assert len(got_planes) == len(want_planes), (name, seed, target)
            for a, b in zip(got_planes, want_planes):
                assert a.shape == b.shape, (name, seed, target)
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), (name, seed, target)
