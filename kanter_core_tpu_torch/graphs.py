"""Prebuilt graph templates — the "model zoo" of a texture engine.

The reference ships one canonical graph (`data/invert_graph.json`, an
Input→Invert→Output subgraph); these constructors provide that and the other
pipelines exercised by its test suite and benchmarks, ready to wrap in a
`NodeType.Graph` node, evaluate through a `LiveGraph`, or compile with
`compile_graph`.
"""

from __future__ import annotations

from .ids import NodeId, SlotId
from .node import MixType, Node, NodeType, ResizeFilter, ResizePolicy
from .node_graph import NodeGraph
from .slot_data import Size


def invert_graph() -> NodeGraph:
    """Gray inverter subgraph: out = 1.0 − in (the reference's canonical
    nested graph, `data/invert_graph.json` / `integration_tests.rs:991-1071`)."""
    graph = NodeGraph()
    white = graph.add_node(Node(NodeType.Value(1.0)))
    inp = graph.add_node(Node(NodeType.InputGray("in")))
    sub = graph.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(white, sub, SlotId(0), SlotId(0))
    graph.connect(inp, sub, SlotId(0), SlotId(1))
    graph.connect(sub, out, SlotId(0), SlotId(0))
    return graph


def blend_graph(mix_type: MixType = MixType.ADD) -> NodeGraph:
    """Two RGBA inputs blended into one output."""
    graph = NodeGraph()
    a = graph.add_node(Node(NodeType.InputRgba("a")))
    b = graph.add_node(Node(NodeType.InputRgba("b")))
    mix = graph.add_node(Node(NodeType.Mix(mix_type)))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(a, mix, SlotId(0), SlotId(0))
    graph.connect(b, mix, SlotId(0), SlotId(1))
    graph.connect(mix, out, SlotId(0), SlotId(0))
    return graph


def normal_map_graph() -> NodeGraph:
    """RGBA heightmap in → tangent-space normal map out (channel R is the
    height, as in `integration_tests.rs:1349-1384`)."""
    graph = NodeGraph()
    inp = graph.add_node(Node(NodeType.InputRgba("height")))
    sep = graph.add_node(Node(NodeType.SeparateRgba()))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(inp, sep, SlotId(0), SlotId(0))
    graph.connect(sep, h2n, SlotId(0), SlotId(0))
    graph.connect(h2n, out, SlotId(0), SlotId(0))
    return graph


def blur_graph(sigma: float = 1.5) -> NodeGraph:
    """RGBA in → separable toroidal Gaussian blur → RGBA out (extension
    node; see ops/blur.py)."""
    graph = NodeGraph()
    inp = graph.add_node(Node(NodeType.InputRgba("image")))
    blur = graph.add_node(Node(NodeType.Blur(sigma)))
    out = graph.add_node(Node(NodeType.OutputRgba("blurred")))
    graph.connect(inp, blur, SlotId(0), SlotId(0))
    graph.connect(blur, out, SlotId(0), SlotId(0))
    return graph


def channel_shuffle_graph() -> NodeGraph:
    """Separate two RGBA inputs and recombine channels across them
    (`integration_tests.rs:620-674`)."""
    graph = NodeGraph()
    a = graph.add_node(Node(NodeType.InputRgba("a")))
    b = graph.add_node(Node(NodeType.InputRgba("b")))
    sep_a = graph.add_node(Node(NodeType.SeparateRgba()))
    sep_b = graph.add_node(Node(NodeType.SeparateRgba()))
    combine = graph.add_node(Node(NodeType.CombineRgba()))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(a, sep_a, SlotId(0), SlotId(0))
    graph.connect(b, sep_b, SlotId(0), SlotId(0))
    graph.connect(sep_a, combine, SlotId(3), SlotId(0))
    graph.connect(sep_a, combine, SlotId(1), SlotId(1))
    graph.connect(sep_b, combine, SlotId(2), SlotId(2))
    graph.connect(sep_b, combine, SlotId(3), SlotId(3))
    graph.connect(combine, out, SlotId(0), SlotId(0))
    return graph


def deep_chain_graph(
    depth: int = 64,
    nonlinear_every: int = 2,
) -> tuple[NodeGraph, list[NodeId], NodeId, NodeId]:
    """The benchmark workload: 4 gray inputs combined to RGBA, then a
    `depth`-node invert/blend/square chain (squares keep the chain from
    collapsing algebraically). Returns (graph, input_ids, value_id, output_id)."""
    graph = NodeGraph()
    inputs = [graph.add_node(Node(NodeType.InputGray(f"in{i}"))) for i in range(4)]
    combine = graph.add_node(Node(NodeType.CombineRgba()))
    for i, node in enumerate(inputs):
        graph.connect(node, combine, SlotId(0), SlotId(i))
    white = graph.add_node(Node(NodeType.Value(1.0)))
    prev = combine
    for i in range(depth):
        if nonlinear_every and (nonlinear_every == 1 or i % nonlinear_every == 1):
            mix = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
            graph.connect(prev, mix, SlotId(0), SlotId(0))
            graph.connect(prev, mix, SlotId(0), SlotId(1))
        else:
            mix = graph.add_node(
                Node(NodeType.Mix(MixType.ADD if i % 4 == 0 else MixType.SUBTRACT))
            )
            graph.connect(prev, mix, SlotId(0), SlotId(0))
            graph.connect(white, mix, SlotId(0), SlotId(1))
        prev = mix
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(prev, out, SlotId(0), SlotId(0))
    return graph, inputs, white, out


def add_logistic_step(graph: NodeGraph, x: NodeId, one: NodeId, v_val: NodeId) -> NodeId:
    """Append one logistic-map iteration x ← 4v·x·(1−x) to `graph` as 5 Mix
    nodes (invert, multiply, scale-by-v, double, double) and return the new
    chain head. The canonical step for chain builders and demos — the ×4
    comes from two self-ADDs because resize clamps planes to [0,1] and the
    Value must stay ≤ 1 (see `bounded_chain_graph`'s docstring)."""
    inv = graph.add_node(Node(NodeType.Mix(MixType.SUBTRACT)))
    graph.connect(one, inv, SlotId(0), SlotId(0))  # 1 − x (gray chain)
    graph.connect(x, inv, SlotId(0), SlotId(1))
    prod = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    graph.connect(x, prod, SlotId(0), SlotId(0))  # x(1−x)
    graph.connect(inv, prod, SlotId(0), SlotId(1))
    s = graph.add_node(Node(NodeType.Mix(MixType.MULTIPLY)))
    graph.connect(prod, s, SlotId(0), SlotId(0))  # v·x(1−x), stays ≤ 0.25
    graph.connect(v_val, s, SlotId(0), SlotId(1))
    d1 = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    graph.connect(s, d1, SlotId(0), SlotId(0))  # ×2
    graph.connect(s, d1, SlotId(0), SlotId(1))
    d2 = graph.add_node(Node(NodeType.Mix(MixType.ADD)))
    graph.connect(d1, d2, SlotId(0), SlotId(0))  # ×2 → 4v·x(1−x)
    graph.connect(d1, d2, SlotId(0), SlotId(1))
    return d2


def bounded_chain_graph(depth: int = 64) -> tuple[NodeGraph, list[NodeId], NodeId, NodeId]:
    """Benchmark chain that stays numerically alive AND value-sensitive at
    any depth: three per-channel GRAY chains iterating the logistic map
    x ← 4v·x·(1−x) (5 mix nodes per step: invert, multiply, scale-by-v,
    double, double), combined to RGBA at the end with the 4th input as
    alpha. For v≈0.96 (r_eff≈3.85) the map is chaotic on [0,1], so outputs
    cannot saturate to 0/inf (unlike `deep_chain_graph`, whose repeated
    squares collapse by depth ~16) and any perturbation of the v Value node
    provably decorrelates the output — which is what lets a benchmark verify
    per-rep execution by checksum. No compiler can algebraically collapse
    the chain either.

    Two engine semantics shape this construction (see `compiler._emit` /
    `ops/resize.py`): a Mix's LEFT input decides gray/rgba, so the chains
    are gray with the image always on slot 0 when the other operand is the
    1×1 Value; and resize clamps planes to [0,1] (image-0.24.0 parity), so
    the Value must stay ≤ 1 — the ×4 comes from two self-ADDs instead.

    Returns (graph, input_ids, v_value_id, output_id); bind the value in
    (0.89, 1.0) — r_eff = 4v ∈ (3.57, 4) is the chaotic band."""
    graph = NodeGraph()
    inputs = [graph.add_node(Node(NodeType.InputGray(f"in{i}"))) for i in range(4)]
    one = graph.add_node(Node(NodeType.Value(1.0)))
    v_val = graph.add_node(Node(NodeType.Value(0.96)))

    chains = [inputs[0], inputs[1], inputs[2]]
    count = 0
    ch = 0
    while count + 5 <= depth + 4:  # round-robin steps until ~depth mix nodes
        chains[ch] = add_logistic_step(graph, chains[ch], one, v_val)
        added = 5
        count += added
        ch = (ch + 1) % 3
        if count >= depth:
            break
    combine = graph.add_node(Node(NodeType.CombineRgba()))
    for i, node in enumerate(chains):
        graph.connect(node, combine, SlotId(0), SlotId(i))
    graph.connect(inputs[3], combine, SlotId(0), SlotId(3))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(combine, out, SlotId(0), SlotId(0))
    return graph, inputs, v_val, out


def resize_pyramid_graph(sizes=(512, 256, 128, 64), filt: ResizeFilter = ResizeFilter.TRIANGLE) -> NodeGraph:
    """An input downsampled through a pyramid of SpecificSize mix nodes."""
    graph = NodeGraph()
    inp = graph.add_node(Node(NodeType.InputRgba("in")))
    prev = inp
    for size in sizes:
        node = Node(NodeType.Mix(MixType.ADD))
        node.resize_policy = ResizePolicy.SpecificSize(Size(size, size))
        node.resize_filter = filt
        mix = graph.add_node(node)
        graph.connect(prev, mix, SlotId(0), SlotId(0))
        prev = mix
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(prev, out, SlotId(0), SlotId(0))
    return graph
