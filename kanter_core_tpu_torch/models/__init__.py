"""Material pipelines: multi-output graph templates for PBR texture maps.

Port of the `ambient_occlusion_graph` and `pbr_material_graph` templates of
`kanter_core_tpu/models/__init__.py` (the other templates need ops that are
not yet ported). They compose the engine's node vocabulary (Mix, Blur,
HeightToNormal, CombineRgba) into height→material pipelines with multiple
named outputs. All math happens in the graph, so the pipelines inherit
everything the engine gives graphs: incremental dirty re-eval of single
maps, fused evaluation, and recipe-cache hits on parameter undo.
"""


from __future__ import annotations

from ..ids import NodeId, SlotId
from ..node import MixType, Node, NodeType
from ..node_graph import NodeGraph


def _value(graph: NodeGraph, v: float) -> NodeId:
    return graph.add_node(Node(NodeType.Value(v)))


def _mix(graph: NodeGraph, mix_type: MixType, left: NodeId, right: NodeId,
         left_slot: SlotId = SlotId(0), right_slot: SlotId = SlotId(0)) -> NodeId:
    node = graph.add_node(Node(NodeType.Mix(mix_type)))
    graph.connect(left, node, left_slot, SlotId(0))
    graph.connect(right, node, right_slot, SlotId(1))
    return node


def ambient_occlusion_graph(sigma: float = 6.0, strength: float = 0.75) -> NodeGraph:
    """Gray heightmap in → screen-space-style AO approximation out.

    Local concavity: `ao = 1 − strength·(blur_σ(h) − h)` (unclamped in f32;
    ridges where blur(h) < h exceed 1.0 until u8 export clamps) — cavities
    (where the neighborhood average exceeds the height) darken, ridges stay
    white. Mix clamps to [0, 1] exactly like the reference's kernels
    (`mix.rs:136-192` operates on raw f32; the clamp comes from the u8
    export and the SUBTRACT's consumers here keep values in range).
    """
    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))
    blur = graph.add_node(Node(NodeType.Blur(sigma)))
    graph.connect(height, blur, SlotId(0), SlotId(0))
    # cavity = blur(h) - h  (negative on ridges; SUBTRACT keeps raw f32)
    cavity = _mix(graph, MixType.SUBTRACT, blur, height)
    # scaled = cavity * strength
    scaled = _mix(graph, MixType.MULTIPLY, cavity, _value(graph, strength))
    # ao = 1 - scaled  (ridges: scaled < 0 → ao > 1, clamped at u8 export,
    # and by the resize clamp if consumed at another size — reference parity)
    ao = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), scaled,
              right_slot=SlotId(0))
    out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, out, SlotId(0), SlotId(0))
    return graph


def pbr_material_graph(
    normal_pre_sigma: float = 0.8,
    ao_sigma: float = 6.0,
    ao_strength: float = 0.75,
    roughness_base: float = 0.35,
    roughness_cavity: float = 0.5,
) -> NodeGraph:
    """Gray heightmap in → four PBR texture maps out, one graph:

    - `normal`  (RGBA): pre-blurred height → tangent-space normal map;
    - `ao`      (gray): cavity AO, `1 − k·(blur(h) − h)` (f32-unclamped);
    - `roughness` (gray): `base + cavity_weight·(1 − ao)` — cavities are
      rougher (dirt/wear accumulates there);
    - `albedo`  (RGBA): height-tinted base color (height-lerped channels).

    The whole material is ONE dirty-tracked graph: editing `ao_sigma`
    re-evaluates only the AO/roughness branch; the engine fuses whatever is
    dirty into a single evaluation per read. Embed it as a `Graph` node to
    stamp materials inside larger compositions.
    """
    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))

    # --- normal branch ---
    pre = graph.add_node(Node(NodeType.Blur(normal_pre_sigma)))
    graph.connect(height, pre, SlotId(0), SlotId(0))
    h2n = graph.add_node(Node(NodeType.HeightToNormal()))
    graph.connect(pre, h2n, SlotId(0), SlotId(0))
    normal_out = graph.add_node(Node(NodeType.OutputRgba("normal")))
    graph.connect(h2n, normal_out, SlotId(0), SlotId(0))

    # --- ao branch: 1 - strength * (blur(h) - h) ---
    ao_blur = graph.add_node(Node(NodeType.Blur(ao_sigma)))
    graph.connect(height, ao_blur, SlotId(0), SlotId(0))
    cavity = _mix(graph, MixType.SUBTRACT, ao_blur, height)
    scaled = _mix(graph, MixType.MULTIPLY, cavity, _value(graph, ao_strength))
    ao = _mix(graph, MixType.SUBTRACT, _value(graph, 1.0), scaled)
    ao_out = graph.add_node(Node(NodeType.OutputGray("ao")))
    graph.connect(ao, ao_out, SlotId(0), SlotId(0))

    # --- roughness branch: base + cavity_weight * (1 - ao) = base + cw*scaled
    rough = _mix(
        graph, MixType.ADD,
        _mix(graph, MixType.MULTIPLY, scaled, _value(graph, roughness_cavity)),
        _value(graph, roughness_base),
    )
    rough_out = graph.add_node(Node(NodeType.OutputGray("roughness")))
    graph.connect(rough, rough_out, SlotId(0), SlotId(0))

    # --- albedo branch: per-channel lerp between two tints by height ---
    # channel = low + h * (high - low), expressed with Value nodes so tint
    # edits are argument swaps of the cached evaluator
    low = (0.22, 0.17, 0.12)   # cavity tint
    high = (0.58, 0.52, 0.45)  # ridge tint
    channels = []
    for lo, hi in zip(low, high):
        span = _mix(graph, MixType.MULTIPLY, height, _value(graph, hi - lo))
        channels.append(_mix(graph, MixType.ADD, span, _value(graph, lo)))
    combine = graph.add_node(Node(NodeType.CombineRgba()))
    for i, ch in enumerate(channels):
        graph.connect(ch, combine, SlotId(0), SlotId(i))
    albedo_out = graph.add_node(Node(NodeType.OutputRgba("albedo")))
    graph.connect(combine, albedo_out, SlotId(0), SlotId(0))

    return graph
