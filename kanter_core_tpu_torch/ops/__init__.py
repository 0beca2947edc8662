"""Node ops as plain functions on torch tensors, and the per-node dispatch.

Each module mirrors its namesake in `kanter_core_tpu/ops/`. The fused
evaluator (`kanter_core_tpu_torch.compiler`) calls their tensor functions
and shared rules; the per-node route (`engine.Engine._dispatch`, taken under
`auto_update` and with `fuse_subgraphs=False`) calls `process_node`, which
mirrors `vismut_core/src/node/node_type.rs:98-138,213-267`: it sorts the
input edges by input slot, places the inputs on the processor's device (row-
sharded over its mesh), resizes mismatched inputs per the node's resize
policy and filter, re-keys them to the consuming node, dispatches on the
node type, and checks the output count against the node's output slots.
Every one of the 26 node kinds has its op; a Graph node runs its nested
graph as a throwaway live graph on the same processor (`graph_op`).

The op modules are imported where they are used: `slot_image` imports
`ops.common`, so this package initializes while the graph model is still
being imported.
"""

from __future__ import annotations

from ..errors import ErrorKind, TexProError


def assign_slot_ids(slot_datas, edges):
    """Re-key producer-keyed slot data to the consuming (node, input slot)
    (`node_type.rs:250-267`)."""
    from ..slot_data import SlotData

    output = []
    for edge in edges:
        for slot_data in slot_datas:
            if edge.output_slot == slot_data.slot_id and edge.output_id == slot_data.node_id:
                output.append(SlotData(edge.input_id, edge.input_slot, slot_data.image))
                break
        else:
            raise TexProError(ErrorKind.NO_SLOT_DATA)
    return output


def process_node_internal(node, slot_datas, embedded_slot_datas, input_slot_datas, place,
                          tex_pro):
    """The node's output slot datas from its re-keyed inputs; `place` is the
    processor's `common.Placement`, `tex_pro` the processor (a Graph node
    runs its nested graph there)."""
    from ..node import NodeTypeKind
    from . import (
        ambient_occlusion, blur, curvature, distance, embed, gradient, graph_op,
        height_to_normal, hsv, inout, levels, mix, noise, pattern, ramp,
        separate_combine, transform, voronoi, warp,
    )

    kind = node.node_type.kind
    payload = node.node_type.payload
    K = NodeTypeKind

    if kind == K.INPUT_RGBA:
        output = inout.process_input_rgba(node, input_slot_datas)
    elif kind == K.INPUT_GRAY:
        output = inout.process_input_gray(node, input_slot_datas)
    elif kind in (K.OUTPUT_RGBA, K.OUTPUT_GRAY):
        output = inout.process_output(slot_datas, node, place)
    elif kind == K.GRAPH:
        output = graph_op.process(slot_datas, node, tex_pro)
    elif kind == K.IMAGE:
        output = inout.process_image(node, payload, place)
    elif kind == K.EMBED:
        output = embed.process(node, embedded_slot_datas, payload)
    elif kind == K.WRITE:
        output = inout.process_write(slot_datas, payload)
    elif kind == K.VALUE:
        output = inout.process_value(node, payload, place.device)
    elif kind == K.MIX:
        output = mix.process(slot_datas, node, payload, place)
    elif kind == K.HEIGHT_TO_NORMAL:
        output = height_to_normal.process(slot_datas, node)
    elif kind == K.CURVATURE:
        output = curvature.process(slot_datas, node)
    elif kind == K.AMBIENT_OCCLUSION:
        output = ambient_occlusion.process(slot_datas, node)
    elif kind == K.DISTANCE:
        output = distance.process(slot_datas, node)
    elif kind == K.HSV:
        output = hsv.process(slot_datas, node)
    elif kind == K.BLUR:
        output = blur.process(slot_datas, node, payload)
    elif kind == K.LEVELS:
        output = levels.process(slot_datas, node)
    elif kind == K.NOISE:
        output = noise.process(node, place)
    elif kind == K.PATTERN:
        output = pattern.process(node, place)
    elif kind == K.VORONOI:
        output = voronoi.process(node, place)
    elif kind == K.RAMP:
        output = ramp.process(node, place)
    elif kind == K.GRADIENT_MAP:
        output = gradient.process(slot_datas, node)
    elif kind == K.TRANSFORM:
        output = transform.process(slot_datas, node)
    elif kind == K.WARP:
        output = warp.process(slot_datas, node)
    elif kind == K.SEPARATE_RGBA:
        output = separate_combine.process_separate(slot_datas, node, place)
    elif kind == K.COMBINE_RGBA:
        output = separate_combine.process_combine(slot_datas, node, place)
    else:
        raise TexProError(ErrorKind.INVALID_NODE_TYPE, f"no op for {node.node_type!r}")

    if kind not in (K.OUTPUT_GRAY, K.OUTPUT_RGBA) and len(output) != len(node.output_slots()):
        raise TexProError(
            ErrorKind.INVALID_BUFFER_COUNT,
            f"{len(output)} output buffers for {len(node.output_slots())} output slots "
            f"on {node.node_type!r}",
        )
    return output


def _place_inputs(slot_datas, place):
    """Every input plane where the processor keeps its planes: on its
    device, row-sharded over its mesh where the rows shard (the JAX
    package's `_shard_inputs`). A plane already placed keeps its
    PlaneBuffer, so committed outputs flow through with their aliasing;
    only leaves bound elsewhere (an input image in host memory) are
    copied."""
    from ..slot_data import SlotData
    from ..slot_image import SlotImage
    from ..transient_buffer import plane_from_device

    out = []
    for slot_data in slot_datas:
        planes, changed = [], False
        for buf in slot_data.image.planes:
            data = buf.data()
            placed = place.place(data)
            if placed is not data:
                buf, changed = plane_from_device(placed), True
            planes.append(buf)
        out.append(
            SlotData(slot_data.node_id, slot_data.slot_id, SlotImage(planes))
            if changed else slot_data
        )
    return out


def process_node(node, slot_datas, embedded_slot_datas, input_slot_datas, edges, tex_pro):
    """One node of the per-node route, on `tex_pro`'s device or mesh."""
    from .common import Placement
    from .resize import resize_buffers

    assert len(edges) == len(slot_datas), f"NodeType: {node.node_type!r}"

    edges = sorted(edges, key=lambda e: e.input_slot)
    place = Placement(tex_pro.device, tex_pro.mesh)
    slot_datas = _place_inputs(slot_datas, place)
    slot_datas = resize_buffers(
        slot_datas, edges, node.resize_policy, node.resize_filter, tex_pro.mesh
    )
    slot_datas = assign_slot_ids(slot_datas, edges)
    return process_node_internal(
        node, slot_datas, embedded_slot_datas, input_slot_datas, place, tex_pro
    )
