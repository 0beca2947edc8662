"""Output op.

Port of the Output part of `kanter_core_tpu/ops/inout.py`
(`vismut_core/src/node/output.rs`): the per-node form; the fused evaluator
(`compiler._emit`) handles the same kinds inline. The Value, Input, Image
and Write ops arrive with the per-node path.
"""

from __future__ import annotations

from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import pixel_buffer


def process_output(slot_datas, node):
    """Re-keys its input, or emits a 1×1 black/transparent-black default when
    unconnected (`output.rs:12-33`)."""
    from ..node import NodeTypeKind

    if slot_datas:
        slot_data = slot_datas[0]
        return [SlotData(node.node_id, SlotId(0), slot_data.image)]

    if node.node_type.kind == NodeTypeKind.OUTPUT_RGBA:
        image = SlotImage(
            [pixel_buffer(0.0), pixel_buffer(0.0), pixel_buffer(0.0), pixel_buffer(1.0)]
        )
    elif node.node_type.kind == NodeTypeKind.OUTPUT_GRAY:
        image = SlotImage([pixel_buffer(0.0)])
    else:
        raise AssertionError("output op on a non-output node")
    return [SlotData(node.node_id, SlotId(0), image)]
