"""Graph edges.

Mirrors `vismut_core/src/edge.rs:9-57`: an edge connects an output slot of
one node to an input slot of another; `from_arbitrary` normalizes two
(node, side, slot) triples into that orientation.
"""

from __future__ import annotations

import dataclasses

from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .node import Side


@dataclasses.dataclass(frozen=True)
class Edge:
    output_id: NodeId
    input_id: NodeId
    output_slot: SlotId
    input_slot: SlotId

    @staticmethod
    def from_arbitrary(
        a_node: NodeId,
        a_side: Side,
        a_slot: SlotId,
        b_node: NodeId,
        b_side: Side,
        b_slot: SlotId,
    ) -> "Edge":
        if a_node == b_node or a_side == b_side:
            raise TexProError(ErrorKind.GENERIC)
        if a_side == Side.INPUT:
            return Edge(output_id=b_node, input_id=a_node, output_slot=b_slot, input_slot=a_slot)
        return Edge(output_id=a_node, input_id=b_node, output_slot=a_slot, input_slot=b_slot)

    def to_json(self) -> dict:
        return {
            "output_id": int(self.output_id),
            "input_id": int(self.input_id),
            "output_slot": int(self.output_slot),
            "input_slot": int(self.input_slot),
        }

    @staticmethod
    def from_json(data: dict) -> "Edge":
        return Edge(
            output_id=NodeId(data["output_id"]),
            input_id=NodeId(data["input_id"]),
            output_slot=SlotId(data["output_slot"]),
            input_slot=SlotId(data["input_slot"]),
        )
