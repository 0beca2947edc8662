"""Embed op: cross-graph data transfer by id.

Mirrors `vismut_core/src/node/embed.rs`: a `SlotData` registered on a
LiveGraph under an `EmbeddedSlotDataId` is re-exposed as a node output —
here a cached device-tensor handle, no copy.
"""

from __future__ import annotations

from ..errors import ErrorKind, TexProError
from ..ids import SlotId
from ..slot_data import SlotData


class EmbeddedSlotDataId(int):
    __slots__ = ()

    def __repr__(self) -> str:
        return f"EmbeddedSlotDataId({int(self)})"


class EmbeddedSlotData:
    __slots__ = ("slot_data_id", "slot_id", "image")

    def __init__(self, slot_data_id: EmbeddedSlotDataId, slot_id, image):
        self.slot_data_id = slot_data_id
        self.slot_id = slot_id
        self.image = image

    @staticmethod
    def from_slot_data(slot_data: SlotData, slot_data_id: EmbeddedSlotDataId) -> "EmbeddedSlotData":
        return EmbeddedSlotData(slot_data_id, slot_data.slot_id, slot_data.image)


def process(node, embedded_slot_datas, embedded_slot_data_id: EmbeddedSlotDataId):
    for esd in embedded_slot_datas:
        if esd.slot_data_id == embedded_slot_data_id:
            return [SlotData(node.node_id, SlotId(0), esd.image)]
    raise TexProError(ErrorKind.NODE_PROCESSING)
