"""Slot data: a node output keyed by (node id, slot id).

Mirrors `vismut_core/src/slot_data.rs`. `Size` lives in `geometry` and is
re-exported here for API parity; `ChannelPixel` is f32.
"""

from __future__ import annotations

import math

from .geometry import Size  # noqa: F401 — re-export (reference defines Size here)
from .ids import NodeId, SlotId
from .slot_image import SlotImage

ChannelPixel = float  # f32 (`slot_data.rs:32`)


class SlotData:
    __slots__ = ("node_id", "slot_id", "image")

    def __init__(self, node_id: NodeId, slot_id: SlotId, image: SlotImage):
        self.node_id = NodeId(node_id)
        self.slot_id = SlotId(slot_id)
        self.image = image

    def from_self(self) -> "SlotData":
        return SlotData(self.node_id, self.slot_id, self.image.from_self())

    def size(self) -> Size:
        return self.image.size()

    def in_memory(self) -> bool:
        """True when every plane is device-resident (`slot_data.rs:70-78`)."""
        return all(buf.in_memory() for buf in self.image.bufs())

    def __repr__(self):
        return f"SlotData(node={int(self.node_id)}, slot={int(self.slot_id)}, size={self.size()})"


# sRGB scalar helpers (`slot_data.rs:87-110`); the array form is
# `slot_image.srgb_to_linear`.
def linear_to_srgb(value: float) -> float:
    if value <= 0.0:
        return value
    if value <= 0.0031308:
        return value * 12.92
    return 1.055 * math.pow(value, 1.0 / 2.4) - 0.055


def srgb_to_linear(value: float) -> float:
    if value <= 0.0:
        return value
    if value <= 0.04045:
        return value / 12.92
    return math.pow((value + 0.055) / 1.055, 2.4)
