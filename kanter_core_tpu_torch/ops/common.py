"""Shared op helpers (`vismut_core/src/node/process_shared.rs`)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ids import SlotId


def slot_data_with_name(slot_datas, node, name: str) -> Optional["SlotData"]:
    slot_id = node.input_slot_with_name(name).slot_id
    return slot_data_with_slot_id(slot_datas, slot_id)


def slot_data_with_slot_id(slot_datas, slot_id: SlotId):
    for slot_data in slot_datas:
        if slot_data.slot_id == slot_id:
            return slot_data
    return None


def f32_to_u8(x):
    """THE canonical u8 export conversion — reference semantics
    (`slot_image.rs:142-144`): clamp to [0,1], ×255, NaN→255 (Rust
    f32::min), truncating cast. Plain torch on the plane's device; every u8
    export path uses this one definition."""
    c = torch.clamp(x, 0.0, 1.0)
    v = c * 255.0
    v = torch.where(torch.isnan(v), 255.0, torch.clamp(v, max=255.0))
    return v.to(torch.uint8)
