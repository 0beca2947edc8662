"""SeparateRgba / CombineRgba: zero-copy plane aliasing ops.

Port of `kanter_core_tpu/ops/separate_combine.py`, mirroring `vismut_core/src/node/separate_rgba.rs` and `combine_rgba.rs`.
These never touch pixel data: Separate re-exposes the four RGBA planes as four
Gray outputs by sharing the plane buffers (`separate_rgba.rs:38-68`); Combine
assembles four optional Gray inputs into one RGBA image where missing color
channels share a single lazily-created 0.0 plane and missing alpha gets a 1.0
plane (`combine_rgba.rs:30-73`). These are the per-node forms; the fused
evaluator (`compiler._emit`) selects the same planes inline.
"""

from __future__ import annotations

import numpy as np

from ..errors import ErrorKind, TexProError
from ..geometry import Size
from ..ids import SlotId
from ..slot_data import SlotData
from ..slot_image import SlotImage
from ..transient_buffer import pixel_buffer, plane_from_host
from .common import slot_data_with_name


def process_separate(slot_datas, node):
    if slot_datas:
        slot_data = slot_datas[0]
        if slot_data.image.is_rgba():
            return [
                SlotData(node.node_id, SlotId(i), SlotImage([slot_data.image.planes[i]]))
                for i in range(4)
            ]
    # unconnected default: four independent 1×1 zero planes (`separate_rgba.rs:13-36`)
    return [SlotData(node.node_id, SlotId(i), SlotImage([pixel_buffer(0.0)])) for i in range(4)]


def process_combine(slot_datas, node):
    size = slot_datas[0].size() if slot_datas else Size(1, 1)

    named = [
        slot_data_with_name(slot_datas, node, name)
        for name in ("red", "green", "blue", "alpha")
    ]

    shared_zero = None  # missing color channels share one zero plane

    def color_plane(slot_data):
        nonlocal shared_zero
        if slot_data is not None:
            if slot_data.image.is_rgba():
                raise TexProError(
                    ErrorKind.INVALID_SLOT_TYPE,
                    "RGBA image connected to a CombineRgba input slot",
                )
            return slot_data.image.planes[0]
        if shared_zero is None:
            shared_zero = plane_from_host(
                np.zeros((size.height, size.width), dtype=np.float32)
            )
        return shared_zero

    def alpha_plane(slot_data):
        if slot_data is not None:
            if slot_data.image.is_rgba():
                raise TexProError(
                    ErrorKind.INVALID_SLOT_TYPE,
                    "RGBA image connected to a CombineRgba input slot",
                )
            return slot_data.image.planes[0]
        return plane_from_host(np.ones((size.height, size.width), dtype=np.float32))

    image = SlotImage(
        [
            color_plane(named[0]),
            color_plane(named[1]),
            color_plane(named[2]),
            alpha_plane(named[3]),
        ]
    )
    return [SlotData(node.node_id, SlotId(0), image)]
