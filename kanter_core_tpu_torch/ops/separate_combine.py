"""SeparateRgba / CombineRgba: zero-copy plane aliasing ops.

Port of `kanter_core_tpu/ops/separate_combine.py`, mirroring `vismut_core/src/node/separate_rgba.rs` and `combine_rgba.rs`.
These never touch pixel data: Separate re-exposes the four RGBA planes as four
Gray outputs by sharing the plane buffers (`separate_rgba.rs:38-68`); Combine
assembles four optional Gray inputs into one RGBA image where missing color
channels share a single lazily-created 0.0 plane and missing alpha gets a 1.0
plane (`combine_rgba.rs:30-73`). `separate_planes` and `combine_planes` are
the rules on plane lists; the fused evaluator (`compiler._emit`) and the
per-node forms both call them.
"""

from __future__ import annotations

from ..errors import ErrorKind, TexProError
from ..ids import SlotId
from .common import NodePlanes


def separate_planes(planes, place) -> list:
    """The four Gray outputs' planes: the RGBA input's planes, or four
    independent 1×1 zero planes for a Gray or missing input
    (`separate_rgba.rs:13-36`)."""
    if planes is not None and len(planes) == 4:
        return [[p] for p in planes]
    return [[place.full((1, 1), 0.0)] for _ in range(4)]


def combine_planes(by_slot: dict, place) -> list:
    """The RGBA planes of four optional Gray inputs by input slot (red,
    green, blue, alpha); an RGBA input is an `INVALID_SLOT_TYPE` error
    (`combine_rgba.rs:22-25`)."""
    if by_slot:
        h, w = by_slot[min(by_slot)][0].shape[-2:]
    else:
        h, w = 1, 1
    shared_zero = None

    def plane_of(slot):
        planes = by_slot.get(SlotId(slot))
        if planes is not None and len(planes) == 4:
            raise TexProError(
                ErrorKind.INVALID_SLOT_TYPE,
                "RGBA image connected to a CombineRgba input slot",
            )
        return None if planes is None else planes[0]

    colors = []
    for slot in range(3):
        plane = plane_of(slot)
        if plane is None:
            if shared_zero is None:
                shared_zero = place.full((h, w), 0.0)
            plane = shared_zero
        colors.append(plane)
    alpha = plane_of(3)
    if alpha is None:
        alpha = place.full((h, w), 1.0)
    return [*colors, alpha]


def process_separate(slot_datas, node, place):
    io = NodePlanes(slot_datas, node)
    outs = separate_planes(io.named("input"), place)
    return io.outputs([(SlotId(i), planes) for i, planes in enumerate(outs)])


def process_combine(slot_datas, node, place):
    io = NodePlanes(slot_datas, node)
    return io.outputs([(SlotId(0), combine_planes(io.by_slot(), place))])
