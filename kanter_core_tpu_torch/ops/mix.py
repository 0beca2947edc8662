"""Mix op: the elementwise blend of two planes.

Port of `kanter_core_tpu/ops/mix.py` (`vismut_core/src/node/mix.rs`). IEEE
f32 semantics are kept exactly (divide-by-zero produces ±inf/NaN, which the
reference goldens encode; `mix.rs:179`). Each mode keeps `_binary`'s
association: every product and sum is a separate torch op, so each rounds
on its own — eager torch never contracts a product into its consumer's add
(never use the fused forms `alpha=`, `lerp` or `addcmul` here). Division is
tensor by tensor, which is IEEE division on every device.

POW is the reference's f32 pow on the planes' device
(`exact_math.pow_f32`): glibc `powf` on the CPU, `ds_pow` on a card.

`mix_images` holds the node's rules on plane lists (a missing side is a 0.0
image of the other side's size and type, a missing pair a 1×1 Gray 0.0, the
right side coerced to the left's type, an RGBA result's alpha 1); the fused
evaluator and the per-node `process` both call it.
"""

from __future__ import annotations

import torch

from ..geometry import Size
from ..ids import SlotId
from ..node import MixType
from ..parallel.sharded import map_bands
from .common import NodePlanes, as_type
from .exact_math import pow_f32


def _screen(l, r):
    # 1 − (1−l)(1−r), formulated as l + (1−l)·r
    return l + (1.0 - l) * r


def _overlay(l, r):
    lo = (l * r) * 2.0  # power-of-two scale: exact
    hi = 1.0 - ((1.0 - l) * (1.0 - r)) * 2.0
    return torch.where(l < 0.5, lo, hi)


_OPS = {
    MixType.ADD: lambda l, r: l + r,
    MixType.SUBTRACT: lambda l, r: l - r,
    MixType.MULTIPLY: lambda l, r: l * r,
    MixType.DIVIDE: lambda l, r: l / r,
    MixType.POW: pow_f32,
    MixType.DARKEN: torch.minimum,
    MixType.LIGHTEN: torch.maximum,
    MixType.DIFFERENCE: lambda l, r: torch.abs(l - r),
    MixType.SCREEN: _screen,
    MixType.OVERLAY: _overlay,
}


def _binary(mix_type: MixType):
    """The per-plane function of a Mix mode, on two same-shape f32 tensors."""
    return _OPS[mix_type]


def _size(planes) -> Size:
    h, w = planes[0].shape[-2:]
    return Size(w, h)


def mix_images(mix_type: MixType, left, right, place) -> list:
    """The output planes of a Mix of the `left` and `right` plane lists
    (either may be None); constants are made by the `common.Placement`."""
    op = _binary(mix_type)
    if left is not None:
        rgba = len(left) == 4
        right = (
            as_type(right, rgba) if right is not None
            else place.from_value(_size(left), 0.0, rgba)
        )
    elif right is not None:
        left = place.from_value(_size(right), 0.0, len(right) == 4)
    else:
        return [place.full((1, 1), 0.0)]
    if len(left) == 4:
        planes = [map_bands(op, left[i], right[i]) for i in range(3)]
        planes.append(map_bands(torch.ones_like, planes[0]))
        return planes
    return [map_bands(op, left[0], right[0])]


def process(slot_datas, node, mix_type: MixType, place):
    io = NodePlanes(slot_datas, node)
    planes = mix_images(mix_type, io.named("left"), io.named("right"), place)
    return io.outputs([(SlotId(0), planes)])
