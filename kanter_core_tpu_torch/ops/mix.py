"""Mix op: the elementwise blend of two planes.

Port of `kanter_core_tpu/ops/mix.py` (`vismut_core/src/node/mix.rs`). IEEE
f32 semantics are kept exactly (divide-by-zero produces ±inf/NaN, which the
reference goldens encode; `mix.rs:179`). Each mode keeps `_binary`'s
association: every product and sum is a separate torch op, so each rounds
on its own — eager torch never contracts a product into its consumer's add
(never use the fused forms `alpha=`, `lerp` or `addcmul` here). Division is
tensor by tensor, which is IEEE division on every device.

POW is not yet ported: `torch.pow` does not reproduce glibc `powf`, which the
reference's CPU path is, so it raises a `NODE_PROCESSING` error.
"""

from __future__ import annotations

import torch

from ..errors import ErrorKind, TexProError
from ..node import MixType


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
    MixType.DARKEN: torch.minimum,
    MixType.LIGHTEN: torch.maximum,
    MixType.DIFFERENCE: lambda l, r: torch.abs(l - r),
    MixType.SCREEN: _screen,
    MixType.OVERLAY: _overlay,
}


def _binary(mix_type: MixType):
    """The per-plane function of a Mix mode, on two same-shape f32 tensors."""
    op = _OPS.get(mix_type)
    if op is None:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"Mix {mix_type.value} is not yet ported"
        )
    return op
