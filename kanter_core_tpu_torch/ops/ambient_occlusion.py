"""AmbientOcclusion node: gray height → gray AO mask.

Port of `kanter_core_tpu/ops/ambient_occlusion.py`:

    occ = Σ_i max(0, blur_{σ_i}(h) − h)     σ_i = r, 2r, 4r (in that order)
    ao  = clip(1 − (strength·⅓)·occ, 0, 1)

The three wrap blurs go through `ops/blur.blur_plane`, so on a CUDA tensor
they are three launches of the blur kernel (`csrc/blur.cu`); the shared
weight folds into the strength scalar on the host (one f32 rounding) before
the one plane multiply, as in the JAX combine. A row-sharded height takes
three sharded blurs (`blur.blur_plane_sharded`) and the combine per shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import map_bands
from .blur import blur_plane

AO_SCALE_FACTORS = (1.0, 2.0, 4.0)
AO_SCALE_WEIGHT = np.float32(1.0 / 3.0)


def ao_sigmas(radius: float) -> tuple:
    """The three blur sigmas for a base radius, rounded like Blur's."""
    return tuple(round(float(radius) * f, 6) for f in AO_SCALE_FACTORS)


def ao_combine(center: torch.Tensor, blurred, strength) -> torch.Tensor:
    """The elementwise combine: occlusions summed in order, then one
    multiply by the folded strength."""
    occ = None
    for b in blurred:
        o = torch.clamp(b - center, min=0.0)
        occ = o if occ is None else occ + o
    st = float(np.float32(np.float32(strength) * AO_SCALE_WEIGHT))
    return torch.clamp(1.0 - occ * st, 0.0, 1.0)


def ao_plane(plane, strength, radius: float):
    """AO of one `[H, W]` gray plane (or `ShardedPlane`)."""
    blurred = [blur_plane(plane, s) for s in ao_sigmas(radius)]
    return map_bands(lambda c, *b: ao_combine(c, b, strength), plane, *blurred)
