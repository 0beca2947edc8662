"""HeightToNormal: gray heightmap → RGBA tangent-space normal map.

Port of `kanter_core_tpu/ops/height_to_normal.py`
(`vismut_core/src/node/height_to_normal.rs`): toroidal-wrap finite
differences sampling up (y-1) and left (x-1) (`height_to_normal.rs:55-56`),
tangent/bitangent normalization and cross product in nalgebra's operation
order (`norm = sqrt((x² + y²) + z²)`, componentwise divide), remapped as
`n * 0.5 + 0.5`, alpha forced to 1.

Plain torch; the JAX package keeps no kernel for this op either. A
row-sharded height (`TextureProcessor(mesh=...)`) takes a 1-row ring halo
and runs the same math per shard with the canvas's global height and width. Exactness
on every device rests on four rules:

- square roots go through f64 (`common.sqrt_f32`): torch's f32 `sqrt` on
  the CPU is not correctly rounded (measured: 7,281 of 1e6 random inputs off by one ulp
  against numpy, torch 2.13 AVX-512), while an f64 square root rounded to
  f32 is (53 ≥ 2·24 + 2 bits, so the double rounding is innocuous);
- tensor-by-tensor division is IEEE division on the CPU and on CUDA;
- a scalar numerator or divisor is expanded to a full tensor first
  (`scalar / tensor` in torch is `reciprocal(tensor) * scalar`, and a scalar
  divisor may become a reciprocal multiply on CUDA — both round
  differently);
- the texel steps `1/width` and `1/height` and their squares are computed on
  the host in numpy f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.sharded import ShardedPlane, map_bands
from ..ids import SlotId
from .common import NodePlanes, gray_input, sqrt_f32

f32 = np.float32


def _h2n_core(h: torch.Tensor, up: torch.Tensor, height: int, width: int):
    """The per-pixel normal math given the pre-gathered `up` rows; `height`
    and `width` are the canvas dims (they set the texel step,
    `height_to_normal.rs:49-52`)."""
    pdx = f32(1.0) / f32(width)
    pdy = f32(1.0) / f32(height)
    # sample at (x-1, y) wrapped; identity on a single-column plane
    left = h if h.shape[-1] == 1 else torch.roll(h, 1, dims=-1)

    def full(value) -> torch.Tensor:
        return torch.full_like(h, float(value))

    # tangent = normalize([pdx, 0, h - left])
    tz = h - left
    tnorm = sqrt_f32(float(f32(pdx * pdx) + f32(0.0)) + tz * tz)
    tx, ty, tzn = full(pdx) / tnorm, full(0.0) / tnorm, tz / tnorm

    # bitangent = normalize([0, pdy, up - h])
    bz = up - h
    bnorm = sqrt_f32(float(f32(0.0) + f32(pdy * pdy)) + bz * bz)
    bx, by, bzn = full(0.0) / bnorm, full(pdy) / bnorm, bz / bnorm

    # normal = normalize(cross(tangent, bitangent))
    cx = ty * bzn - tzn * by
    cy = tzn * bx - tx * bzn
    cz = tx * by - ty * bx
    cnorm = sqrt_f32((cx * cx + cy * cy) + cz * cz)
    nx, ny, nz = cx / cnorm, cy / cnorm, cz / cnorm

    return (
        nx * 0.5 + 0.5,
        ny * 0.5 + 0.5,
        nz * 0.5 + 0.5,
        torch.ones_like(h),
    )


def h2n_planes(h):
    """`[H, W]` height → the four `[H, W]` planes of the normal map (four
    `[B, H, W]` batches for a batch of heights, four `ShardedPlane`s for a
    sharded height)."""
    if isinstance(h, ShardedPlane):
        height, width = h.shape
        ups = ShardedPlane(h.mesh, [
            torch.cat([top, band[:-1]], dim=0)  # row y−1, wrapped
            for band, (top, _bot) in zip(h.bands, h.ring_halos(1))
        ])
        return map_bands(lambda b, up: _h2n_core(b, up, height, width), h, ups)
    # roll on a length-1 axis is the identity
    up = h if h.shape[-2] == 1 else torch.roll(h, 1, dims=-2)
    return _h2n_core(h, up, *h.shape[-2:])


def process(slot_datas, node):
    io = NodePlanes(slot_datas, node)
    height = gray_input(io.named("input"), "HeightToNormal")  # `height_to_normal.rs:39-43`
    return io.outputs([(SlotId(0), list(h2n_planes(height)))])
