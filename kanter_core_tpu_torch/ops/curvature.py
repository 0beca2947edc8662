"""Curvature node: gray height → gray convexity mask.

Port of `kanter_core_tpu/ops/curvature.py`: the wrapped ±1 Laplacian in the
fixed association `((h−up)+(h−down))+((h−left)+(h−right))`, scaled by the
strength around 0.5 and clipped to [0, 1]. Plain torch. A row-sharded
plane takes a 1-row ring halo and runs the same math per shard.
"""

from __future__ import annotations

import torch

from ..parallel.sharded import ShardedPlane, map_bands


def curvature_plane(plane, strength):
    """Curvature of one `[H, W]` gray plane (or `ShardedPlane`); `strength`
    is an f32 scalar."""
    if isinstance(plane, ShardedPlane):
        halos = plane.ring_halos(1)
        ups = ShardedPlane(plane.mesh, [
            torch.cat([top, band[:-1]], dim=0) for band, (top, _) in zip(plane.bands, halos)
        ])
        downs = ShardedPlane(plane.mesh, [
            torch.cat([band[1:], bot], dim=0) for band, (_, bot) in zip(plane.bands, halos)
        ])
        return map_bands(lambda p, u, d: _curvature(p, u, d, strength), plane, ups, downs)
    # a roll on a length-1 axis is the identity
    tall = plane.shape[0] > 1
    up = torch.roll(plane, 1, dims=0) if tall else plane
    down = torch.roll(plane, -1, dims=0) if tall else plane
    return _curvature(plane, up, down, strength)


def _curvature(plane, up, down, strength):
    """The Laplacian and remap, given the rows above and below each pixel."""
    wide = plane.shape[1] > 1
    left = torch.roll(plane, 1, dims=1) if wide else plane
    right = torch.roll(plane, -1, dims=1) if wide else plane
    lap = ((plane - up) + (plane - down)) + ((plane - left) + (plane - right))
    return torch.clamp((lap * float(strength)) + 0.5, 0.0, 1.0)
