"""Curvature node: gray height → gray convexity mask.

Port of `kanter_core_tpu/ops/curvature.py`: the wrapped ±1 Laplacian in the
fixed association `((h−up)+(h−down))+((h−left)+(h−right))`, scaled by the
strength around 0.5 and clipped to [0, 1]. Plain torch.
"""

from __future__ import annotations

import torch


def curvature_plane(plane: torch.Tensor, strength) -> torch.Tensor:
    """Curvature of one `[H, W]` gray plane; `strength` is an f32 scalar."""
    # a roll on a length-1 axis is the identity
    tall, wide = plane.shape[0] > 1, plane.shape[1] > 1
    up = torch.roll(plane, 1, dims=0) if tall else plane
    down = torch.roll(plane, -1, dims=0) if tall else plane
    left = torch.roll(plane, 1, dims=1) if wide else plane
    right = torch.roll(plane, -1, dims=1) if wide else plane
    lap = ((plane - up) + (plane - down)) + ((plane - left) + (plane - right))
    return torch.clamp((lap * float(strength)) + 0.5, 0.0, 1.0)
