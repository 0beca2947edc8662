"""Voronoi node: seamlessly tiling cellular-noise source.

Port of `kanter_core_tpu/ops/voronoi.py`. One jittered feature point per
lattice cell; each pixel searches its 5×5 cell neighbourhood (exact for
every jitter in [0, 1], as the JAX module proves) for the nearest two
points. Outputs: slot 0 F1 clipped to [0, 1], slot 1 F2 − F1 clipped to
[0, 1], slot 2 the nearest point's cell ID. Plain torch in the JAX
function's order: the same candidate order with strict `<` ties, every
product rounded before its add, and square roots taken in f64 and rounded
once to f32 (torch's f32 `sqrt` on the CPU is not correctly rounded).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from .common import NodePlanes, sqrt_f32
from .noise import _hash01

_SALT_JY = 0x68E31DA4
_SALT_ID = 0xB5297A4D

_OFFSETS = [(dx, dy) for dy in (-2, -1, 0, 1, 2) for dx in (-2, -1, 0, 1, 2)]


def voronoi_bindings(payload) -> dict:
    """The JAX package's `voronoi_bindings`."""
    width, height, cells_x, cells_y, jitter, seed = payload
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": np.float32(np.float64(int(cells_x)) / np.float64(width)),
        "fy": np.float32(np.float64(int(cells_y)) / np.float64(height)),
        "px": np.int32(cells_x),
        "py": np.int32(cells_y),
        "jitter": np.float32(jitter),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
    }


def voronoi_planes(rows, cols, fx, fy, px, py, jitter, seed):
    """`(distance, borders, cells)` planes, each `[len(rows), len(cols)]`."""
    cy = rows.to(torch.float32) + 0.5
    cx = cols.to(torch.float32) + 0.5
    u = cx * float(fx)
    v = cy * float(fy)
    xi = torch.floor(u).to(torch.int32)
    yi = torch.floor(v).to(torch.int32)
    jitter = float(np.float32(jitter))
    seed = int(seed)
    px, py = int(px), int(py)

    def candidate(dx, dy):
        gx = xi + dx
        gy = yi + dy
        wx = torch.remainder(gx, px).to(torch.int64)[None, :]
        wy = torch.remainder(gy, py).to(torch.int64)[:, None]
        jx = _hash01(wx, wy, seed)
        jy = _hash01(wx, wy, seed ^ _SALT_JY)
        cid = _hash01(wx, wy, seed ^ _SALT_ID)
        ox = (jx - 0.5) * jitter
        oy = (jy - 0.5) * jitter
        ddx = ((gx.to(torch.float32) + 0.5) - u)[None, :] + ox
        ddy = ((gy.to(torch.float32) + 0.5) - v)[:, None] + oy
        d2 = ddx * ddx + ddy * ddy
        return d2, cid

    best1, best_id = candidate(*_OFFSETS[0])
    best2 = torch.full_like(best1, float("inf"))
    for off in _OFFSETS[1:]:
        d2, cid = candidate(*off)
        closer = d2 < best1
        best2 = torch.where(closer, best1, torch.minimum(best2, d2))
        best_id = torch.where(closer, cid, best_id)
        best1 = torch.where(closer, d2, best1)
    f1 = sqrt_f32(best1)
    f2 = sqrt_f32(best2)
    distance = torch.clamp(f1, 0.0, 1.0)
    borders = torch.clamp(f2 - f1, 0.0, 1.0)
    return distance, borders, best_id


def voronoi_source(b: dict, place) -> tuple:
    """`(distance, borders, cells)` from the `voronoi_bindings`, made by the
    `common.Placement`."""
    return place.source(
        lambda rows, cols: voronoi_planes(
            rows, cols, b["fx"], b["fy"], b["px"], b["py"], b["jitter"], b["seed"],
        ), b["rows"], b["cols"],
    )


def process(node, place):
    """Per-node: `distance` + `borders` + `cells` Gray SlotDatas at the
    payload size."""
    planes = voronoi_source(voronoi_bindings(node.node_type.payload), place)
    return NodePlanes([], node).outputs([(SlotId(i), [p]) for i, p in enumerate(planes)])
