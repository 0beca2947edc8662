"""Ramp node: procedural gradient source (Linear, Radial, Box).

Port of `kanter_core_tpu/ops/ramp.py`. One Gray plane in [0, 1] over the
normalized canvas coordinates `((col+0.5)/W, (row+0.5)/H)`; cos/sin of the
angle come from the host in f64 with one rounding (quarter turns from an
exact table). Plain torch in the JAX function's op order; Radial's root is
taken in f64 and rounded once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from .common import NodePlanes, sqrt_f32
from .transform import _QUARTER


def ramp_bindings(payload) -> dict:
    """The JAX package's `ramp_bindings`: index vectors, f32 reciprocal
    extents and the `[cos, sin, cx, cy, scale]` vector."""
    width, height, _kind, angle, cx, cy, scale = payload
    d = float(angle) % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "iw": np.float32(np.float64(1.0) / np.float64(int(width))),
        "ih": np.float32(np.float64(1.0) / np.float64(int(height))),
        "k": np.asarray([cos, sin, cx, cy, scale], np.float32),
    }


def ramp_plane(kind, rows, cols, iw, ih, k) -> torch.Tensor:
    """Gradient plane `[len(rows), len(cols)]` of the ramp `kind`."""
    cos, sin, cx, cy, scale = (float(x) for x in np.asarray(k, np.float32))
    u = (cols.to(torch.float32) + 0.5) * float(iw)
    v = (rows.to(torch.float32) + 0.5) * float(ih)
    du = (u - cx)[None, :]
    dv = (v - cy)[:, None]
    if kind == "Linear":
        proj = du * cos + dv * sin
        t = (proj * scale) + 0.5
    elif kind == "Radial":
        d = sqrt_f32(du * du + dv * dv)
        t = (d + d) * scale
    else:  # Box
        m = torch.maximum(du.abs().expand(dv.shape[0], du.shape[1]), dv.abs())
        t = (m + m) * scale
    return torch.clamp(t, 0.0, 1.0)


def ramp_source(kind, b: dict, place):
    """The plane from the `ramp_bindings` and the ramp `kind` (structure),
    made by the `common.Placement`."""
    return place.source(
        lambda rows, cols: ramp_plane(kind, rows, cols, b["iw"], b["ih"], b["k"]),
        b["rows"], b["cols"],
    )


def process(node, place):
    """Per-node: one Gray SlotData at the payload size."""
    payload = node.node_type.payload
    plane = ramp_source(payload[2], ramp_bindings(payload), place)
    return NodePlanes([], node).outputs([(SlotId(0), [plane])])
