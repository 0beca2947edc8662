"""Hsv node: hue/saturation/value adjust.

Port of `kanter_core_tpu/ops/hsv.py`. RGB → hexcone HSV (ties in r→g→b
order), shift the hue by whole sectors, scale and clip saturation and
value, back to RGB through the same select tree; a gray image is only
value-scaled. Alpha passes through by alias. Plain torch in the JAX
function's op order; every division is by a full tensor. Row-sharded
planes are adjusted shard by shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from ..parallel.sharded import ShardedPlane, map_bands
from .common import NodePlanes, connected_input


def hsv_bindings(payload) -> np.ndarray:
    """`(shift6, sat, val)`: the degree shift normalized to sectors in f64
    on the host, one rounding to f32 (the JAX package's `hsv_bindings`)."""
    hue_deg, sat, val = payload
    shift6 = (np.float64(hue_deg) % 360.0 + 360.0) % 360.0 / 60.0
    return np.asarray([np.float32(shift6), np.float32(sat), np.float32(val)],
                      np.float32)


def hsv_planes(planes, params) -> list:
    """Adjust a 1- or 4-plane pixel stack; `params` from `hsv_bindings`.
    Returns as many planes; plane 3 (alpha) is the input's tensor."""
    if any(isinstance(p, ShardedPlane) for p in planes):
        colors = planes[:1] if len(planes) == 1 else planes[:3]
        out = list(map_bands(lambda *ps: tuple(hsv_planes(ps, params)), *colors))
        return out + list(planes[3:])
    shift6, sat, val = (float(x) for x in np.asarray(params, np.float32))
    if len(planes) == 1:
        return [torch.clamp(planes[0] * val, 0.0, 1.0)]

    r, g, b = planes[0], planes[1], planes[2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    delta = maxc - minc

    zero = torch.zeros_like(delta)
    safe = torch.where(delta == 0.0, 1.0, delta)
    h6 = torch.where(
        delta == 0.0,
        zero,
        torch.where(
            maxc == r,
            (g - b) / safe,
            torch.where(maxc == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe),
        ),
    )
    h6 = torch.where(h6 < 0.0, h6 + 6.0, h6)

    s = torch.where(maxc == 0.0, zero, delta / maxc)

    hh = h6 + shift6
    hh = torch.where(hh >= 6.0, hh - 6.0, hh)
    ss = torch.clamp(s * sat, 0.0, 1.0)
    vv = torch.clamp(maxc * val, 0.0, 1.0)

    sec = torch.floor(hh)
    # NaN → sector 0 before the cast, as XLA's saturating conversion gives
    i = torch.clamp(torch.where(torch.isnan(sec), 0.0, sec).to(torch.int32), 0, 5)
    f = hh - sec
    p = vv * (1.0 - ss)
    q = vv * (1.0 - ss * f)
    t = vv * (1.0 - ss * (1.0 - f))

    def pick(table):
        out = table[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, table[k], out)
        return out

    out = [
        pick((vv, q, p, p, t, vv)),
        pick((t, vv, vv, q, p, p)),
        pick((p, p, t, vv, vv, q)),
    ]
    if len(planes) == 4:
        out.append(planes[3])
    return out


def process(slot_datas, node):
    io = NodePlanes(slot_datas, node)
    planes = hsv_planes(connected_input(io.named("input"), "Hsv"),
                        hsv_bindings(node.node_type.payload))
    return io.outputs([(SlotId(0), planes)])  # alpha: the input's PlaneBuffer
