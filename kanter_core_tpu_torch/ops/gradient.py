"""GradientMap node: gray → RGBA through N lerped colour stops.

Port of `kanter_core_tpu/ops/gradient.py`. The stop table (positions
f32[N], colours f32[4, N]) is an evaluator argument (`gradient_bindings`);
only the stop count is structure. Evaluation is the JAX function's
where-select over segments, never a cumulative sum: start from the first
stop's colour, and for each segment k select `c_k + t·(c_{k+1} − c_k)`,
`t = clip((x − p_k)/(p_{k+1} − p_k), 0, 1)`, where `x ≥ p_k`. Plain torch:
the stop differences round to f32 on the host, the division is by a full
tensor, the product and the add round on their own. NaN input selects no
segment and keeps the first stop's colour; degenerate stops propagate as
IEEE says. An RGBA input is an `INVALID_BUFFER_COUNT` error. Row-sharded
planes map shard by shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from ..parallel.sharded import map_bands
from .common import NodePlanes, gray_input


def gradient_bindings(payload) -> dict:
    """The `grad_<id>` argument: stop positions f32[N] and colours
    f32[4, N] (channel-major)."""
    pos = np.asarray([s[0] for s in payload], np.float32)
    colors = np.asarray([[s[1 + c] for s in payload] for c in range(4)], np.float32)
    return {"pos": pos, "colors": colors}


def _gradient_plane(plane: torch.Tensor, pos, colors) -> tuple:
    n = pos.shape[0]
    ts = []
    for k in range(n - 1):
        span = torch.full_like(plane, float(pos[k + 1] - pos[k]))
        ts.append((torch.clamp((plane - float(pos[k])) / span, 0.0, 1.0), plane >= float(pos[k])))
    outs = []
    for c in range(4):
        out = torch.full_like(plane, float(colors[c, 0]))
        for k, (t, above) in enumerate(ts):
            seg = (t * float(colors[c, k + 1] - colors[c, k])) + float(colors[c, k])
            out = torch.where(above, seg, out)
        outs.append(out)
    return tuple(outs)


def gradient_planes(planes, b: dict) -> list:
    """The four RGBA planes of a gray image's gradient map; `b` from
    `gradient_bindings`."""
    plane = gray_input(planes, "GradientMap")
    return list(map_bands(lambda p: _gradient_plane(p, b["pos"], b["colors"]), plane))


def process(slot_datas, node):
    io = NodePlanes(slot_datas, node)
    planes = gradient_planes(io.named("input"), gradient_bindings(node.node_type.payload))
    return io.outputs([(SlotId(0), planes)])
