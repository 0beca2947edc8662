"""Pattern node: procedural tiling mask (Checker, Brick, Stripe).

Port of `kanter_core_tpu/ops/pattern.py`. Two Gray outputs from one cell
lattice: slot 0 the mask (cell parity or the brick field, times a
mortar/bevel groove ramp), slot 1 a per-cell random ID from Noise's
lattice hash keyed by the wrapped cell index and the seed. Plain torch on
the device of the index vectors, in the JAX function's op order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from .common import NodePlanes
from .noise import _hash01


def pattern_bindings(payload) -> dict:
    """The JAX package's `pattern_bindings`: f32 cell frequencies (f64
    math, one rounding), i32 wrap periods, mortar/bevel/seed scalars and
    the row/column index vectors."""
    width, height, _kind, cells_x, cells_y, mortar, bevel, seed = payload
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": np.float32(np.float64(int(cells_x)) / np.float64(width)),
        "fy": np.float32(np.float64(int(cells_y)) / np.float64(height)),
        "px": np.int32(cells_x),
        "py": np.int32(cells_y),
        "mortar": np.float32(mortar),
        "bevel": np.float32(bevel),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
    }


def pattern_planes(kind, rows, cols, fx, fy, px, py, mortar, bevel, seed):
    """`(mask, cells)` planes, each `[len(rows), len(cols)]`, for the
    pattern `kind` ("Checker", "Brick" or "Stripe")."""
    nr, nc = rows.shape[0], cols.shape[0]
    cy = rows.to(torch.float32) + 0.5
    cx = cols.to(torch.float32) + 0.5
    u = cx * float(fx)
    v = cy * float(fy)
    vi = torch.floor(v)
    yi = vi.to(torch.int32)
    fv = v - vi

    if kind == "Brick":
        # running bond: odd rows shift half a cell
        odd = torch.bitwise_and(yi, 1).to(torch.float32)
        u2 = u[None, :] + odd[:, None] * 0.5
    else:
        u2 = u[None, :].expand(nr, nc)
    ui = torch.floor(u2)
    xi = ui.to(torch.int32)
    fu = u2 - ui

    xw = torch.remainder(xi, int(px))
    yw = torch.remainder(yi, int(py))
    cells = _hash01(xw.to(torch.int64), yw.to(torch.int64)[:, None], int(seed))

    du = torch.minimum(fu, 1.0 - fu)
    if kind == "Stripe":
        d = du
    else:
        dv = torch.minimum(fv, 1.0 - fv)[:, None]
        d = torch.minimum(du, dv.expand_as(du))
    m = float(np.float32(mortar) * np.float32(0.5))
    bevel = float(np.float32(bevel))
    if bevel > 0.0:
        groove = torch.clamp((d - m) / torch.full_like(d, bevel), 0.0, 1.0)
    else:  # the exact step (the JAX select's other lane)
        groove = (d >= m).to(torch.float32)

    if kind == "Checker":
        par = torch.bitwise_and(xw + yw[:, None], 1).to(torch.float32)
        mask = par * groove
    elif kind == "Stripe":
        par = torch.bitwise_and(xw, 1).to(torch.float32)
        mask = par * groove
    else:  # Brick: the groove field is the mask
        mask = groove
    return mask, cells


def pattern_source(kind, b: dict, place) -> tuple:
    """`(mask, cells)` from the `pattern_bindings` and the pattern `kind`
    (structure, not an argument), made by the `common.Placement`."""
    return place.source(
        lambda rows, cols: pattern_planes(
            kind, rows, cols, b["fx"], b["fy"], b["px"], b["py"],
            b["mortar"], b["bevel"], b["seed"],
        ), b["rows"], b["cols"],
    )


def process(node, place):
    """Per-node: `mask` + `cells` Gray SlotDatas at the payload size."""
    payload = node.node_type.payload
    mask, cells = pattern_source(payload[2], pattern_bindings(payload), place)
    return NodePlanes([], node).outputs([(SlotId(0), [mask]), (SlotId(1), [cells])])
