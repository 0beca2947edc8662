"""Transform node: affine translate/rotate/scale with seamless wrap, and
the bilinear toroidal sampler it shares with Warp.

Port of `kanter_core_tpu/ops/transform.py`. The output pixel at centre
`(x+0.5, y+0.5)` bilinearly samples the input at the inverse-transformed
coordinate, wrapping toroidally; the forward transform rotates by
`rotation` degrees and scales by `(scale_x, scale_y)` around the canvas
centre, then translates by `(offset_x, offset_y)` pixels. The cosine and
sine (quarter turns from an exact table) and the reciprocal scales are
computed on the host in f64 and rounded once (`transform_bindings`), so
every consumer sees the same bits; the per-pixel coordinate math is plain
torch in the JAX function's association, each product and sum rounding on
its own, and there is no division on the device.

`bilinear_wrap_gather`, the sampler: floor, clip to ±1e9 before the int
cast, floor-mod wrap, flat-index gather of the four texels, and the lerp in
the fixed association `nx0 + fv·(nx1 − nx0)`.

Under a mesh the source rows of a rotated or scaled sample are unbounded,
so the node gathers its input to the mesh's first device (one `transform`
gather per plane), transforms it there and shards the result again, as
Distance does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from ..parallel.sharded import ShardedPlane, shard_planes_rows
from .common import NodePlanes, connected_input

# exact quarter-turn unit vectors: keep axis-aligned angles gather-exact
_QUARTER = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0), 180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}


def _wrapped_floor(coord: torch.Tensor, extent: int):
    """`(floor clipped to ±1e9, its int index floor-mod extent)`. A NaN
    coordinate takes index 0, as XLA's and CUDA's conversions give (torch's
    CPU cast would give INT_MIN)."""
    fl = torch.clamp(torch.floor(coord), -1e9, 1e9)
    idx = torch.where(torch.isnan(fl), 0.0, fl).to(torch.int32)
    return fl, torch.remainder(idx, extent)


def _take(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`plane`'s texels at the flat indices `idx` (`[nr, nc]`), canvas by
    canvas where either is a `[B, ...]` batch (the other one then serves
    every canvas, as vmap broadcasts an unbatched operand)."""
    if plane.dim() == 2 and idx.dim() == 2:
        return plane.reshape(-1)[idx]
    flat = plane.reshape(plane.shape[0] if plane.dim() == 3 else 1, -1)
    index = idx.reshape(idx.shape[0] if idx.dim() == 3 else 1, -1)
    b = max(flat.shape[0], index.shape[0])
    taken = torch.gather(flat.expand(b, -1), 1, index.expand(b, -1))
    return taken.reshape(b, *idx.shape[-2:])


def bilinear_wrap_gather(planes, u: torch.Tensor, v: torch.Tensor, wh: int, ww: int,
                         row_local=None):
    """Bilinear samples of each `[wh, ww]` plane at continuous texel
    coordinates `u`/`v` (`[nr, nc]` f32), wrapping toroidally. A plane or
    the coordinates may carry a leading batch axis (`[B, ...]`); each
    canvas is sampled as on its own.

    `row_local` (optional) maps the wrapped GLOBAL source rows to rows of
    `planes` when they hold a row subset of the canvas (a shard's
    halo-extended block): integer-only, after the wrap, so the texels and
    every lerp bit are those of the full-plane gather."""
    uf, x0 = _wrapped_floor(u, ww)
    vf, y0 = _wrapped_floor(v, wh)
    fu = u - uf
    fv = v - vf
    x1 = torch.where(x0 + 1 == ww, 0, x0 + 1)
    y1 = torch.where(y0 + 1 == wh, 0, y0 + 1)
    stride = planes[0].shape[-1]  # every plane of an image has one shape
    if row_local is not None:
        y0, y1 = row_local(y0), row_local(y1)
    row0 = y0.to(torch.int64) * stride
    row1 = y1.to(torch.int64) * stride
    i00, i10, i01, i11 = row0 + x0, row0 + x1, row1 + x0, row1 + x1
    outs = []
    for p in planes:
        n00, n10, n01, n11 = (_take(p, i) for i in (i00, i10, i01, i11))
        nx0 = n00 + fu * (n10 - n00)
        nx1 = n01 + fu * (n11 - n01)
        outs.append(nx0 + fv * (nx1 - nx0))
    return tuple(outs)


def transform_bindings(payload) -> dict:
    """The `xform_<id>` argument: `(cos, sin)` of the rotation (exact at
    quarter turns), the reciprocal scales and the pixel offsets, each f64
    math rounded once to f32."""
    ox, oy, deg, sx, sy = (float(v) for v in payload)
    d = deg % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    with np.errstate(divide="ignore"):
        inv = np.float64(1.0) / np.asarray([sx, sy], np.float64)
    return {
        "cs": np.asarray([cos, sin], np.float32),
        "inv_s": inv.astype(np.float32),
        "off": np.asarray([ox, oy], np.float32),
    }


def transform_planes(planes, b: dict) -> tuple:
    """The affine sample of every `[H, W]` plane of an image onto its own
    canvas (each canvas of a `[B, H, W]` plane alike); `b` from
    `transform_bindings`."""
    h, w = planes[0].shape[-2:]
    device = planes[0].device
    cos, sin = (float(c) for c in b["cs"])
    inv_x, inv_y = (float(c) for c in b["inv_s"])
    off_x, off_y = (float(c) for c in b["off"])
    cxc = float(np.float32(w) * np.float32(0.5))  # canvas centre (exact)
    cyc = float(np.float32(h) * np.float32(0.5))
    cx = torch.arange(w, dtype=torch.float32, device=device) + 0.5  # pixel centres
    cy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    px = (cx - cxc) - off_x
    py = (cy - cyc) - off_y
    # inverse rotation R(−θ), then inverse scale, one fixed association
    qx = (px * cos)[None, :] + (py * sin)[:, None]
    qy = (py * cos)[:, None] - (px * sin)[None, :]
    u = (qx * inv_x) + float(np.float32(cxc) - np.float32(0.5))
    v = (qy * inv_y) + float(np.float32(cyc) - np.float32(0.5))
    return bilinear_wrap_gather(planes, u, v, h, w)


def transform_images(planes, b: dict) -> list:
    """Transform of an image's planes (tensors or `ShardedPlane`s)."""
    planes = connected_input(planes, "Transform")
    if isinstance(planes[0], ShardedPlane):
        mesh = planes[0].mesh
        whole = [p.gather(mesh.devices[0], "transform") for p in planes]
        return [shard_planes_rows(mesh, p) for p in transform_planes(whole, b)]
    return list(transform_planes(planes, b))


def process(slot_datas, node):
    io = NodePlanes(slot_datas, node)
    planes = transform_images(io.named("input"), transform_bindings(node.node_type.payload))
    return io.outputs([(SlotId(0), planes)])
