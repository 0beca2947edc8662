"""The Transform node's bilinear toroidal sampler, shared with Warp.

Port of `bilinear_wrap_gather` and the quarter-turn table of
`kanter_core_tpu/ops/transform.py`; the Transform node itself is not ported
yet. Plain torch, the JAX function's op sequence: floor, clip to ±1e9
before the int cast, floor-mod wrap, flat-index gather of the four texels,
and the lerp in the fixed association `nx0 + fv·(nx1 − nx0)`.
"""

from __future__ import annotations

import torch

# exact quarter-turn unit vectors: keep axis-aligned angles gather-exact
_QUARTER = {0.0: (1.0, 0.0), 90.0: (0.0, 1.0), 180.0: (-1.0, 0.0), 270.0: (0.0, -1.0)}


def _wrapped_floor(coord: torch.Tensor, extent: int):
    """`(floor clipped to ±1e9, its int index floor-mod extent)`. A NaN
    coordinate takes index 0, as XLA's and CUDA's conversions give (torch's
    CPU cast would give INT_MIN)."""
    fl = torch.clamp(torch.floor(coord), -1e9, 1e9)
    idx = torch.where(torch.isnan(fl), 0.0, fl).to(torch.int32)
    return fl, torch.remainder(idx, extent)


def bilinear_wrap_gather(planes, u: torch.Tensor, v: torch.Tensor, wh: int, ww: int,
                         row_local=None):
    """Bilinear samples of each `[wh, ww]` plane at continuous texel
    coordinates `u`/`v` (`[nr, nc]` f32), wrapping toroidally.

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
    stride = planes[0].shape[1]  # every plane of an image has one shape
    if row_local is not None:
        y0, y1 = row_local(y0), row_local(y1)
    row0 = y0.to(torch.int64) * stride
    row1 = y1.to(torch.int64) * stride
    i00, i10, i01, i11 = row0 + x0, row0 + x1, row1 + x0, row1 + x1
    outs = []
    for p in planes:
        flat = p.reshape(-1)
        n00, n10, n01, n11 = flat[i00], flat[i10], flat[i01], flat[i11]
        nx0 = n00 + fu * (n10 - n00)
        nx1 = n01 + fu * (n11 - n01)
        outs.append(nx0 + fv * (nx1 - nx0))
    return tuple(outs)
