"""Levels node: per-plane remap `out_lo + (out_hi−out_lo)·t^gamma` where
`t = clip((x−in_lo)/(in_hi−in_lo), 0, 1)`.

Port of `kanter_core_tpu/ops/levels.py`. The five parameters are evaluator
arguments (`levels_bindings`), normalized out of the evaluator's
fingerprint like Value constants. Plain torch in the JAX function's op
order: the division by a full tensor (IEEE on every device), the clip,
the pow of the tensor's device (`exact_math.pow_f32`: glibc on the CPU,
`ds_pow` on a card), then the scaled product and the add as two roundings.
Applied to every plane (gray 1 / rgba all 4, alpha included), shard by
shard over a mesh.

- gamma == 1 skips the pow: glibc's `powf(x, 1)` returns `x` exactly, so
  the CPU bits are unchanged, and on a card it saves the op's cost;
- degenerate span (in_hi == in_lo): IEEE propagation — the divide yields
  ±inf (the clip resolves it to 1 or 0) or NaN (propagates).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ids import SlotId
from ..parallel.sharded import map_bands
from .common import NodePlanes, connected_input
from .exact_math import pow_f32


def levels_bindings(payload) -> np.ndarray:
    """The `levels_<id>` argument: f32[5] `(in_lo, in_hi, gamma, out_lo,
    out_hi)`."""
    return np.asarray(payload, np.float32)


def levels_t(plane: torch.Tensor, params) -> torch.Tensor:
    """`t = clip((x − in_lo)/(in_hi − in_lo), 0, 1)`, the pow's base. The
    scalar difference rounds to f32 on the host, as the JAX package's
    traced f32 arguments do."""
    in_lo, in_hi = np.asarray(params, np.float32)[:2]
    span = torch.full_like(plane, float(in_hi - in_lo))
    return torch.clamp((plane - float(in_lo)) / span, 0.0, 1.0)


def levels_plane(plane: torch.Tensor, params) -> torch.Tensor:
    """The remap of one `[H, W]` plane; `params` from `levels_bindings`."""
    _, _, gamma, out_lo, out_hi = np.asarray(params, np.float32)
    t = levels_t(plane, params)
    if gamma != np.float32(1.0):  # NaN gamma takes the pow
        t = pow_f32(t, torch.full_like(t, float(gamma)))
    return (t * float(out_hi - out_lo)) + float(out_lo)


def levels_images(planes, params) -> list:
    """Levels of every plane of an image (tensors or `ShardedPlane`s)."""
    return [map_bands(levels_plane, p, params) for p in connected_input(planes, "Levels")]


def process(slot_datas, node):
    io = NodePlanes(slot_datas, node)
    planes = levels_images(io.named("input"), levels_bindings(node.node_type.payload))
    return io.outputs([(SlotId(0), planes)])
