"""Distance node: gray seed mask → gray normalized distance fade.

Port of `kanter_core_tpu/ops/distance.py`. Pixels with `mask > 0.5` are
seeds; every pixel gets the toroidal distance `d` to its nearest seed by
jump flooding (JFA), and the output is `clip(1 − d / max_dist, 0, 1)`.

The nearest-seed state is one packed i32 plane (`y << 16 | x`, sentinel
`0x7FFFFFFF`); the step ladder `_jfa_steps` runs max(H, W)/2 … 1 and then
1 once more. Two implementations of the propagation:

- `jfa_propagate_plain`: plain torch, `distance_plane`'s roll/select fold;
- `jfa_propagate_cuda`: one launch per step of the hand-written kernel
  `csrc/jfa.cu`, which replaces the JAX package's Pallas step kernel
  (`pallas_distance._jfa_step_call`). Integer-only, so bit-identical.

`jfa_propagate` takes the plain version for a CPU tensor and the kernel for
a CUDA tensor (which raises if it cannot build or launch); there is no
fallback. Seed packing and the final fade are plain torch on the device:
the root in f64 rounded once, the division by a full tensor, the clip.

Under a mesh the JAX package runs no kernel here (its jnp rolls lower to
collective permutes, `compiler.py:445-447`). The port gathers a row-sharded
mask to the mesh's first device (a `distance` gather), runs the single-card
ladder there and shards the result again.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..build import CudaKernel
from ..errors import ErrorKind, TexProError
from ..parallel.sharded import ShardedPlane, shard_planes_rows
from .common import sqrt_f32

_SENTINEL = 0x7FFFFFFF
_FAR = 2**30


def _jfa_steps(h: int, w: int) -> list:
    """Power-of-two ladder max(H,W)/2 … 1, plus one more 1-step pass."""
    n = max(h, w)
    if n <= 1:
        return [1]
    steps = [2 ** p for p in range(int(math.ceil(math.log2(n))) - 1, -1, -1)]
    return steps + [1]


def _coords(h: int, w: int, device):
    rows = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return rows, cols


def pack_seeds(mask: torch.Tensor) -> torch.Tensor:
    """The packed i32 state of a gray mask: `y << 16 | x` on seeds
    (`mask > 0.5`), the sentinel elsewhere. Raises past the packing bound."""
    h, w = mask.shape
    if h > 32767 or w > 65535:
        raise TexProError(
            ErrorKind.GENERIC,
            f"Distance canvas {w}x{h} exceeds the packed-JFA bound "
            "(h <= 32767, w <= 65535)",
        )
    rows, cols = _coords(h, w, mask.device)
    pix = (rows << 16) | cols
    return torch.where(mask > 0.5, pix, torch.full_like(pix, _SENTINEL))


def d2_of(cand: torch.Tensor, rows, cols, h: int, w: int) -> torch.Tensor:
    """Toroidal squared distance from each pixel to its packed candidate;
    `_FAR` for the sentinel."""
    valid = cand != _SENTINEL
    dy = torch.abs(rows - (cand >> 16))
    dy = torch.where(dy > h // 2, h - dy, dy)
    dx = torch.abs(cols - (cand & 0xFFFF))
    dx = torch.where(dx > w // 2, w - dx, dx)
    dy = torch.where(valid, dy, 0)
    dx = torch.where(valid, dx, 0)
    return torch.where(valid, dy * dy + dx * dx, _FAR)


def jfa_step_plain(state: torch.Tensor, k: int) -> torch.Tensor:
    """One JFA step: each pixel folds its 8 step-`k` toroidal neighbours'
    candidates, in `(oy, ox)` order, strict `<`."""
    h, w = state.shape
    rows, cols = _coords(h, w, state.device)
    best = state
    best_d2 = d2_of(state, rows, cols, h, w)
    for oy in (-k, 0, k):
        for ox in (-k, 0, k):
            if oy == 0 and ox == 0:
                continue
            cand = state
            if h > 1 and oy % h != 0:
                cand = torch.roll(cand, oy, dims=0)
            if w > 1 and ox % w != 0:
                cand = torch.roll(cand, ox, dims=1)
            d2 = d2_of(cand, rows, cols, h, w)
            better = d2 < best_d2
            best = torch.where(better, cand, best)
            best_d2 = torch.where(better, d2, best_d2)
    return best


def jfa_propagate_plain(state: torch.Tensor) -> torch.Tensor:
    """The whole ladder in plain torch."""
    for k in _jfa_steps(*state.shape):
        state = jfa_step_plain(state, k)
    return state


JFA_KERNEL = CudaKernel(
    "jfa", "kanter_jfa_step_i32",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def jfa_propagate_cuda(state: torch.Tensor) -> torch.Tensor:
    """The whole ladder through the CUDA step kernel, one launch per step,
    on the current stream. Raises if `state` is not a contiguous 2-D int32
    CUDA tensor or the kernel does not build or launch."""
    if not (
        state.is_cuda and state.dtype == torch.int32 and state.dim() == 2
        and state.is_contiguous()
    ):
        raise TexProError(
            ErrorKind.GENERIC,
            "JFA kernel needs a contiguous 2-D int32 CUDA tensor, got "
            f"{state.dtype} {tuple(state.shape)} on {state.device}",
        )
    h, w = state.shape
    kernel = JFA_KERNEL.entry()
    src = state
    dst = torch.empty_like(state)
    spare = None  # the caller's `state` is never written
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        for k in _jfa_steps(h, w):
            rc = kernel(src.data_ptr(), dst.data_ptr(), k, h, w, stream)
            if rc != 0:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING, f"JFA kernel launch failed: CUDA error {rc}"
                )
            JFA_KERNEL.count_launch()
            if spare is None:
                spare = torch.empty_like(state)
                src, dst = dst, spare
            else:
                src, dst = dst, src
    return src


def jfa_propagate(state: torch.Tensor) -> torch.Tensor:
    """The JFA ladder on a packed state: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor."""
    if state.device.type == "cpu":
        return jfa_propagate_plain(state)
    if state.device.type == "cuda":
        return jfa_propagate_cuda(state.contiguous())
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no JFA for device {state.device}")


def distance_plane(mask, max_dist):
    """Normalized distance fade of one `[H, W]` gray plane (or
    `ShardedPlane`); `max_dist` is an f32 scalar (pixels)."""
    if isinstance(mask, ShardedPlane):
        whole = mask.gather(mask.mesh.devices[0], "distance")
        return shard_planes_rows(mask.mesh, distance_plane(whole, max_dist))
    h, w = mask.shape
    packed = jfa_propagate(pack_seeds(mask))
    rows, cols = _coords(h, w, mask.device)
    dist = sqrt_f32(d2_of(packed, rows, cols, h, w).to(torch.float32))
    divisor = float(np.maximum(np.float32(max_dist), np.float32(1e-6)))
    fade = 1.0 - dist / torch.full_like(dist, divisor)
    return torch.clamp(fade, 0.0, 1.0)
