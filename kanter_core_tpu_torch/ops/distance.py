"""Distance node: gray seed mask → gray normalized distance fade.

Port of `kanter_core_tpu/ops/distance.py`. Pixels with `mask > 0.5` are
seeds; every pixel gets the toroidal distance `d` to its nearest seed by
jump flooding (JFA), and the output is `clip(1 − d / max_dist, 0, 1)`.

The nearest-seed state is one packed i32 plane (`y << 16 | x`, sentinel
`0x7FFFFFFF`); the step ladder `_jfa_steps` runs max(H, W)/2 … 1 and then
1 once more. Two implementations of the propagation:

- `jfa_propagate_plain`: plain torch, `distance_plane`'s roll/select fold;
- `jfa_propagate_cuda`: the hand-written kernels of `csrc/jfa.cu`, which
  replace the JAX package's Pallas step kernel
  (`pallas_distance._jfa_step_call`): one launch per far step, then one
  launch for the run of near steps (8, 4, 2, 1, 1), as `jfa_launch_plan`
  lays the ladder out. Exact arithmetic throughout, so bit-identical.

Both take a `[B, H, W]` batch of states as well, with vmap's semantics:
each canvas propagated as the single state would be. The kernels take the
whole batch in one launch per entry of the plan (the canvas in
`blockIdx.z`), so a ladder is as many launches for 16 canvases as for one;
the JAX package's batching rule (`pallas_distance._jfa_ladder`'s) maps the
rank-2 ladder over the batch instead.

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
from typing import NamedTuple

import numpy as np
import torch

from ..build import MAX_BATCH, CudaKernel
from ..errors import ErrorKind, TexProError
from ..parallel.sharded import ShardedPlane, shard_planes_rows
from ..ids import SlotId
from .common import NodePlanes, gray_input, sqrt_f32

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
    """The packed i32 state of a gray mask (`[H, W]` or `[B, H, W]`):
    `y << 16 | x` on seeds (`mask > 0.5`), the sentinel elsewhere. Raises
    past the packing bound."""
    h, w = mask.shape[-2:]
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
    candidates, in `(oy, ox)` order, strict `<` (each canvas of a batch on
    its own)."""
    h, w = state.shape[-2:]
    rows, cols = _coords(h, w, state.device)
    best = state
    best_d2 = d2_of(state, rows, cols, h, w)
    for oy in (-k, 0, k):
        for ox in (-k, 0, k):
            if oy == 0 and ox == 0:
                continue
            cand = state
            if h > 1 and oy % h != 0:
                cand = torch.roll(cand, oy, dims=-2)
            if w > 1 and ox % w != 0:
                cand = torch.roll(cand, ox, dims=-1)
            d2 = d2_of(cand, rows, cols, h, w)
            better = d2 < best_d2
            best = torch.where(better, cand, best)
            best_d2 = torch.where(better, d2, best_d2)
    return best


def jfa_propagate_plain(state: torch.Tensor) -> torch.Tensor:
    """The whole ladder in plain torch."""
    for k in _jfa_steps(*state.shape[-2:]):
        state = jfa_step_plain(state, k)
    return state


# a far step: (in, out, k, h, w, batch, in batch stride, out batch stride,
# stream)
JFA_KERNEL = CudaKernel(
    "jfa", "kanter_jfa_step_i32",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
)
# a fused run of near steps, the second entry of the same library, with its
# own launch count: (in, out, host steps, n, h, w, th, tw, batch, in batch
# stride, out batch stride, stream)
JFA_NEAR_KERNEL = CudaKernel(
    "jfa", "kanter_jfa_near_i32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
)

JFA_NEAR_HALO = 16  # the most the fused near steps may sum to (8, 4, 2, 1, 1)
JFA_NEAR_TILE = 64  # rows and columns of a near tile


class JfaLaunch(NamedTuple):
    """One launch of a ladder: `entry` is "step" (one far step,
    `kanter_jfa_step_i32`) or "near" (the fused run, `kanter_jfa_near_i32`),
    `steps` the ladder's steps it covers; a near launch works on tiles of
    `th` × `tw` pixels with a halo of the steps' sum."""

    entry: str
    steps: tuple
    th: int = 0
    tw: int = 0


def jfa_launch_plan(h: int, w: int) -> list:
    """The launches of one ladder on an `h` × `w` plane, in order: the
    longest tail of `_jfa_steps` that sums to at most `JFA_NEAR_HALO` is one
    fused near launch, every step before it a far launch of its own."""
    steps = _jfa_steps(h, w)
    cut = len(steps)
    while cut > 0 and sum(steps[cut - 1:]) <= JFA_NEAR_HALO:
        cut -= 1
    near = JfaLaunch("near", tuple(steps[cut:]), min(JFA_NEAR_TILE, h),
                     max(2, min(JFA_NEAR_TILE, w)))
    return [JfaLaunch("step", (k,)) for k in steps[:cut]] + [near]


def jfa_step_form(k: int, h: int, w: int) -> str:
    """Which kernel `kanter_jfa_step_i32` picks for a far step: "lattice"
    where the step, reduced along each axis, divides both extents, else
    "pixel" (one pixel per thread)."""
    ky, kx = k % h, k % w
    return "lattice" if ky and kx and h % ky == 0 and w % kx == 0 else "pixel"


def jfa_propagate_cuda(state: torch.Tensor) -> torch.Tensor:
    """The whole ladder through the CUDA kernels, one launch per entry of
    `jfa_launch_plan` for a state or a whole `[B, H, W]` batch, on the
    current stream. Raises if `state` is not a contiguous 2-D or 3-D int32
    CUDA tensor or a kernel does not build or launch."""
    launches = jfa_launch_plan(*state.shape[-2:]) if state.dim() in (2, 3) else []
    return jfa_run_launches(state, launches)


def jfa_run_launches(state: torch.Tensor, launches) -> torch.Tensor:
    """The given launches of a plan, in order, from `state` (which is never
    written) through at most two work buffers."""
    if not (
        state.is_cuda and state.dtype == torch.int32 and state.is_contiguous()
        and (state.dim() == 2 or (state.dim() == 3 and 1 <= state.shape[0] <= MAX_BATCH))
    ):
        raise TexProError(
            ErrorKind.GENERIC,
            f"JFA kernel needs a contiguous [H, W] or [B, H, W] (B <= {MAX_BATCH}) int32 "
            f"CUDA tensor, got {state.dtype} {tuple(state.shape)} on {state.device}",
        )
    h, w = state.shape[-2:]
    batch = state.shape[0] if state.dim() == 3 else 1
    step_entry = JFA_KERNEL.entry()
    near_entry = JFA_NEAR_KERNEL.entry()
    src = state
    dst = torch.empty_like(state)
    spare = None  # the caller's `state` is never written
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        for launch in launches:
            if launch.entry == "near":
                ks = (ctypes.c_int * len(launch.steps))(*launch.steps)
                rc = near_entry(src.data_ptr(), dst.data_ptr(), ks, len(launch.steps), h, w,
                                launch.th, launch.tw, batch, h * w, h * w, stream)
                kernel = JFA_NEAR_KERNEL
            else:
                (k,) = launch.steps
                rc = step_entry(src.data_ptr(), dst.data_ptr(), k, h, w, batch, h * w, h * w,
                                stream)
                kernel = JFA_KERNEL
            if rc != 0:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING,
                    f"JFA kernel launch failed ({launch}): CUDA error {rc}",
                )
            kernel.count_launch(launch.steps, batch)
            if spare is None:
                spare = torch.empty_like(state)
                src, dst = dst, spare
            else:
                src, dst = dst, src
    return src


def jfa_propagate(state: torch.Tensor) -> torch.Tensor:
    """The JFA ladder on a packed state (or a `[B, H, W]` batch of them):
    the plain version for a CPU tensor, the CUDA kernels for a CUDA
    tensor."""
    if state.device.type == "cpu":
        return jfa_propagate_plain(state)
    if state.device.type == "cuda":
        return jfa_propagate_cuda(state.contiguous())
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no JFA for device {state.device}")


def distance_plane(mask, max_dist):
    """Normalized distance fade of one `[H, W]` gray plane, of each canvas
    of a `[B, H, W]` batch, or of a `ShardedPlane`; `max_dist` is an f32
    scalar (pixels)."""
    if isinstance(mask, ShardedPlane):
        whole = mask.gather(mask.mesh.devices[0], "distance")
        return shard_planes_rows(mask.mesh, distance_plane(whole, max_dist))
    h, w = mask.shape[-2:]
    packed = jfa_propagate(pack_seeds(mask))
    rows, cols = _coords(h, w, mask.device)
    dist = sqrt_f32(d2_of(packed, rows, cols, h, w).to(torch.float32))
    divisor = float(np.maximum(np.float32(max_dist), np.float32(1e-6)))
    fade = 1.0 - dist / torch.full_like(dist, divisor)
    return torch.clamp(fade, 0.0, 1.0)


def process(slot_datas, node):
    """Per-node: the JFA ladder's launches on a CUDA processor; over a mesh
    the plane is gathered (`distance_plane`)."""
    io = NodePlanes(slot_datas, node)
    mask = gray_input(io.named("input"), "Distance")
    return io.outputs([(SlotId(0), [distance_plane(mask, np.float32(node.node_type.payload))])])
