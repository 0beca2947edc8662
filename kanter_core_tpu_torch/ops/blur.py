"""Blur node: separable Gaussian with toroidal wrap.

Port of `kanter_core_tpu/ops/blur.py`. Two implementations of one function:

- `blur_plane_plain`: plain torch, mirroring `_blur_axis0` — a zero-initialised
  accumulator and, per tap in order, a wrap-rolled copy times the tap weight
  (a separate `*`, then `+`), vertical pass then the same on the transpose;
- `blur_plane_cuda`: the hand-written Hopper kernel `csrc/blur.cu`, built
  with nvcc into a shared library with a plain C interface on first use and
  called through ctypes. It replaces the JAX package's Pallas kernel
  (`pallas_blur.blur_pallas`) and is bit-identical to the plain version.
  One launch blurs the plane tile by tile in shared memory, both passes;
  `blur_tile_plan` picks the tile for a radius and a shape on the host.

Both take a `[B, H, W]` batch as well, with vmap's semantics: each canvas
blurred as the single plane would be, bit for bit. The kernel takes the
whole batch in one launch (one wave of blocks over the tiles of every
canvas); the JAX package's batching rule
(`pallas_blur._blur_pallas_wrapped`'s `custom_vmap`) maps the rank-2
kernel over the batch instead.

`blur_plane` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (which raises if it cannot build or
launch); there is no fallback from one to the other.

The mesh form (`TextureProcessor(mesh=...)`) blurs a row-sharded plane
shard by shard, the port of `pallas_blur._blur_pallas_sharded`: a ring
exchange of ±radius rows (`ShardedPlane.ring_halos`; on CUDA devices
`ring_halo_addresses`, by device address), then one block launch per shard
on that shard's device, `blur_block_plain` / `blur_block_cuda`
(the entry `kanter_blur_block_f32` of `csrc/blur.cu`, the port of
`pallas_blur._blur_block`). Where the blocks are shorter than the radius
(`fits_sharded`), the plane is gathered to the mesh's first device, blurred
by the dense kernel and sharded again, counted as a `blur_gate` gather.

The taps are computed on the host exactly as the JAX package computes them
(`gaussian_taps`, copied verbatim: f64 exp, f32 cast, f32 sum, divide).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..build import MAX_BATCH, CudaKernel
from ..errors import ErrorKind, TexProError
from ..ids import SlotId
from ..parallel.sharded import ShardedPlane, shard_planes_rows
from .common import NodePlanes, connected_input


@functools.lru_cache(maxsize=256)
def gaussian_taps(sigma: float) -> np.ndarray:
    """Normalized f32 Gaussian taps over [-radius, radius], radius=ceil(3σ)."""
    sigma = max(float(sigma), 1e-3)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(xs * xs) / (2.0 * sigma * sigma)).astype(np.float32)
    return (w / w.sum(dtype=np.float32)).astype(np.float32)


def _taps_for(sigma: float) -> np.ndarray:
    return gaussian_taps(round(float(sigma), 6))


def _blur_axis(plane: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Weighted sum of wrap-rolled copies along `dim` (-2: rows, -1:
    columns), tap order preserved."""
    radius = (len(taps) - 1) // 2
    acc = torch.zeros_like(plane)
    # roll on a length-1 axis is the identity
    degenerate = plane.shape[dim] == 1
    for t, w in enumerate(taps):
        shifted = plane if degenerate else torch.roll(plane, radius - t, dims=dim)
        acc = acc + shifted * float(w)
    return acc


def blur_plane_plain(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """The plain torch blur of one `[H, W]` f32 plane, or of each canvas of
    a `[B, H, W]` batch, on its device: the vertical pass, then the
    horizontal one (the JAX package's pass over the transpose, element for
    element)."""
    taps = _taps_for(sigma)
    return _blur_axis(_blur_axis(plane, taps, -2), taps, -1).contiguous()


def blur_block_plain(block: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """The plain torch blur of one `[block_h, W]` row block whose vertical
    neighbours are the explicit halos `top` (the radius rows before it) and
    `bot` (the radius rows after it): `_blur_axis`'s taps, order and
    zero-initialised accumulator over the window `[top; block; bot]`,
    keeping the block's rows, then the dense horizontal pass."""
    taps = _taps_for(sigma)
    block_h = block.shape[0]
    window = torch.cat([top, block, bot], dim=0)
    acc = torch.zeros_like(block)
    for t, w in enumerate(taps):
        # window row y + t holds plane row y + t − radius
        acc = acc + window[t:t + block_h] * float(w)
    return _blur_axis(acc, taps, -1).contiguous()


# what one block may take of an SM's shared memory (232,448 bytes), and the
# share the plan aims for, so that two blocks fit on an SM beside the 1 KiB
# the system keeps for each and one block's staging overlaps the other's
# arithmetic
BLUR_SMEM_MAX = 232448
BLUR_SMEM_TARGET = 113 * 1024
BLUR_STRIP = 8  # outputs per thread in either pass: tiles come in multiples
BLUR_TILE_MAX_RADIUS = 31  # 63 taps; wider blurs take the kernel's two-pass form


class BlurTilePlan(NamedTuple):
    """How `csrc/blur.cu` tiles one plane: output tiles of `th` × `tw`
    pixels, `tiles_y` × `tiles_x` of them, each staging a window of
    `th + 2r` rows (and `tw` columns plus the radius rounded up to 4 on
    either side) and a `th × (tw + 2r)` intermediate in `smem_bytes` of
    shared memory; `general` where a window can pass the plane's far edge
    twice, so staging wraps with a remainder (for a row block only the
    width counts: its rows come with their halos and never wrap)."""

    th: int
    tw: int
    tiles_y: int
    tiles_x: int
    smem_bytes: int
    general: bool


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def blur_tile_smem(radius: int, th: int, tw: int) -> int:
    """Shared memory of one tile, as the kernel lays it out: the window's
    rows plus one spare and the intermediate's rows, at a pitch of the
    staged columns (the tile and the radius rounded up to 4 on either side,
    so that the window starts on a 16-byte boundary) plus 4 spare."""
    pitch = tw + 2 * _round_up(radius, 4) + 4
    return (2 * th + 2 * radius + 1) * pitch * 4


@functools.lru_cache(maxsize=256)
def blur_tile_plan(radius: int, h: int, w: int) -> BlurTilePlan:
    """The tile for a radius and a plane (or row block) of `h` × `w`: 128
    columns (16 at least, no wider than the plane needs), and the tallest
    multiple of 8 rows up to 64 (no taller than the plane needs) whose shared
    memory stays within `BLUR_SMEM_TARGET`; where that leaves fewer than 32
    rows, up to 32 within `BLUR_SMEM_MAX`."""
    if not (0 <= radius <= BLUR_TILE_MAX_RADIUS and h >= 1 and w >= 1):
        raise ValueError(f"no blur tile for radius {radius} on {h}x{w}")
    tw = max(2 * BLUR_STRIP, min(128, _round_up(w, BLUR_STRIP)))
    need = _round_up(h, BLUR_STRIP)
    th = min(64, need)
    while th > BLUR_STRIP and blur_tile_smem(radius, th, tw) > BLUR_SMEM_TARGET:
        th -= BLUR_STRIP
    if th < min(32, need):
        # a wide radius: rather one block per SM than a tile much shorter
        # than its halo
        th = min(32, need)
        while th > BLUR_STRIP and blur_tile_smem(radius, th, tw) > BLUR_SMEM_MAX:
            th -= BLUR_STRIP
    return BlurTilePlan(
        th, tw, -(-h // th), -(-w // tw), blur_tile_smem(radius, th, tw),
        th + radius > h or tw + _round_up(radius, 4) > w,
    )


# (in, out, host taps, ntaps, h, w, th, tw, scratch, device taps, batch,
#  in batch stride, out batch stride, stream)
BLUR_KERNEL = CudaKernel(
    "blur", "kanter_blur_wrap_f32",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
)
# the block entry of the same library; its own launch count
# (top, block, bot, out, host taps, ntaps, block_h, w, th, tw, scratch,
#  device taps, stream)
BLUR_BLOCK_KERNEL = CudaKernel(
    "blur", "kanter_blur_block_f32",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
)


def _launch_args(taps: np.ndarray, h: int, w: int, like: torch.Tensor) -> tuple:
    """(th, tw, scratch, device taps, tensors to keep alive) for one launch:
    the tile of `blur_tile_plan` up to `BLUR_TILE_MAX_RADIUS`; above it the
    two-pass form's scratch (the size of the whole batch `like`) and its
    taps in device memory."""
    radius = (len(taps) - 1) // 2
    if radius <= BLUR_TILE_MAX_RADIUS:
        plan = blur_tile_plan(radius, h, w)
        return plan.th, plan.tw, None, None, ()
    scratch = torch.empty_like(like)
    taps_dev = torch.from_numpy(taps).to(like.device)
    return 0, 0, scratch.data_ptr(), taps_dev.data_ptr(), (scratch, taps_dev)


def _check_cuda_plane(t: torch.Tensor, what: str, shape=None, batched: bool = False) -> None:
    dims = (2, 3) if batched else (2,)
    if not (
        t.is_cuda and t.dtype == torch.float32 and t.dim() in dims and t.is_contiguous()
        and (shape is None or tuple(t.shape) == tuple(shape))
        and (t.dim() == 2 or 1 <= t.shape[0] <= MAX_BATCH)
    ):
        want = "" if shape is None else f" of shape {tuple(shape)}"
        rank = f"[H, W] or [B, H, W] (B <= {MAX_BATCH})" if batched else "2-D"
        raise TexProError(
            ErrorKind.GENERIC,
            f"blur kernel needs contiguous {rank} float32 CUDA tensors{want}; {what} is "
            f"{t.dtype} {tuple(t.shape)} on {t.device}",
        )


def blur_plane_cuda(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """The hand-written CUDA blur of one contiguous `[H, W]` f32 plane, or
    of every canvas of a contiguous `[B, H, W]` batch in one launch, on a
    CUDA device. Launches on the current stream; raises if the input is
    not such a tensor, or if the kernel does not build or launch."""
    _check_cuda_plane(plane, "the plane", batched=True)
    h, w = plane.shape[-2:]
    batch = plane.shape[0] if plane.dim() == 3 else 1
    kernel = BLUR_KERNEL.entry()
    taps = _taps_for(sigma)  # host memory: the entry hands them over by value
    out = torch.empty_like(plane)
    with torch.cuda.device(plane.device):
        th, tw, scratch, taps_dev, _keep = _launch_args(taps, h, w, plane)
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = kernel(
            plane.data_ptr(), out.data_ptr(), taps.ctypes.data, len(taps), h, w,
            th, tw, scratch, taps_dev, batch, h * w, h * w, stream,
        )
    if rc != 0:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"blur kernel launch failed: CUDA error {rc}"
        )
    BLUR_KERNEL.count_launch(round(float(sigma), 6), batch)
    return out


def _blur_block_launch(block: torch.Tensor, top: int, bot: int, taps: np.ndarray,
                       sigma: float) -> torch.Tensor:
    """The block kernel on the block's device and current stream, for a
    checked block whose `r`-row top and bottom halos start at the device
    addresses `top` and `bot`."""
    block_h, w = block.shape
    kernel = BLUR_BLOCK_KERNEL.entry()
    out = torch.empty_like(block)
    with torch.cuda.device(block.device):
        th, tw, scratch, taps_dev, _keep = _launch_args(taps, block_h, w, block)
        stream = torch.cuda.current_stream(block.device).cuda_stream
        rc = kernel(
            top, block.data_ptr(), bot, out.data_ptr(),
            taps.ctypes.data, len(taps), block_h, w, th, tw, scratch, taps_dev, stream,
        )
    if rc != 0:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"blur block kernel launch failed: CUDA error {rc}"
        )
    BLUR_BLOCK_KERNEL.count_launch(round(float(sigma), 6))
    return out


def blur_block_cuda(block: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """The hand-written CUDA blur of one row block with explicit halos (the
    `kanter_blur_block_f32` entry of `csrc/blur.cu`), on the block's device
    and current stream. Raises if the tensors are not contiguous 2-D f32 on
    one CUDA device with halos of radius rows, or if the kernel does not
    build or launch."""
    block_h, w = block.shape
    taps = _taps_for(sigma)
    r = (len(taps) - 1) // 2
    _check_cuda_plane(block, "the block")
    _check_cuda_plane(top, "the top halo", (r, w))
    _check_cuda_plane(bot, "the bottom halo", (r, w))
    if top.device != block.device or bot.device != block.device or block_h < r:
        raise TexProError(
            ErrorKind.GENERIC,
            f"blur block kernel: halos must lie on {block.device} and the block "
            f"({block_h} rows) hold at least {r} rows",
        )
    return _blur_block_launch(block, top.data_ptr(), bot.data_ptr(), taps, sigma)


def blur_block(block: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
               sigma: float) -> torch.Tensor:
    """Blur of one row block with explicit halos: the plain version for CPU
    tensors, the CUDA block kernel for CUDA tensors."""
    if block.device.type == "cpu":
        return blur_block_plain(block, top, bot, sigma)
    if block.device.type == "cuda":
        return blur_block_cuda(block.contiguous(), top.contiguous(), bot.contiguous(), sigma)
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no blur for device {block.device}")


def fits_sharded(height: int, taps_len: int, n_shards: int) -> bool:
    """The port's gate for the sharded blur: rows divide the mesh axis and
    each block covers the radius (one ring hop). The Mosaic terms of the
    JAX package's gate (8-row minimum, lane-aligned width, the kernel's VMEM
    fit) do not apply to the CUDA block kernel."""
    radius = (taps_len - 1) // 2
    return height % n_shards == 0 and height // n_shards >= radius


def blur_plane_sharded(sp: ShardedPlane, sigma: float) -> ShardedPlane:
    """Blur of a row-sharded plane: a ring exchange of ±radius rows, then
    one block launch per shard on that shard's device. A plane whose blocks
    are shorter than the radius is gathered to the mesh's first device,
    blurred whole and sharded again (a `blur_gate` gather)."""
    taps = _taps_for(sigma)
    mesh = sp.mesh
    if not fits_sharded(sp.shape[0], len(taps), mesh.n):
        whole = sp.gather(mesh.devices[0], "blur_gate")
        return shard_planes_rows(mesh, blur_plane(whole, sigma))
    r = (len(taps) - 1) // 2
    if mesh.device_type == "cuda":
        # a ShardedPlane's bands are 2-D, alike and each on its shard's
        # device, and its ring halos are rows of them (or copies), so what
        # is left to check is f32 and contiguous bands
        if not (sp.dtype == torch.float32 and all(b.is_contiguous() for b in sp.bands)):
            raise TexProError(
                ErrorKind.GENERIC, f"blur block kernel needs contiguous float32 bands; got {sp}"
            )
        tops, bots, _copies = sp.ring_halo_addresses(r)  # _copies: alive until launched
        return ShardedPlane(mesh, [
            _blur_block_launch(band, top, bot, taps, sigma)
            for band, top, bot in zip(sp.bands, tops, bots)
        ])
    halos = sp.ring_halos(r)
    return ShardedPlane(
        mesh, [blur_block(band, top, bot, sigma) for band, (top, bot) in zip(sp.bands, halos)]
    )


def blur_plane(plane, sigma: float):
    """Separable wrap blur of one `[H, W]` f32 plane, or of each canvas of a
    `[B, H, W]` batch: the plain version for a CPU tensor, the CUDA kernel
    (one launch for the whole batch) for a CUDA tensor, the sharded form
    for a `ShardedPlane`."""
    if isinstance(plane, ShardedPlane):
        return blur_plane_sharded(plane, sigma)
    if plane.device.type == "cpu":
        return blur_plane_plain(plane, sigma)
    if plane.device.type == "cuda":
        return blur_plane_cuda(plane.contiguous(), sigma)
    raise TexProError(
        ErrorKind.NODE_PROCESSING, f"no blur for device {plane.device}"
    )


def blur_images(planes, sigma: float) -> list:
    """A Blur node's output planes: every input plane blurred (alpha too)."""
    return [blur_plane(p, sigma) for p in connected_input(planes, "Blur")]


def process(slot_datas, node, sigma: float):
    """Per-node: one launch of the blur kernel per plane on a CUDA
    processor, the sharded form's block launches over a mesh."""
    io = NodePlanes(slot_datas, node)
    return io.outputs([(SlotId(0), blur_images(io.named("input"), sigma))])
