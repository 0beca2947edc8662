"""Blur node: separable Gaussian with toroidal wrap.

Port of `kanter_core_tpu/ops/blur.py`. Two implementations of one function:

- `blur_plane_plain`: plain torch, mirroring `_blur_axis0` — a zero-initialised
  accumulator and, per tap in order, a wrap-rolled copy times the tap weight
  (a separate `*`, then `+`), vertical pass then the same on the transpose;
- `blur_plane_cuda`: the hand-written Hopper kernel `csrc/blur.cu`, built
  with nvcc into a shared library with a plain C interface on first use and
  called through ctypes. It replaces the JAX package's Pallas kernel
  (`pallas_blur.blur_pallas`) and is bit-identical to the plain version.

`blur_plane` dispatches on the tensor's device: a CPU tensor takes the plain
version, a CUDA tensor the kernel (which raises if it cannot build or
launch); there is no fallback from one to the other.

The mesh form (`TextureProcessor(mesh=...)`) blurs a row-sharded plane
shard by shard, the port of `pallas_blur._blur_pallas_sharded`: a ring
exchange of ±radius rows (`ShardedPlane.ring_halos`), then one block launch
per shard on that shard's device, `blur_block_plain` / `blur_block_cuda`
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

import numpy as np
import torch

from ..build import CudaKernel
from ..errors import ErrorKind, TexProError
from ..parallel.sharded import ShardedPlane, shard_planes_rows


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


def _blur_axis0(plane: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Weighted sum of wrap-rolled rows, tap order preserved."""
    radius = (len(taps) - 1) // 2
    acc = torch.zeros_like(plane)
    # roll on a length-1 axis is the identity
    degenerate = plane.shape[0] == 1
    for t, w in enumerate(taps):
        shifted = plane if degenerate else torch.roll(plane, radius - t, dims=0)
        acc = acc + shifted * float(w)
    return acc


def blur_plane_plain(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """The plain torch blur of one `[H, W]` f32 plane, on its device."""
    taps = _taps_for(sigma)
    vert = _blur_axis0(plane, taps)
    return _blur_axis0(vert.t(), taps).t().contiguous()


def blur_block_plain(block: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """The plain torch blur of one `[block_h, W]` row block whose vertical
    neighbours are the explicit halos `top` (the radius rows before it) and
    `bot` (the radius rows after it): `_blur_axis0`'s taps, order and
    zero-initialised accumulator over the window `[top; block; bot]`,
    keeping the block's rows, then the dense horizontal pass."""
    taps = _taps_for(sigma)
    block_h = block.shape[0]
    window = torch.cat([top, block, bot], dim=0)
    acc = torch.zeros_like(block)
    for t, w in enumerate(taps):
        # window row y + t holds plane row y + t − radius
        acc = acc + window[t:t + block_h] * float(w)
    return _blur_axis0(acc.t(), taps).t().contiguous()


class CudaBlurKernel(CudaKernel):
    """The `csrc/blur.cu` kernel, with its tap tables on each device."""

    def __init__(self):
        super().__init__(
            "blur", "kanter_blur_wrap_f32",
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        )
        self._taps: dict = {}  # (sigma, device) → f32 tap tensor on the device

    def device_taps(self, sigma: float, device: torch.device) -> torch.Tensor:
        key = (round(float(sigma), 6), str(device))
        with self._lock:
            taps = self._taps.get(key)
            if taps is None:
                taps = torch.from_numpy(_taps_for(sigma)).to(device)
                self._taps[key] = taps
            return taps


BLUR_KERNEL = CudaBlurKernel()
# the block entry of the same library; its own launch count
BLUR_BLOCK_KERNEL = CudaKernel(
    "blur", "kanter_blur_block_f32",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def _check_cuda_plane(t: torch.Tensor, what: str, shape=None) -> None:
    if not (
        t.is_cuda and t.dtype == torch.float32 and t.dim() == 2 and t.is_contiguous()
        and (shape is None or tuple(t.shape) == tuple(shape))
    ):
        want = "" if shape is None else f" of shape {tuple(shape)}"
        raise TexProError(
            ErrorKind.GENERIC,
            f"blur kernel needs contiguous 2-D float32 CUDA tensors{want}; {what} is "
            f"{t.dtype} {tuple(t.shape)} on {t.device}",
        )


def blur_plane_cuda(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """The hand-written CUDA blur of one contiguous `[H, W]` f32 plane on a
    CUDA device. Launches on the current stream; raises if the input is not
    such a plane, or if the kernel does not build or launch."""
    _check_cuda_plane(plane, "the plane")
    h, w = plane.shape
    kernel = BLUR_KERNEL.entry()
    taps = BLUR_KERNEL.device_taps(sigma, plane.device)
    scratch = torch.empty_like(plane)
    out = torch.empty_like(plane)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream(plane.device).cuda_stream
        rc = kernel(
            plane.data_ptr(), scratch.data_ptr(), out.data_ptr(), taps.data_ptr(),
            len(taps), h, w, stream,
        )
    if rc != 0:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"blur kernel launch failed: CUDA error {rc}"
        )
    BLUR_KERNEL.count_launch()
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
    kernel = BLUR_BLOCK_KERNEL.entry()
    taps_t = BLUR_KERNEL.device_taps(sigma, block.device)
    scratch = torch.empty_like(block)
    out = torch.empty_like(block)
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream(block.device).cuda_stream
        rc = kernel(
            top.data_ptr(), block.data_ptr(), bot.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), taps_t.data_ptr(), len(taps), block_h, w, stream,
        )
    if rc != 0:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"blur block kernel launch failed: CUDA error {rc}"
        )
    BLUR_BLOCK_KERNEL.count_launch()
    return out


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
    halos = sp.ring_halos((len(taps) - 1) // 2)
    return ShardedPlane(
        mesh, [blur_block(band, top, bot, sigma) for band, (top, bot) in zip(sp.bands, halos)]
    )


def blur_plane(plane, sigma: float):
    """Separable wrap blur of one `[H, W]` f32 plane: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor, the sharded form for a
    `ShardedPlane`."""
    if isinstance(plane, ShardedPlane):
        return blur_plane_sharded(plane, sigma)
    if plane.device.type == "cpu":
        return blur_plane_plain(plane, sigma)
    if plane.device.type == "cuda":
        return blur_plane_cuda(plane.contiguous(), sigma)
    raise TexProError(
        ErrorKind.NODE_PROCESSING, f"no blur for device {plane.device}"
    )
