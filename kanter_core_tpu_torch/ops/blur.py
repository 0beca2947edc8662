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


def blur_plane_cuda(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """The hand-written CUDA blur of one contiguous `[H, W]` f32 plane on a
    CUDA device. Launches on the current stream; raises if the input is not
    such a plane, or if the kernel does not build or launch."""
    if not (
        plane.is_cuda and plane.dtype == torch.float32 and plane.dim() == 2
        and plane.is_contiguous()
    ):
        raise TexProError(
            ErrorKind.GENERIC,
            "blur kernel needs a contiguous 2-D float32 CUDA tensor, got "
            f"{plane.dtype} {tuple(plane.shape)} on {plane.device}",
        )
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


def blur_plane(plane: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable wrap blur of one `[H, W]` f32 plane: the plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    if plane.device.type == "cpu":
        return blur_plane_plain(plane, sigma)
    if plane.device.type == "cuda":
        return blur_plane_cuda(plane.contiguous(), sigma)
    raise TexProError(
        ErrorKind.NODE_PROCESSING, f"no blur for device {plane.device}"
    )
