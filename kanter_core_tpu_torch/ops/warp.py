"""Warp node: directional displacement by a gray strength map.

Port of `kanter_core_tpu/ops/warp.py`. Output pixel `(x, y)` bilinearly
samples the input, wrapping toroidally, at `(x + kx·d, y + ky·d)` with
`d = clip(m, 0, 1) − 0.5` (NaN strength ⇒ 0.5, no displacement) and
`(kx, ky) = intensity·(cos θ, sin θ)` computed on the host in f64 and
rounded once (quarter turns from the exact table). Two implementations:

- `warp_planes_plain`: plain torch, the JAX package's coordinate math and
  `transform.bilinear_wrap_gather`;
- `warp_planes_cuda`: the hand-written kernel `csrc/warp.cu`, a direct
  gather that computes the coordinates once per pixel and samples up to
  four planes in one launch. It replaces the JAX package's Pallas kernel
  (`pallas_warp.warp_pallas`), whose staircase pair table and halo buckets
  existed only for XLA:TPU's slow gathers; the port has neither.

`warp_planes` takes the plain version for CPU tensors and the kernel for
CUDA tensors (which raises if it cannot build or launch); no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..build import CudaKernel
from ..errors import ErrorKind, TexProError
from .transform import _QUARTER, bilinear_wrap_gather


def warp_bindings(payload) -> dict:
    """`k = intensity·(cos θ, sin θ)` as f32[2], host-computed in f64 with
    one rounding (the JAX package's `warp_bindings` without the TPU
    kernel's pair table)."""
    deg, intensity = (float(v) for v in payload)
    d = deg % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    with np.errstate(invalid="ignore"):  # inf · 0 on an axis is NaN, as in JAX
        k = np.float64(intensity) * np.asarray([cos, sin], np.float64)
    return {"k": k.astype(np.float32)}


def warp_planes_plain(planes, strength: torch.Tensor, k) -> tuple:
    """The plain torch warp of `[H, W]` planes by an `[H, W]` strength map."""
    h, w = planes[0].shape
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    ms = torch.clamp(strength, 0.0, 1.0)
    ms = torch.where(torch.isnan(strength), 0.5, ms)
    d = ms - 0.5
    cols = torch.arange(w, dtype=torch.float32, device=strength.device)[None, :]
    rows = torch.arange(h, dtype=torch.float32, device=strength.device)[:, None]
    u = cols + d * kx
    v = rows + d * ky
    return bilinear_wrap_gather(planes, u, v, h, w)


WARP_KERNEL = CudaKernel(
    "warp", "kanter_warp_bilinear_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)

_MAX_PLANES = 4  # planes per launch (csrc/warp.cu kMaxPlanes)


def _check_plane(t: torch.Tensor, what: str, shape) -> None:
    if not (
        t.is_cuda and t.dtype == torch.float32 and t.dim() == 2
        and t.is_contiguous() and tuple(t.shape) == tuple(shape)
    ):
        raise TexProError(
            ErrorKind.GENERIC,
            f"warp kernel needs contiguous {tuple(shape)} float32 CUDA tensors; "
            f"{what} is {t.dtype} {tuple(t.shape)} on {t.device}",
        )


def warp_planes_cuda(planes, strength: torch.Tensor, k) -> tuple:
    """The hand-written CUDA warp: one launch per group of up to four
    planes (one for a gray or an RGBA image), on the current stream."""
    shape = tuple(planes[0].shape)
    _check_plane(strength, "the strength map", shape)
    for p in planes:
        _check_plane(p, "a plane", shape)
    h, w = shape
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    kernel = WARP_KERNEL.entry()
    outs = [torch.empty_like(p) for p in planes]
    with torch.cuda.device(strength.device):
        stream = torch.cuda.current_stream(strength.device).cuda_stream
        for start in range(0, len(planes), _MAX_PLANES):
            group = range(start, min(start + _MAX_PLANES, len(planes)))
            ins = [planes[i].data_ptr() for i in group]
            dsts = [outs[i].data_ptr() for i in group]
            pad = [None] * (_MAX_PLANES - len(group))
            rc = kernel(*ins, *pad, *dsts, *pad, len(group), strength.data_ptr(),
                        kx, ky, h, w, stream)
            if rc != 0:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING, f"warp kernel launch failed: CUDA error {rc}"
                )
            WARP_KERNEL.count_launch()
    return tuple(outs)


def warp_planes(planes, strength: torch.Tensor, k) -> tuple:
    """Warp of an image's planes by a strength map of the same size: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if strength.device.type == "cpu":
        return warp_planes_plain(planes, strength, k)
    if strength.device.type == "cuda":
        return warp_planes_cuda([p.contiguous() for p in planes], strength.contiguous(), k)
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no warp for device {strength.device}")
