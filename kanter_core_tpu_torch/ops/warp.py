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

The mesh form (`TextureProcessor(mesh=...)`), `warp_planes_mesh`, is the
port of the JAX package's `warp_planes_mesh` and its
`pallas_warp._warp_pallas_sharded`: the strength clamp bounds the
displacement, so a ring exchange of ±`warp_halo(intensity)` rows
(`ShardedPlane.ring_halos`) gives every shard the rows it samples, and each
shard runs one block launch on its device with its global first row:
`warp_block_plain` / `warp_block_cuda` (the entry `kanter_warp_block_f32`
of `csrc/warp.cu`, the port of `pallas_warp._warp_block`). Where `fits_mesh`
fails (an unbounded intensity, blocks shorter than the halo, fewer than two
shards), the planes are gathered to the mesh's first device, warped by the
dense kernel and sharded again, counted as `warp_gate` gathers — GSPMD's
all-gather in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..build import CudaKernel
from ..errors import ErrorKind, TexProError
from ..parallel.sharded import ShardedPlane, shard_planes_rows
from .transform import _QUARTER, bilinear_wrap_gather


def warp_halo(intensity):
    """The JAX package's `warp_halo`, verbatim: the row halo that bounds the
    displacement (`|dy| ≤ |intensity|/2`, +1 for the bilinear row pair, +1
    for coordinate slop), rounded up to a power of two (≥4); None for a
    non-finite intensity."""
    intensity = float(intensity)
    if not math.isfinite(intensity):
        return None
    need = math.ceil(abs(intensity) * 0.5) + 2
    return max(4, 1 << (need - 1).bit_length())


def fits_mesh(h: int, n: int, halo) -> bool:
    """The JAX package's `fits_mesh`, verbatim: a bounded halo, ≥2 shards,
    rows divide the mesh axis, each block covers the halo in one ring hop,
    and the halo-extended block is no taller than the plane."""
    return (
        halo is not None
        and n >= 2
        and h % n == 0
        and h // n >= halo
        and h // n + 2 * halo <= h
    )


def warp_bindings(payload) -> dict:
    """`k = intensity·(cos θ, sin θ)` as f32[2], host-computed in f64 with
    one rounding, and the row `halo` of the mesh form (`warp_halo`) — the
    JAX package's `warp_bindings` without the TPU kernel's pair table."""
    deg, intensity = (float(v) for v in payload)
    d = deg % 360.0
    if d in _QUARTER:
        cos, sin = _QUARTER[d]
    else:
        r = np.deg2rad(np.float64(d))
        cos, sin = float(np.cos(r)), float(np.sin(r))
    with np.errstate(invalid="ignore"):  # inf · 0 on an axis is NaN, as in JAX
        k = np.float64(intensity) * np.asarray([cos, sin], np.float64)
    return {"k": k.astype(np.float32), "halo": warp_halo(intensity)}


def _coords(strength: torch.Tensor, k, rows: torch.Tensor):
    """Continuous sample coordinates `(u, v)` of the output pixels at the
    f32 global `rows` (a column) and every column."""
    w = strength.shape[1]
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    ms = torch.clamp(strength, 0.0, 1.0)
    ms = torch.where(torch.isnan(strength), 0.5, ms)
    d = ms - 0.5
    cols = torch.arange(w, dtype=torch.float32, device=strength.device)[None, :]
    return cols + d * kx, rows + d * ky


def warp_planes_plain(planes, strength: torch.Tensor, k) -> tuple:
    """The plain torch warp of `[H, W]` planes by an `[H, W]` strength map."""
    h, w = planes[0].shape
    rows = torch.arange(h, dtype=torch.float32, device=strength.device)[:, None]
    u, v = _coords(strength, k, rows)
    return bilinear_wrap_gather(planes, u, v, h, w)


def warp_block_plain(block_planes, strength_blk: torch.Tensor, k, tops, bots,
                     row_origin: int, h: int) -> tuple:
    """The plain torch warp of one row block of an `h`-row canvas: output
    row `i` is global row `row_origin + i`; `tops[p]`/`bots[p]` are the
    `halo` rows before and after plane `p`'s block. The source row goes
    through the JAX package's `row_local`, `(y − row_origin + halo) mod h`,
    into the window `[top; block; bot]`."""
    block_h, w = strength_blk.shape
    halo = tops[0].shape[0]
    rows = (torch.arange(block_h, dtype=torch.int32, device=strength_blk.device)
            + int(row_origin)).to(torch.float32)[:, None]
    u, v = _coords(strength_blk, k, rows)
    windows = [torch.cat([t, p, b], dim=0) for t, p, b in zip(tops, block_planes, bots)]

    def row_local(y):
        return torch.remainder(y - int(row_origin) + halo, h)

    return bilinear_wrap_gather(windows, u, v, h, w, row_local=row_local)


WARP_KERNEL = CudaKernel(
    "warp", "kanter_warp_bilinear_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)

# the block entry of the same library; its own launch count
WARP_BLOCK_KERNEL = CudaKernel(
    "warp", "kanter_warp_block_f32",
    [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
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


def warp_block_cuda(block_planes, strength_blk: torch.Tensor, k, tops, bots,
                    row_origin: int, h: int) -> tuple:
    """The hand-written CUDA warp of one row block (the
    `kanter_warp_block_f32` entry of `csrc/warp.cu`): one launch per group
    of up to four planes, on the block's device and current stream. Raises
    unless every tensor is a contiguous f32 plane of its shape on that
    device and the halo covers the displacement (`halo ≥ ⌈|ky|/2⌉ + 2`, so
    no sampled row leaves the window)."""
    block_h, w = strength_blk.shape
    halo = tops[0].shape[0]
    _check_plane(strength_blk, "the strength block", (block_h, w))
    for p, t, b in zip(block_planes, tops, bots):
        _check_plane(p, "a block", (block_h, w))
        _check_plane(t, "a top halo", (halo, w))
        _check_plane(b, "a bottom halo", (halo, w))
    device = strength_blk.device
    if any(x.device != device for x in (*block_planes, *tops, *bots)):
        raise TexProError(ErrorKind.GENERIC, f"warp block kernel: every tensor must lie on {device}")
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    if not (math.isfinite(ky) and halo >= math.ceil(abs(ky) * 0.5) + 2):
        raise TexProError(
            ErrorKind.GENERIC, f"warp block kernel: a halo of {halo} rows does not cover ky={ky}"
        )
    kernel = WARP_BLOCK_KERNEL.entry()
    outs = [torch.empty_like(p) for p in block_planes]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for start in range(0, len(block_planes), _MAX_PLANES):
            group = range(start, min(start + _MAX_PLANES, len(block_planes)))
            pad = [None] * (_MAX_PLANES - len(group))
            ptrs = []
            for seq in (tops, block_planes, bots, outs):
                ptrs += [seq[i].data_ptr() for i in group] + pad
            rc = kernel(*ptrs, len(group), strength_blk.data_ptr(), kx, ky,
                        block_h, w, h, int(row_origin), halo, stream)
            if rc != 0:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING,
                    f"warp block kernel launch failed: CUDA error {rc}",
                )
            WARP_BLOCK_KERNEL.count_launch()
    return tuple(outs)


def warp_block(block_planes, strength_blk: torch.Tensor, k, tops, bots,
               row_origin: int, h: int) -> tuple:
    """Warp of one row block with explicit halos: the plain version for CPU
    tensors, the CUDA block kernel for CUDA tensors."""
    if strength_blk.device.type == "cpu":
        return warp_block_plain(block_planes, strength_blk, k, tops, bots, row_origin, h)
    if strength_blk.device.type == "cuda":
        c = [[x.contiguous() for x in seq] for seq in (block_planes, tops, bots)]
        return warp_block_cuda(c[0], strength_blk.contiguous(), k, c[1], c[2], row_origin, h)
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no warp for device {strength_blk.device}")


def warp_planes_mesh(planes, strength: ShardedPlane, k, halo) -> tuple:
    """Warp of row-sharded planes by a row-sharded strength map: a ring
    exchange of ±`halo` rows per plane, then one block launch per shard
    (per group of four planes) with the shard's global first row. Where
    `fits_mesh` fails, every plane and the strength map are gathered to the
    mesh's first device (`warp_gate`), warped whole and sharded again."""
    if not (isinstance(strength, ShardedPlane) and all(
            isinstance(p, ShardedPlane) and p.mesh == strength.mesh and p.shape == strength.shape
            for p in planes)):
        raise TexProError(
            ErrorKind.GENERIC,
            "the mesh warp needs the planes and the strength map row-sharded alike; "
            "place them with parallel.place or shard_planes_rows",
        )
    mesh = strength.mesh
    h = strength.shape[0]
    if not fits_mesh(h, mesh.n, halo):
        first = mesh.devices[0]
        outs = warp_planes([p.gather(first, "warp_gate") for p in planes],
                           strength.gather(first, "warp_gate"), k)
        return tuple(shard_planes_rows(mesh, o) for o in outs)
    halos = [p.ring_halos(halo) for p in planes]
    block_h = strength.band_rows
    per_shard = [
        warp_block([p.bands[j] for p in planes], strength.bands[j], k,
                   [hs[j][0] for hs in halos], [hs[j][1] for hs in halos], j * block_h, h)
        for j in range(mesh.n)
    ]
    return tuple(ShardedPlane(mesh, bands) for bands in zip(*per_shard))


def warp_planes(planes, strength, k, halo=None) -> tuple:
    """Warp of an image's planes by a strength map of the same size: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors, the
    mesh form (with the row `halo` of `warp_bindings`) when any is a
    `ShardedPlane`, which all must then be."""
    if any(isinstance(x, ShardedPlane) for x in (strength, *planes)):
        return warp_planes_mesh(planes, strength, k, halo)
    if strength.device.type == "cpu":
        return warp_planes_plain(planes, strength, k)
    if strength.device.type == "cuda":
        return warp_planes_cuda([p.contiguous() for p in planes], strength.contiguous(), k)
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no warp for device {strength.device}")
