"""Noise node: seamlessly tiling value-noise / FBM source.

Port of `kanter_core_tpu/ops/noise.py`. Each lattice corner's value is a
lowbias32 avalanche hash of `(x, y, seed)`; lattice coordinates wrap modulo
`cells·2^k` per octave, so the plane tiles; octaves are blended with a
quintic smootherstep and summed with geometric amplitudes, then normalized
by the amplitude sum.

The hash is u32 wrap-around arithmetic. Torch cannot shift a `uint32` tensor
on the CPU, so the port carries the hash in `int64` and keeps the low 32
bits after every multiply and xor (`_mul_u32` splits each constant into
16-bit halves, so no int64 product overflows). The float path keeps the JAX
function's op order: every product is rounded on its own before the add it
feeds, and the final normalization divides by a full tensor.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF


def noise_bindings(payload) -> dict:
    """Per-octave frequency scales (f64, rounded once to f32), lattice wrap
    periods, the row/column index vectors and the seed/persistence scalars;
    the same values as the JAX package's `noise_bindings`."""
    width, height, cells, octaves, seed, persistence = payload
    ks = np.arange(int(octaves))
    freq = (int(cells) << ks.astype(np.int64)).astype(np.float64)
    return {
        "rows": np.arange(int(height), dtype=np.int32),
        "cols": np.arange(int(width), dtype=np.int32),
        "fx": (freq / np.float64(width)).astype(np.float32),
        "fy": (freq / np.float64(height)).astype(np.float32),
        "periods": (int(cells) << ks).astype(np.int32),
        "seed": np.uint32(int(seed) & 0xFFFFFFFF),
        "persistence": np.float32(persistence),
    }


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """`(a · c) mod 2^32` for int64 `a` in [0, 2^32) and a u32 constant `c`,
    with every intermediate below 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _hash01(x: torch.Tensor, y: torch.Tensor, seed: int) -> torch.Tensor:
    """Lattice value in [0, 1) of int64 cell indices `x`, `y` (broadcast)
    and a u32 `seed`: the JAX package's `_hash01`, bit for bit."""
    s = (int(seed) * 0xC2B2AE3D) & _MASK
    h = _mul_u32(x, 0x9E3779B1) ^ _mul_u32(y, 0x85EBCA77) ^ s
    h = h ^ (h >> 16)
    h = _mul_u32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul_u32(h, _M2)
    h = h ^ (h >> 16)
    # top 24 bits → f32 in [0, 1): exact conversion, power-of-two scale
    return (h >> 8).to(torch.float32) * 2.0**-24


def _smoother(f: torch.Tensor) -> torch.Tensor:
    """Quintic smootherstep f³(f(6f−15)+10)."""
    inner = f * 6.0 - 15.0
    poly = f * inner + 10.0
    f3 = (f * f) * f
    return f3 * poly


def noise_plane(rows, cols, seed, persistence, fx, fy, periods) -> torch.Tensor:
    """FBM value-noise plane `[len(rows), len(cols)]` on the device of
    `rows`/`cols` (int32 index tensors). `seed` is a u32, `persistence` an
    f32, `fx`/`fy` f32[octaves] numpy frequency scales, `periods`
    i32[octaves] numpy wrap periods."""
    cy = rows.to(torch.float32) + 0.5
    cx = cols.to(torch.float32) + 0.5
    seed = int(seed)
    persistence = np.float32(persistence)
    acc = None
    amp = np.float32(1.0)
    amp_sum = np.float32(0.0)
    for k in range(len(fx)):
        u = cx * float(fx[k])
        v = cy * float(fy[k])
        xi = torch.floor(u)
        yi = torch.floor(v)
        fu = u - xi
        fv = v - yi
        period = int(periods[k])
        x0 = torch.remainder(xi.to(torch.int32), period)
        y0 = torch.remainder(yi.to(torch.int32), period)
        x1 = torch.where(x0 + 1 == period, 0, x0 + 1)
        y1 = torch.where(y0 + 1 == period, 0, y0 + 1)
        ks = (seed + k * 0x68E31DA4) & _MASK
        x0u, x1u = x0.to(torch.int64)[None, :], x1.to(torch.int64)[None, :]
        y0u, y1u = y0.to(torch.int64)[:, None], y1.to(torch.int64)[:, None]
        n00 = _hash01(x0u, y0u, ks)
        n10 = _hash01(x1u, y0u, ks)
        n01 = _hash01(x0u, y1u, ks)
        n11 = _hash01(x1u, y1u, ks)
        sx = _smoother(fu)[None, :]
        sy = _smoother(fv)[:, None]
        nx0 = n00 + sx * (n10 - n00)
        nx1 = n01 + sx * (n11 - n01)
        nxy = nx0 + sy * (nx1 - nx0)
        contrib = nxy * float(amp)
        acc = contrib if acc is None else acc + contrib
        amp_sum = np.float32(amp_sum + amp)
        amp = np.float32(amp * persistence)
    return acc / torch.full_like(acc, float(amp_sum))
