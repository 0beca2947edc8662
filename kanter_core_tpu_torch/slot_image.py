"""Channel-plane images.

Mirrors `vismut_core/src/slot_image.rs` (through `kanter_core_tpu/slot_image.py`):
an image is either Gray (one f32 plane) or Rgba (four f32 planes
`[r, g, b, a]`). Planes are `[H, W]` tensors in tiered `PlaneBuffer`s and may
be shared between images (zero-copy aliasing, e.g. SeparateRgba / `as_type`).

The u8 export reproduces the reference bit-for-bit, including its NaN
behavior: `f32_to_u8` is `((value.clamp(0,1) * 255.).min(255.)) as u8`
(`slot_image.rs:142-144`) where Rust's `min` maps NaN to 255 and `as u8`
truncates toward zero. It runs as plain torch on the planes' device; a
row-sharded image is converted shard by shard and only its packed u8 rows
are gathered to the host (one `export` gather per image). `to_u8_srgb`
applies the reference's `srgb_to_linear` first, with the pow of the
planes' device (`ops.exact_math.pow_f32`: glibc on the CPU, `ds_pow` on a
card), as the JAX package's exports do on its two backends.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterable

import numpy as np
import torch

from .errors import ErrorKind, TexProError
from .geometry import Size
from .ops.common import f32_to_u8, rgb_mean
from .ops.exact_math import pow_f32
from .parallel.sharded import ShardedPlane, map_bands
from .transient_buffer import PlaneBuffer, Tier, plane_from_device, plane_from_host


def _pack_u32(r8, g8, b8, a8) -> torch.Tensor:
    """Elementwise `r | g<<8 | b<<16 | a<<24` in int32 (same bits as the
    JAX package's u32 pack); the host views the little-endian words as
    interleaved RGBA bytes for free."""
    r, g, b, a = (p.to(torch.int32) for p in (r8, g8, b8, a8))
    return r | (g << 8) | (b << 16) | (a << 24)


def gray_to_u8(g: torch.Tensor) -> torch.Tensor:
    v = f32_to_u8(g)
    return _pack_u32(v, v, v, torch.full_like(v, 255))


def rgba_to_u8(r, g, b, a) -> torch.Tensor:
    return _pack_u32(f32_to_u8(r), f32_to_u8(g), f32_to_u8(b), f32_to_u8(a))


_F32_0_055 = float(np.float32(0.055))
_F32_0_04045 = float(np.float32(0.04045))


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """The reference's formula (`slot_data.rs:100-109`, applied by
    `to_u8_srgb` despite the method's name, `slot_image.rs:172-175`); every
    division is by a full tensor, every constant the f32 one."""
    low = x / torch.full_like(x, 12.92)
    high = pow_f32((x + _F32_0_055) / torch.full_like(x, 1.055), torch.full_like(x, 2.4))
    return torch.where(x <= 0.0, x, torch.where(x <= _F32_0_04045, low, high))


def _srgb_u8(x: torch.Tensor) -> torch.Tensor:
    return f32_to_u8(srgb_to_linear(torch.clamp(x, 0.0, 1.0)))


def gray_to_u8_srgb(g: torch.Tensor) -> torch.Tensor:
    v = _srgb_u8(g)
    return _pack_u32(v, v, v, torch.full_like(v, 255))


def rgba_to_u8_srgb(r, g, b, a) -> torch.Tensor:
    return _pack_u32(_srgb_u8(r), _srgb_u8(g), _srgb_u8(b), f32_to_u8(a))


def _as_plane(obj) -> PlaneBuffer:
    if isinstance(obj, PlaneBuffer):
        return obj
    if isinstance(obj, np.ndarray):
        return plane_from_host(obj)
    return plane_from_device(obj)  # a torch.Tensor


_uid_counter = itertools.count(1)
_uid_lock = threading.Lock()


class SlotImage:
    """Gray (1 plane) or Rgba (4 planes, `[r, g, b, a]`)."""

    __slots__ = ("planes", "uid")

    def __init__(self, planes: list[PlaneBuffer]):
        if len(planes) not in (1, 4):
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        self.planes = planes
        # stable identity token for recipe hashing — unlike id(), never
        # reused after garbage collection
        with _uid_lock:
            self.uid = next(_uid_counter)

    # --- constructors (`slot_image.rs:28-102`) ---
    @staticmethod
    def Gray(plane) -> "SlotImage":
        return SlotImage([_as_plane(plane)])

    @staticmethod
    def Rgba(planes: Iterable) -> "SlotImage":
        planes = [_as_plane(p) for p in planes]
        if len(planes) != 4:
            raise TexProError(ErrorKind.INVALID_BUFFER_COUNT)
        return SlotImage(planes)

    @staticmethod
    def from_value(size: Size, value: float, rgba: bool) -> "SlotImage":
        shape = (size.height, size.width)
        if rgba:
            return SlotImage(
                [
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, value, dtype=np.float32)),
                    plane_from_host(np.full(shape, 1.0, dtype=np.float32)),
                ]
            )
        return SlotImage([plane_from_host(np.full(shape, value, dtype=np.float32))])

    def from_self(self) -> "SlotImage":
        return SlotImage(list(self.planes))

    # --- introspection ---
    def is_rgba(self) -> bool:
        return len(self.planes) == 4

    def size(self) -> Size:
        return self.planes[0].size

    def bufs(self) -> list[PlaneBuffer]:
        return list(self.planes)

    def __eq__(self, other):
        if isinstance(other, SlotImage):
            return self.is_rgba() == other.is_rgba()  # discriminant-only eq
        return NotImplemented

    def __hash__(self):
        return hash(self.is_rgba())

    # --- u8 export (`slot_image.rs:146-207`) ---
    def _tensors(self) -> list[torch.Tensor]:
        """The planes as tensors: on their device when any is resident
        there, else on the CPU (spilled planes are not promoted back to the
        device just to be exported)."""
        if all(p.tier != Tier.DEVICE for p in self.planes):
            return [torch.from_numpy(p.host_data()) for p in self.planes]
        return [p.data() for p in self.planes]

    def _export(self, gray_fn, rgba_fn) -> np.ndarray:
        planes = self._tensors()
        out = map_bands(rgba_fn if self.is_rgba() else gray_fn, *planes)
        out = out.gather("cpu", "export") if isinstance(out, ShardedPlane) else out.cpu()
        # little-endian int32 words → interleaved RGBA bytes, zero-copy
        return np.ascontiguousarray(out.numpy()).view(np.uint8).reshape(-1)

    def to_u8(self) -> np.ndarray:
        """Flat row-major interleaved RGBA u8 pixels."""
        return self._export(gray_to_u8, rgba_to_u8)

    def to_u8_srgb(self) -> np.ndarray:
        """`to_u8` of the colour planes through `srgb_to_linear` (alpha
        as it is)."""
        return self._export(gray_to_u8_srgb, rgba_to_u8_srgb)

    def to_numpy_rgba(self) -> np.ndarray:
        """`[H, W, 4]` u8 view of `to_u8` (convenience)."""
        size = self.size()
        return self.to_u8().reshape(size.height, size.width, 4)

    # --- type coercion (`slot_image.rs:212-256`) ---
    def as_type(self, rgba: bool) -> "SlotImage":
        if self.is_rgba() == rgba:
            return SlotImage(list(self.planes))
        if not self.is_rgba():
            # gray → rgba: alias the gray plane ×3, fresh alpha=1 plane
            g = self.planes[0]
            alpha = plane_from_device(map_bands(torch.ones_like, g.data()))
            return SlotImage([g, g, g, alpha])
        r, g, b = (self.planes[i].data() for i in range(3))
        return SlotImage([plane_from_device(map_bands(rgb_mean, r, g, b))])
