"""Bit-exact separable resampling + resize-policy resolution.

Port of `kanter_core_tpu/ops/resize.py`. Replicates `image-0.24.0`'s
`imageops::resize` as used by the reference
(`vismut_core/src/shared.rs:141-216`) on f32 `Luma` planes:

- vertical pass then horizontal pass (sample.rs `resize`);
- per output coordinate: `inputx = (outx + 0.5) * ratio`, window
  `[floor(inputx - support·sratio), ceil(inputx + support·sratio))` clamped,
  kernel evaluated at `(i - (inputx - 0.5)) / sratio`, weights normalized by
  their f32 running sum;
- accumulation `t += p * w` in tap order, f32;
- each pass clamps to the f32 `Primitive` bounds `[0, 1]`.

All weight arithmetic is done in strict IEEE f32 (numpy float32 scalar ops)
matching Rust's evaluation order, so outputs are bit-identical. Transcendental
kernels (Gaussian `exp`, Lanczos `sin`) call glibc's FLOAT functions
(`expf`/`sinf` via ctypes) — the same symbols Rust's `f32::exp`/`f32::sin`
lower to on linux-gnu — because the earlier f64-compute-then-round route
double-rounds on ~1/36k weights (measured 1-ulp drift vs the independent C
oracle, tests/test_resize_c_oracle.py); if libm cannot be loaded the f64
route remains as fallback.

The weights (`resample_weights`) and the policy resolution
(`calculate_size`) are the JAX package's host numpy code, verbatim. The
device-side application is plain torch: one tap at a time, a separately
rounded product then an add (eager torch never contracts them into an FMA),
so the tap accumulation order is the reference's; padded taps multiply by a
weight of exactly 0.0 and are masked to avoid NaN from `0 * inf`.

Policy resolution mirrors `calculate_size` (`shared.rs:61-139`), including
Rust's `max_by` returning the *last* maximal element on ties.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..errors import ErrorKind, TexProError
from ..geometry import Size
from ..node import ResizeFilter, ResizePolicy, ResizePolicyKind

f32 = np.float32

_SUPPORT = {
    ResizeFilter.NEAREST: f32(0.0),
    ResizeFilter.TRIANGLE: f32(1.0),
    ResizeFilter.CATMULL_ROM: f32(2.0),
    ResizeFilter.GAUSSIAN: f32(3.0),
    ResizeFilter.LANCZOS3: f32(3.0),
}

_PI = f32(math.pi)  # f32::consts::PI

# glibc float transcendentals (the exact symbols Rust f32 math lowers to
# on linux-gnu). expf/sinf have been correctly rounded since glibc 2.28,
# so these are the crate's bits; the f64 fallback differs only in
# astronomically rare double-rounding cases (~1/36k kernel evaluations).
try:
    import ctypes as _ctypes

    _libm = _ctypes.CDLL("libm.so.6")
    _libm.expf.restype = _ctypes.c_float
    _libm.expf.argtypes = [_ctypes.c_float]
    _libm.sinf.restype = _ctypes.c_float
    _libm.sinf.argtypes = [_ctypes.c_float]

    def _expf(x: f32) -> f32:
        return f32(_libm.expf(float(x)))

    def _sinf(x: f32) -> f32:
        return f32(_libm.sinf(float(x)))

except OSError:  # pragma: no cover — non-glibc host

    def _expf(x: f32) -> f32:
        return f32(math.exp(float(x)))

    def _sinf(x: f32) -> f32:
        return f32(math.sin(float(x)))


def _box_kernel(x: f32) -> f32:
    return f32(1.0)


def _triangle_kernel(x: f32) -> f32:
    ax = abs(x)
    if ax < f32(1.0):
        return f32(f32(1.0) - ax)
    return f32(0.0)


def _bc_cubic_spline(x: f32, b: f32, c: f32) -> f32:
    a = abs(x)
    if a < f32(1.0):
        a2 = f32(a * a)
        a3 = f32(a2 * a)
        c3 = f32(f32(f32(12.0) - f32(9.0) * b) - f32(6.0) * c)
        c2 = f32(f32(f32(-18.0) + f32(12.0) * b) + f32(6.0) * c)
        c0 = f32(f32(6.0) - f32(2.0) * b)
        k = f32(f32(f32(c3 * a3) + f32(c2 * a2)) + c0)
    elif a < f32(2.0):
        a2 = f32(a * a)
        a3 = f32(a2 * a)
        c3 = f32(-b - f32(6.0) * c)
        c2 = f32(f32(6.0) * b + f32(30.0) * c)
        c1 = f32(f32(-12.0) * b - f32(48.0) * c)
        c0 = f32(f32(8.0) * b + f32(24.0) * c)
        k = f32(f32(f32(f32(c3 * a3) + f32(c2 * a2)) + f32(c1 * a)) + c0)
    else:
        k = f32(0.0)
    return f32(k / f32(6.0))


def _catmullrom_kernel(x: f32) -> f32:
    return _bc_cubic_spline(x, f32(0.0), f32(0.5))


def _gaussian(x: f32, r: f32) -> f32:
    # ((2π).sqrt() * r).recip() * exp(-x² / (2 r²))
    two_pi = f32(f32(2.0) * _PI)
    norm = f32(f32(1.0) / f32(f32(math.sqrt(float(two_pi))) * r))
    x2 = f32(x * x)
    r2 = f32(r * r)
    arg = f32(-x2 / f32(f32(2.0) * r2))
    return f32(norm * _expf(arg))


def _gaussian_kernel(x: f32) -> f32:
    return _gaussian(x, f32(0.5))


def _sinc(t: f32) -> f32:
    a = f32(t * _PI)
    if t == f32(0.0):
        return f32(1.0)
    return f32(_sinf(a) / a)


def _lanczos3_kernel(x: f32) -> f32:
    if abs(x) < f32(3.0):
        return f32(_sinc(x) * _sinc(f32(x / f32(3.0))))
    return f32(0.0)


_KERNELS = {
    ResizeFilter.NEAREST: _box_kernel,
    ResizeFilter.TRIANGLE: _triangle_kernel,
    ResizeFilter.CATMULL_ROM: _catmullrom_kernel,
    ResizeFilter.GAUSSIAN: _gaussian_kernel,
    ResizeFilter.LANCZOS3: _lanczos3_kernel,
}


@functools.lru_cache(maxsize=4096)
def resample_weights(in_len: int, out_len: int, filt: ResizeFilter):
    """(lefts[int32 out_len], weights[f32 out_len × max_taps]) for one axis.

    Padded taps carry weight exactly 0.0 and indices clamped in-range.
    """
    kernel = _KERNELS[filt]
    support = _SUPPORT[filt]

    ratio = f32(f32(in_len) / f32(out_len))
    sratio = ratio if ratio >= f32(1.0) else f32(1.0)
    src_support = f32(support * sratio)

    lefts = np.zeros(out_len, dtype=np.int32)
    all_ws = []
    max_taps = 1
    for outx in range(out_len):
        inputx = f32(f32(f32(outx) + f32(0.5)) * ratio)
        left = int(math.floor(float(f32(inputx - src_support))))
        left = max(0, min(left, in_len - 1))
        right = int(math.ceil(float(f32(inputx + src_support))))
        right = max(left + 1, min(right, in_len))
        inputx = f32(inputx - f32(0.5))

        ws = []
        total = f32(0.0)
        for i in range(left, right):
            w = kernel(f32(f32(f32(i) - inputx) / sratio))
            ws.append(w)
            total = f32(total + w)
        ws = [f32(w / total) for w in ws]

        lefts[outx] = left
        all_ws.append(ws)
        max_taps = max(max_taps, len(ws))

    weights = np.zeros((out_len, max_taps), dtype=np.float32)
    for outx, ws in enumerate(all_ws):
        weights[outx, : len(ws)] = ws
    return lefts, weights


def _apply_axis(plane: torch.Tensor, lefts, weights, in_len: int, dim: int) -> torch.Tensor:
    """Resample along `dim` (-2: rows, -1: columns) of an `[..., H, W]`
    tensor; tap order preserved, zero-weight taps masked, the pass clamped
    to [0, 1]. The JAX package's horizontal pass, over the transpose, is
    this one element for element.

    KNOWN DIVERGENCE from the Rust crate (non-finite planes only, kept
    identical to the JAX package): the zero-weight mask exists because tap
    windows are padded to `max_taps` with w=0.0, but it also masks genuine
    in-window zero weights (integer-ratio Lanczos3/CatmullRom sinc zeros),
    where Rust would propagate a NaN pixel."""
    device = plane.device
    out_len, taps = weights.shape
    # a tap's weights along the resampled axis, broadcast along the other
    weights_t = torch.from_numpy(weights if dim == -2 else np.ascontiguousarray(weights.T))
    weights_t = weights_t.to(device)
    shape = list(plane.shape)
    shape[dim] = out_len
    acc = torch.zeros(shape, dtype=torch.float32, device=device)
    for t in range(taps):
        idx = np.minimum(lefts + t, in_len - 1).astype(np.int64)
        rows = plane.index_select(dim, torch.from_numpy(idx).to(device))
        w = weights_t[:, t : t + 1] if dim == -2 else weights_t[t : t + 1, :]
        acc = acc + torch.where(w == 0.0, 0.0, rows * w)
    return torch.clamp(acc, 0.0, 1.0)


def resample_plane(plane: torch.Tensor, out_size: Size, filt: ResizeFilter,
                   rows=None) -> torch.Tensor:
    """Bit-exact resize of one `[H, W]` plane (or of each canvas of a
    `[B, H, W]` batch) to `out_size`, on the plane's device. Matches `imageops::resize`: vertical pass (height) then
    horizontal pass (width), each clamping to [0, 1]. `rows`, a
    `(start, stop)` pair, computes only those output rows (one shard's
    band): every output row is a sum of its own taps, so the band holds the
    same bits as those rows of the whole result."""
    in_h, in_w = plane.shape[-2:]
    lefts_v, weights_v = resample_weights(in_h, out_size.height, filt)
    if rows is not None:
        lefts_v, weights_v = lefts_v[rows[0]:rows[1]], weights_v[rows[0]:rows[1]]
    tmp = _apply_axis(plane, lefts_v, weights_v, in_h, -2)  # [..., outH, W]
    lefts_h, weights_h = resample_weights(in_w, out_size.width, filt)
    return _apply_axis(tmp, lefts_h, weights_h, in_w, -1).contiguous()


# --- resize policy resolution (`shared.rs:61-139`) ---
def resample_any(plane, out_size: Size, filt: ResizeFilter, mesh=None):
    """`resample_plane` under a mesh (None: as it is). A plane whose target
    rows shard over the mesh is built band by band from a tensor operand
    (a 1×1 Value, a plane of rows that do not shard); a `ShardedPlane`
    resized to another size is gathered to the mesh's first device (a
    `resize` gather), resized there and placed by the rule of
    `parallel.sharded.place`."""
    from ..parallel.sharded import ShardedPlane, place

    if isinstance(plane, ShardedPlane):
        if plane.shape == (out_size.height, out_size.width):
            return plane
        whole = plane.gather(plane.mesh.devices[0], "resize")
        return place(plane.mesh, resample_plane(whole, out_size, filt))
    if mesh is None or not mesh.shardable(out_size.height):
        return resample_plane(plane, out_size, filt)
    bh = out_size.height // mesh.n
    copies = {d: plane.to(d) for d in set(mesh.devices)}
    return ShardedPlane(mesh, [
        resample_plane(copies[d], out_size, filt, rows=(j * bh, (j + 1) * bh))
        for j, d in enumerate(mesh.devices)
    ])


def calculate_size(slot_datas, edges, policy: ResizePolicy) -> Size:
    kind = policy.kind
    K = ResizePolicyKind
    if kind == K.MOST_PIXELS:
        if not slot_datas:
            return Size(1, 1)
        # Rust `max_by` returns the last maximal element on ties.
        return max(reversed([sd.size() for sd in slot_datas]), key=lambda s: s.pixel_count())
    if kind == K.LEAST_PIXELS:
        if not slot_datas:
            raise TexProError(ErrorKind.GENERIC, "LeastPixels with no inputs")
        return min((sd.size() for sd in slot_datas), key=lambda s: s.pixel_count())
    if kind == K.LARGEST_AXES:
        width, height = 0, 0
        for sd in slot_datas:
            size = sd.size()
            width, height = max(width, size.width), max(height, size.height)
        return Size(width, height)
    if kind == K.SMALLEST_AXES:
        width, height = 2**32 - 1, 2**32 - 1
        for sd in slot_datas:
            size = sd.size()
            width, height = min(width, size.width), min(height, size.height)
        return Size(width, height)
    if kind == K.SPECIFIC_SLOT:
        sorted_edges = sorted(edges, key=lambda e: e.input_slot)
        edge = next((e for e in sorted_edges if e.input_slot == policy.payload), None)
        if edge is None and sorted_edges:
            edge = sorted_edges[0]
        if edge is not None:
            for sd in slot_datas:
                if sd.slot_id == edge.output_slot and sd.node_id == edge.output_id:
                    return sd.size()
            raise TexProError(ErrorKind.GENERIC, "no buffer for SpecificSlot edge")
        return Size(1, 1)
    if kind == K.SPECIFIC_SIZE:
        return policy.payload
    raise TexProError(ErrorKind.GENERIC, f"unknown policy {policy!r}")


def resize_buffers(slot_datas, edges, policy: ResizePolicy, filt: ResizeFilter, mesh=None):
    """Resize every input whose size differs from the policy's size
    (`shared.rs:141-216`), through `resample_any` (row-sharded over `mesh`
    where the target rows shard). Planes that already match are shared,
    not copied."""
    from ..slot_data import SlotData
    from ..slot_image import SlotImage
    from ..transient_buffer import plane_from_device

    if not slot_datas:
        return list(slot_datas)
    size = calculate_size(slot_datas, edges, policy)

    output = []
    for slot_data in slot_datas:
        if slot_data.size() != size:
            planes = [
                plane_from_device(resample_any(buf.data(), size, filt, mesh))
                for buf in slot_data.image.bufs()
            ]
            output.append(SlotData(slot_data.node_id, slot_data.slot_id, SlotImage(planes)))
        else:
            output.append(slot_data)
    return output
