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

Both take `[B, H, W]` batches as well, with vmap's semantics: the planes
and the strength map may each be batched or shared by every canvas, and
each canvas is warped as on its own. The kernel takes the whole batch in
one launch (the canvas in `blockIdx.z`, a batch stride of 0 for a shared
operand); the JAX package's batching rule
(`pallas_warp._warp_pallas_wrapped`'s) maps the rank-2 kernel over a batch
whose operands are all batched.

`warp_planes` takes the plain version for CPU tensors and the kernel for
CUDA tensors (which raises if it cannot build or launch); no fallback.

The mesh form (`TextureProcessor(mesh=...)`), `warp_planes_mesh`, is the
port of the JAX package's `warp_planes_mesh` and its
`pallas_warp._warp_pallas_sharded`: the strength clamp bounds the
displacement, so a ring exchange of ±`warp_halo(intensity)` rows
(`ShardedPlane.ring_halos`) gives every shard the rows it samples, and each
shard runs one block launch on its device with its global first row:
`warp_block_plain` / `warp_block_cuda` (the entry `kanter_warp_block_f32`
of `csrc/warp.cu`, the port of `pallas_warp._warp_block`). The host picks
the block kernel's index mode (`warp_block_index_mode`: which wraps need no
remainder) and its launch (`warp_block_plan`); on CUDA devices the mesh
form passes the halos by device address (`ShardedPlane.ring_halo_addresses`)
and checks its operands once per plane, not once per shard. Where
`fits_mesh` fails (an unbounded intensity, blocks shorter than the halo,
fewer than two shards), the planes are gathered to the mesh's first device,
warped by the dense kernel and sharded again, counted as `warp_gate`
gathers — GSPMD's all-gather in the JAX package.
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
from .common import NodePlanes, connected_input
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
    w = strength.shape[-1]
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    ms = torch.clamp(strength, 0.0, 1.0)
    ms = torch.where(torch.isnan(strength), 0.5, ms)
    d = ms - 0.5
    cols = torch.arange(w, dtype=torch.float32, device=strength.device)[None, :]
    return cols + d * kx, rows + d * ky


def warp_planes_plain(planes, strength: torch.Tensor, k) -> tuple:
    """The plain torch warp of `[H, W]` planes by an `[H, W]` strength map;
    either may be a `[B, H, W]` batch."""
    h, w = planes[0].shape[-2:]
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


# (4 planes, 4 outputs, n planes, strength, kx, ky, h, w, batch, 4 plane
#  batch strides, strength batch stride, output batch stride, stream)
WARP_KERNEL = CudaKernel(
    "warp", "kanter_warp_bilinear_f32",
    [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p],
)

# the block entry of the same library; its own launch count
WARP_BLOCK_KERNEL = CudaKernel(
    "warp", "kanter_warp_block_f32",
    [ctypes.c_void_p] * 16 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)

_MAX_PLANES = 4  # planes per launch (csrc/warp.cu kMaxPlanes)
_F32 = torch.float32
_EXACT = 1 << 24  # every pixel coordinate below it is an exact f32


def _batch_of(tensors, shape) -> int:
    """The batch of the dense kernel's operands: each a contiguous f32 CUDA
    tensor on one device, `[H, W]` of `shape` or a `[B, H, W]` batch of
    them, every batched one of one `B`; 0 when none is batched."""
    device = tensors[0].device
    batch = 0
    for t in tensors:
        if not (
            t.is_cuda and t.dtype == torch.float32 and t.dim() in (2, 3) and t.is_contiguous()
            and tuple(t.shape[-2:]) == tuple(shape) and t.device == device
            and (t.dim() == 2 or batch in (0, t.shape[0]))
            and (t.dim() == 2 or 1 <= t.shape[0] <= MAX_BATCH)
        ):
            raise TexProError(
                ErrorKind.GENERIC,
                f"warp kernel needs contiguous {tuple(shape)} float32 CUDA tensors or one "
                f"batch of them (B <= {MAX_BATCH}) on {device}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}",
            )
        if t.dim() == 3:
            batch = t.shape[0]
    return batch


def warp_planes_cuda(planes, strength: torch.Tensor, k) -> tuple:
    """The hand-written CUDA warp: one launch per group of up to four
    planes (one for a gray or an RGBA image), on the current stream. The
    planes and the strength map may each be `[B, H, W]` batches or shared
    `[H, W]` planes; with any batch the launch covers every canvas and each
    output is a batch."""
    shape = tuple(planes[0].shape[-2:])
    batch = _batch_of([strength, *planes], shape)
    h, w = shape
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    kernel = WARP_KERNEL.entry()
    out_shape = (batch, h, w) if batch else (h, w)
    outs = [torch.empty(out_shape, dtype=_F32, device=strength.device) for _ in planes]

    def stride(t):
        return h * w if t.dim() == 3 else 0

    with torch.cuda.device(strength.device):
        stream = torch.cuda.current_stream(strength.device).cuda_stream
        for start in range(0, len(planes), _MAX_PLANES):
            group = range(start, min(start + _MAX_PLANES, len(planes)))
            ins = [planes[i].data_ptr() for i in group]
            dsts = [outs[i].data_ptr() for i in group]
            strides = [stride(planes[i]) for i in group]
            pad = [None] * (_MAX_PLANES - len(group))
            rc = kernel(*ins, *pad, *dsts, *pad, len(group), strength.data_ptr(),
                        kx, ky, h, w, max(batch, 1), *strides, *[0] * len(pad),
                        stride(strength), h * w, stream)
            if rc != 0:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING, f"warp kernel launch failed: CUDA error {rc}"
                )
            WARP_KERNEL.count_launch(batch=batch)
    return tuple(outs)


# index modes of the block kernel (csrc/warp.cu kFast, kColGeneral, kGeneral)
WARP_FAST, WARP_COL_GENERAL, WARP_GENERAL = 0, 1, 2

# pixels per thread of the block launch (csrc/warp.cu kPx), adjacent with
# 8-byte accesses where the rows allow it; its tiles are `warp_block_tile`'s.
# Both chosen on the card with `scripts/kernel_tile_sweep.py --warp`.
WARP_BLOCK_PX = 2


def warp_block_index_mode(kx: float, ky: float, block_h: int, w: int, h: int,
                          halo: int) -> int:
    """How the block kernel finds a sample's texels, from the f32 `kx, ky`.
    A sample's floor lies within `⌈|k|/2⌉` of its pixel, so where `halo ≥
    ⌈|ky|/2⌉ + 2` and `block_h + 2·halo ≤ h` (what `fits_mesh` gives) its
    window row is `(int)vf − row_origin + halo`, no remainder: the same
    residue mod `h` as the plain version's `row_local`, of a number in
    `[0, h)`. Where `kx` is finite and `⌈|kx|/2⌉ + 2 ≤ w`, the column wraps
    by one conditional add or subtract. `WARP_FAST` takes both,
    `WARP_COL_GENERAL` the row only, `WARP_GENERAL` neither (a remainder
    for each, as the plain version takes)."""
    row_fast = (math.isfinite(ky) and halo >= math.ceil(abs(ky) * 0.5) + 2
                and block_h + 2 * halo <= h <= _EXACT)
    if not row_fast:
        return WARP_GENERAL
    col_fast = math.isfinite(kx) and math.ceil(abs(kx) * 0.5) + 2 <= w <= _EXACT
    return WARP_FAST if col_fast else WARP_COL_GENERAL


class WarpBlockPlan(NamedTuple):
    """One block launch: the index `mode`; two pixels per thread, adjacent
    with 8-byte accesses when `vec`, else a block's width apart; a tile of
    `th` rows and `tw` columns, `tw / 2 × th` threads."""

    mode: int
    vec: bool
    th: int
    tw: int


def warp_block_tile(ky: float) -> tuple:
    """The block launch's tile, rows × columns: 8 × 64 where a sample lies
    at most 4 rows from its pixel (the main path's intensities, up to 9),
    else 16 × 32, a taller tile whose rows share more of their source rows
    in L1 (25% faster at intensity 64, 3% slower at 5)."""
    near = math.isfinite(ky) and math.ceil(abs(ky) * 0.5) <= 4
    return (8, 64) if near else (16, 32)


def warp_block_plan(kx: float, ky: float, block_h: int, w: int, h: int, halo: int,
                    aligned: bool) -> WarpBlockPlan:
    """The launch for a block of `block_h × w` rows and columns of an
    `h`-row canvas with `halo` rows above and below; `aligned`: the strength
    starts on an 8-byte boundary (the outputs, fresh allocations, do), so
    that with an even `w` a thread's two adjacent pixels are one 8-byte
    access."""
    th, tw = warp_block_tile(ky)
    return WarpBlockPlan(warp_block_index_mode(kx, ky, block_h, w, h, halo),
                         aligned and w % WARP_BLOCK_PX == 0, th, tw)


def _k_floats(k) -> tuple:
    """`k` as the two Python floats of its f32 values."""
    return tuple(np.asarray(k, np.float32).tolist())


def _refuse(what: str) -> None:
    raise TexProError(ErrorKind.GENERIC, f"warp block kernel: {what}")


def _check_halo(halo: int, ky: float) -> None:
    if not (math.isfinite(ky) and halo >= math.ceil(abs(ky) * 0.5) + 2):
        _refuse(f"a halo of {halo} rows does not cover ky={ky}")


class _BlockLaunch(NamedTuple):
    """What every shard's launch of one call shares."""

    kernel: object
    kx: float
    ky: float
    block_h: int
    w: int
    h: int
    halo: int
    plan: WarpBlockPlan


def _launch_shard(launch: _BlockLaunch, stream: int, tops, mids, bots, strength: int,
                  row_origin: int, like: torch.Tensor) -> list:
    """The block kernel on `stream` (of the current device) for the planes
    whose top, mid and bottom rows start at the addresses `tops[p]`,
    `mids[p]`, `bots[p]`: one launch per group of four planes. Returns the
    outputs, new tensors like `like`; the caller has checked the operands."""
    n = len(mids)
    outs = [torch.empty_like(like) for _ in range(n)]  # the allocator aligns them to 512 bytes
    plan = launch.plan
    for start in range(0, n, _MAX_PLANES):
        stop = min(start + _MAX_PLANES, n)
        pad = [None] * (_MAX_PLANES - (stop - start))
        rc = launch.kernel(*tops[start:stop], *pad, *mids[start:stop], *pad, *bots[start:stop],
                           *pad, *[o.data_ptr() for o in outs[start:stop]], *pad, stop - start,
                           strength, launch.kx, launch.ky, launch.block_h, launch.w, launch.h,
                           row_origin, launch.halo, plan.mode, plan.vec, plan.th, plan.tw,
                           stream)
        if rc != 0:
            raise TexProError(
                ErrorKind.NODE_PROCESSING, f"warp block kernel launch failed: CUDA error {rc}"
            )
        WARP_BLOCK_KERNEL.count_launch()
    return outs


def check_warp_block(block_planes, strength_blk: torch.Tensor, k, tops, bots) -> tuple:
    """The block kernel's operands, checked in one pass: every tensor a
    contiguous 2-D f32 plane of its shape (`[block_h, W]` for the strength
    and the planes, `[halo, W]` for the halos) on the strength's device, one
    top and one bottom halo per plane, and a halo that covers the
    displacement (`halo ≥ ⌈|ky|/2⌉ + 2`, so no sampled row leaves the
    window). Returns `(block_h, w, halo, kx, ky, addresses)`, the addresses
    of the strength and of the planes, tops and bottoms; raises
    `TexProError`."""
    if not (strength_blk.dim() == 2 and tops and len(block_planes) == len(tops) == len(bots)):
        _refuse(f"needs a 2-D strength block and one top and one bottom halo per plane; got "
                f"{tuple(strength_blk.shape)}, {len(block_planes)} planes, {len(tops)} and "
                f"{len(bots)} halos")
    block_h, w = strength_blk.shape
    halo = tops[0].shape[0]
    device = strength_blk.device
    addresses = []
    for seq, shape in (((strength_blk,), (block_h, w)), (block_planes, (block_h, w)),
                       (tops, (halo, w)), (bots, (halo, w))):
        for t in seq:
            if not (t.dtype is _F32 and t.shape == shape and t.is_contiguous()
                    and t.device == device):
                _refuse(f"needs contiguous {shape} float32 tensors on {device}; got {t.dtype} "
                        f"{tuple(t.shape)} on {t.device}")
        addresses.append([t.data_ptr() for t in seq])
    kx, ky = _k_floats(k)
    _check_halo(halo, ky)
    return block_h, w, halo, kx, ky, addresses


def _aligned(*address_lists) -> bool:
    """Every address on an 8-byte boundary."""
    return not any(a & 7 for addresses in address_lists for a in addresses)


def warp_block_cuda(block_planes, strength_blk: torch.Tensor, k, tops, bots,
                    row_origin: int, h: int) -> tuple:
    """The hand-written CUDA warp of one row block (the
    `kanter_warp_block_f32` entry of `csrc/warp.cu`): one launch per group
    of up to four planes, on the block's device and current stream. Raises
    unless `check_warp_block` passes and the tensors lie on a CUDA
    device."""
    block_h, w, halo, kx, ky, (strength, mids, top_ptrs, bot_ptrs) = check_warp_block(
        block_planes, strength_blk, k, tops, bots)
    if not strength_blk.is_cuda:
        _refuse(f"needs CUDA tensors; got {strength_blk.device}")
    plan = warp_block_plan(kx, ky, block_h, w, h, halo, _aligned(strength))
    launch = _BlockLaunch(WARP_BLOCK_KERNEL.entry(), kx, ky, block_h, w, h, halo, plan)
    device = strength_blk.device
    with torch.cuda.device(device):
        return tuple(_launch_shard(launch, torch.cuda.current_stream(device).cuda_stream,
                                   top_ptrs, mids, bot_ptrs, strength[0], int(row_origin),
                                   strength_blk))


def _warp_mesh_cuda(planes, strength: ShardedPlane, k, halo: int) -> tuple:
    """The mesh warp on CUDA devices: one ring exchange per plane, as device
    addresses of the halo rows (`ShardedPlane.ring_halo_addresses`), then
    one block launch per shard, in one device context per run of shards on
    one device. The checks are made once per plane: a `ShardedPlane`'s bands
    share their shape and dtype and lie on their shard's device, so what is
    left is f32 and contiguous rows."""
    for sp in (strength, *planes):
        if not (sp.dtype is _F32 and all(b.is_contiguous() for b in sp.bands)):
            _refuse(f"needs contiguous float32 bands; got {sp}")
    kx, ky = _k_floats(k)
    _check_halo(halo, ky)
    mesh, h = strength.mesh, strength.shape[0]
    block_h, w = strength.bands[0].shape
    exchanges = [p.ring_halo_addresses(halo) for p in planes]  # keeps any copies alive
    mids = [[b.data_ptr() for b in p.bands] for p in planes]
    strengths = [b.data_ptr() for b in strength.bands]
    plan = warp_block_plan(kx, ky, block_h, w, h, halo, _aligned(strengths))
    launch = _BlockLaunch(WARP_BLOCK_KERNEL.entry(), kx, ky, block_h, w, h, halo, plan)
    per_shard = []
    j = 0
    while j < mesh.n:
        device = mesh.devices[j]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            while j < mesh.n and mesh.devices[j] == device:
                per_shard.append(_launch_shard(
                    launch, stream, [tops[j] for tops, _, _ in exchanges], [m[j] for m in mids],
                    [bots[j] for _, bots, _ in exchanges], strengths[j], j * block_h,
                    strength.bands[j]))
                j += 1
    return tuple(ShardedPlane(mesh, bands) for bands in zip(*per_shard))


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
    if mesh.device_type == "cuda":
        return _warp_mesh_cuda(planes, strength, k, halo)
    halos = [p.ring_halos(halo) for p in planes]
    block_h = strength.band_rows
    per_shard = [
        warp_block_plain([p.bands[j] for p in planes], strength.bands[j], k,
                         [hs[j][0] for hs in halos], [hs[j][1] for hs in halos], j * block_h, h)
        for j in range(mesh.n)
    ]
    return tuple(ShardedPlane(mesh, bands) for bands in zip(*per_shard))


def warp_planes(planes, strength, k, halo=None) -> tuple:
    """Warp of an image's planes by a strength map of the same size (any of
    them a `[B, H, W]` batch): the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors, the
    mesh form (with the row `halo` of `warp_bindings`) when any is a
    `ShardedPlane`, which all must then be."""
    if any(isinstance(x, ShardedPlane) for x in (strength, *planes)):
        return warp_planes_mesh(planes, strength, k, halo)
    if strength.device.type == "cpu":
        return warp_planes_plain(planes, strength, k)
    if strength.device.type == "cuda":
        return warp_planes_cuda([p.contiguous() for p in planes], strength.contiguous(), k)
    raise TexProError(ErrorKind.NODE_PROCESSING, f"no warp for device {strength.device}")


def warp_images(planes, strength, b: dict) -> list:
    """A Warp node's output planes from its input's and its strength's
    planes and its `warp_bindings`; a dangling strength passes the input's
    planes through (an alias, the re-key Output does)."""
    planes = connected_input(planes, "Warp")
    if strength is None:
        return planes
    return list(warp_planes(planes, strength[0], b["k"], halo=b["halo"]))


def process(slot_datas, node):
    """Per-node: the warp kernel's launches on a CUDA processor, the block
    kernel's over a mesh."""
    io = NodePlanes(slot_datas, node)
    planes = warp_images(io.named("input"), io.named("strength"),
                         warp_bindings(node.node_type.payload))
    return io.outputs([(SlotId(0), planes)])
