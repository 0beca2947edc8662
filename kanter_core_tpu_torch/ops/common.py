"""Shared op helpers (`vismut_core/src/node/process_shared.rs`).

Besides the slot lookups and the u8 conversion, this holds what the two
routes share: `Placement` makes the constant and procedural planes of a
processor on its device (row-sharded over its mesh), the plane-list rules
(`as_type`, `connected_input`, `gray_input`) are the ones both the fused
evaluator (`compiler.GraphCompiler._emit`) and the per-node ops apply, and
`NodePlanes` turns a per-node dispatch's slot datas into plane tensors and
its outputs back into slot datas.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..errors import ErrorKind, TexProError
from ..ids import SlotId
from ..parallel.sharded import ShardedPlane, map_bands, place


def slot_data_with_name(slot_datas, node, name: str) -> Optional["SlotData"]:
    slot_id = node.input_slot_with_name(name).slot_id
    return slot_data_with_slot_id(slot_datas, slot_id)


def slot_data_with_slot_id(slot_datas, slot_id: SlotId):
    for slot_data in slot_datas:
        if slot_data.slot_id == slot_id:
            return slot_data
    return None


def f32_to_u8(x):
    """THE canonical u8 export conversion — reference semantics
    (`slot_image.rs:142-144`): clamp to [0,1], ×255, NaN→255 (Rust
    f32::min), truncating cast. Plain torch on the plane's device; every u8
    export path uses this one definition."""
    c = torch.clamp(x, 0.0, 1.0)
    v = c * 255.0
    v = torch.where(torch.isnan(v), 255.0, torch.clamp(v, max=255.0))
    return v.to(torch.uint8)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device: the f64 root,
    rounded once (53 >= 2*24 + 2 bits, so the double rounding is
    innocuous). Torch's f32 `sqrt` on the CPU is not correctly rounded."""
    return torch.sqrt(x.double()).float()


class Placement:
    """Where a processor's planes live: tensors on `device`, or, with a
    `mesh` (whose first device is then `device`), row-sharded over it for
    every plane whose rows shard over the mesh, by the rule of
    `parallel.sharded.place`. Every plane a node creates from nothing (a
    constant, a procedural source) is made here, on an explicit device:
    a worker thread's current CUDA device is not the processor's."""

    __slots__ = ("device", "mesh")

    def __init__(self, device, mesh=None):
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else torch.device(device)

    def full(self, shape, value: float):
        """A constant f32 plane of `shape`."""
        h, w = shape
        mesh = self.mesh
        if mesh is not None and mesh.shardable(h):
            bh = h // mesh.n
            return ShardedPlane(mesh, [
                torch.full((bh, w), float(value), dtype=torch.float32, device=d)
                for d in mesh.devices
            ])
        return torch.full(shape, float(value), dtype=torch.float32, device=self.device)

    def from_value(self, size, value: float, rgba: bool) -> list:
        """The planes of a constant image (`SlotImage::from_value`): the
        colour planes share one plane, alpha is 1."""
        shape = (size.height, size.width)
        plane = self.full(shape, value)
        return [plane, plane, plane, self.full(shape, 1.0)] if rgba else [plane]

    def source(self, fn, rows, cols):
        """A procedural source `fn(rows, cols)` over the host index vectors:
        on the device, or shard by shard over the slice of `rows` each shard
        holds when they shard over the mesh (every pixel is a function of
        its own global row and column, so the bits are unchanged)."""
        mesh = self.mesh
        if mesh is None or not mesh.shardable(len(rows)):
            return fn(torch.from_numpy(rows).to(self.device),
                      torch.from_numpy(cols).to(self.device))
        bh = len(rows) // mesh.n
        results = [
            fn(torch.from_numpy(rows[j * bh:(j + 1) * bh]).to(d), torch.from_numpy(cols).to(d))
            for j, d in enumerate(mesh.devices)
        ]
        if isinstance(results[0], (tuple, list)):
            return tuple(ShardedPlane(mesh, bands) for bands in zip(*results))
        return ShardedPlane(mesh, results)

    def place(self, plane):
        """`plane` where this processor keeps it; a plane already there is
        returned as it is."""
        if self.mesh is not None:
            return place(self.mesh, plane)
        if isinstance(plane, ShardedPlane):
            raise TexProError(ErrorKind.GENERIC, f"{plane} given to a processor with no mesh")
        return plane if plane.device == self.device else plane.to(self.device)


def rgb_mean(r, g, b) -> torch.Tensor:
    """gray = ((r + g) + b) / 3 — the association of `slot_image.rs:247-250`.
    The divisor is a full tensor: a Python-scalar divisor may become a
    multiply by the reciprocal on CUDA, which rounds differently."""
    s = (r + g) + b
    return s / torch.full_like(s, 3.0)


def as_type(planes: list, rgba: bool) -> list:
    """An image's planes coerced to Gray or Rgba (`slot_image.rs:212-256`):
    gray → rgba aliases the gray plane three times over a fresh alpha of 1;
    rgba → gray is the rgb mean."""
    if (len(planes) == 4) == rgba:
        return planes
    if rgba:
        g = planes[0]
        return [g, g, g, map_bands(torch.ones_like, g)]
    return [map_bands(rgb_mean, *planes[:3])]


def connected_input(planes, what: str) -> list:
    """The planes of a node's required input; an unconnected one is an
    `INVALID_BUFFER_COUNT` error (the JAX package's per-node ops return no
    output there, which its output-count check turns into this error)."""
    if planes is None:
        raise TexProError(ErrorKind.INVALID_BUFFER_COUNT, f"{what} needs an input")
    return planes


def gray_input(planes, what: str):
    """The one plane of a Gray-only node's input; an absent or RGBA input is
    an `INVALID_BUFFER_COUNT` error (the JAX package's per-node ops return
    no output there, which its output-count check turns into this error)."""
    if planes is None or len(planes) == 4:
        raise TexProError(ErrorKind.INVALID_BUFFER_COUNT, f"{what} needs a Gray input")
    return planes[0]


class NodePlanes:
    """A per-node dispatch's inputs as plane tensors, and its outputs as
    slot datas. An output tensor that is one of the inputs' planes keeps
    that plane's `PlaneBuffer` (an alias, like the reference's Arc-shared
    channel planes), and a tensor given twice is wrapped once, as the fused
    route's output layout does."""

    __slots__ = ("node", "slot_datas", "_buffers")

    def __init__(self, slot_datas, node):
        self.node = node
        self.slot_datas = slot_datas
        self._buffers: dict = {}  # id(tensor) → (tensor, PlaneBuffer)

    def _planes(self, slot_data) -> Optional[list]:
        if slot_data is None:
            return None
        planes = []
        for buf in slot_data.image.planes:
            tensor = buf.data()
            self._buffers[id(tensor)] = (tensor, buf)
            planes.append(tensor)
        return planes

    def named(self, name: str) -> Optional[list]:
        """The planes on the input slot called `name`, or None."""
        return self._planes(slot_data_with_name(self.slot_datas, self.node, name))

    def by_slot(self) -> dict:
        """`{input SlotId: planes}` of every connected input."""
        return {sd.slot_id: self._planes(sd) for sd in self.slot_datas}

    def outputs(self, images) -> list:
        """Slot datas of `[(output SlotId, planes)]`."""
        from ..slot_data import SlotData
        from ..slot_image import SlotImage
        from ..transient_buffer import plane_from_device

        result = []
        for slot_id, planes in images:
            bufs = []
            for tensor in planes:
                entry = self._buffers.get(id(tensor))
                if entry is None:
                    entry = self._buffers[id(tensor)] = (tensor, plane_from_device(tensor))
                bufs.append(entry[1])
            result.append(SlotData(self.node.node_id, slot_id, SlotImage(bufs)))
        return result
