"""Value / Image / Write / Input / Output ops.

Port of `kanter_core_tpu/ops/inout.py` (`vismut_core/src/node/{value,image,
write,input_rgba,input_gray,output}.rs`): the per-node forms, and the rules
the fused evaluator (`compiler.GraphCompiler._emit`) shares with them. Image
decodes with the port's own PNG codec (`image_io`) and places its planes
where the processor keeps them; Write encodes its input's u8 export.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ErrorKind, TexProError
from ..ids import SlotId
from ..slot_data import SlotData
from .common import NodePlanes
from .image_io import image_planes, save_rgba_png


def value_plane(value, device) -> torch.Tensor:
    """The 1×1 Gray constant of a Value node (`value.rs:14-26`), on
    `device`; consumers upscale it through their resize policy. A `[B]`
    vector of values (a Value batched over canvases) gives a `[B, 1, 1]`
    batch."""
    if np.ndim(value) == 0 and not isinstance(value, torch.Tensor):
        return torch.full((1, 1), float(np.float32(value)), dtype=torch.float32, device=device)
    values = torch.as_tensor(value).to(device=device, dtype=torch.float32)
    return values.reshape(-1, 1, 1) if values.dim() else values.reshape(1, 1)


def image_node_planes(path, place) -> list:
    """The four planes of an Image node's file (the 1×1 magenta placeholder
    when it cannot be read, `image.rs:11-19`), placed by `place`."""
    return [place.place(torch.from_numpy(p)) for p in image_planes(path)]


def process_image(node, path, place):
    io = NodePlanes([], node)
    return io.outputs([(SlotId(0), image_node_planes(path, place))])


def process_write(slot_datas, path):
    """The u8 export of the first input, saved as a PNG (`write.rs:5-21`);
    no outputs. A save failure — an unwritable path, or an extension other
    than `.png` — raises an `IO` error, which fails only this graph (the
    JAX package lets PIL's `ValueError` for an unknown extension escape,
    which its engine treats as fatal)."""
    if slot_datas:
        slot_data = slot_datas[0]
        try:
            save_rgba_png(path, slot_data.image.to_u8(), slot_data.size())
        except (OSError, ValueError) as e:
            raise TexProError(ErrorKind.IO, f"Write node could not save {path!r}: {e}") from e
    return []


def no_outer_input() -> TexProError:
    """An InputRgba node evaluated with no input slot data bound."""
    return TexProError(ErrorKind.NODE_PROCESSING, "InputRgba with no outer input")


def output_planes(planes, rgba: bool, place) -> list:
    """An Output node re-keys its input's planes, or emits a 1×1 black
    (transparent-black alpha 1) default when unconnected (`output.rs:12-33`)."""
    if planes is not None:
        return planes
    zero = place.full((1, 1), 0.0)
    return [zero, zero, zero, place.full((1, 1), 1.0)] if rgba else [zero]


def process_value(node, value: float, device):
    io = NodePlanes([], node)
    return io.outputs([(SlotId(0), [value_plane(value, device)])])


def process_input_rgba(node, input_slot_datas):
    """Passthrough of the first provided input slot data (`input_rgba.rs:7-13`)."""
    if not input_slot_datas:
        raise no_outer_input()
    return [SlotData(node.node_id, SlotId(0), input_slot_datas[0].image)]


def process_input_gray(node, input_slot_datas):
    """Passthrough of the input slot data registered under this node's id
    (`input_gray.rs:7-16`); empty when missing."""
    for slot_data in input_slot_datas:
        if slot_data.node_id == node.node_id:
            return [SlotData(node.node_id, SlotId(0), slot_data.image)]
    return []


def process_output(slot_datas, node, place):
    from ..node import NodeTypeKind

    kind = node.node_type.kind
    if kind not in (NodeTypeKind.OUTPUT_GRAY, NodeTypeKind.OUTPUT_RGBA):
        raise AssertionError("output op on a non-output node")
    io = NodePlanes(slot_datas, node)
    planes = io.by_slot()
    connected = planes[min(planes)] if planes else None
    return io.outputs([
        (SlotId(0), output_planes(connected, kind == NodeTypeKind.OUTPUT_RGBA, place))
    ])
