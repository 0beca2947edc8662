"""kanter_core_tpu_torch — the texture node-graph engine on PyTorch and CUDA.

A port of `kanter_core_tpu` (JAX/XLA with Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100). Module
names mirror the JAX package's. The graph model (NodeGraph, LiveGraph, serde,
priorities, the tiered plane cache, the recipe cache) is the same; the pixel
math runs as eager torch ops on the `TextureProcessor`'s device, and each
TPU kernel becomes a CUDA kernel whose plain torch version serves the CPU.

This package never imports JAX or `kanter_core_tpu`.

Ported so far: the fused route from `TextureProcessor` through `LiveGraph`
to `buffer_rgba`, for the node kinds Value, InputGray/InputRgba,
OutputGray/OutputRgba, Mix (every mode but POW), HeightToNormal,
SeparateRgba, CombineRgba, Embed, Blur (CUDA kernel `csrc/blur.cu`), Noise,
Pattern, Voronoi, Ramp, Curvature, AmbientOcclusion, Hsv, Distance (CUDA
JFA step kernel `csrc/jfa.cu`) and Warp (CUDA gather kernel
`csrc/warp.cu`) — every node of `graphs.flagship_graph`. Other kinds
(Image, Graph, Write, Levels, GradientMap, Transform) raise a
`NODE_PROCESSING` error when evaluated. `TextureProcessor(mesh=...)` holds
the planes row-sharded over a device mesh (`parallel.make_mesh`), with the
Blur and Warp block kernels run per shard after a ring halo exchange.
"""

from .edge import Edge
from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .live_graph import LiveGraph, NodeState
from .node import (
    AtomicFlag,
    MixType,
    Node,
    NodeType,
    NodeTypeKind,
    PatternKind,
    ResizeFilter,
    ResizePolicy,
    ResizePolicyKind,
    Side,
    Slot,
    SlotType,
)
from .node_graph import NodeGraph
from .ops.embed import EmbeddedSlotData, EmbeddedSlotDataId
from .priority import Priority, PriorityPropagator
from .slot_data import ChannelPixel, SlotData
from .slot_image import SlotImage
from . import compiler, convert, graphs, models, native, parallel, profiling
from .compiler import CompiledGraph
from .texture_processor import TextureProcessor
from .transient_buffer import AtomicUsize, PlaneBuffer, PlaneBufferQueue, Tier

__version__ = "0.1.0"

__all__ = [
    "AtomicFlag",
    "AtomicUsize",
    "ChannelPixel",
    "CompiledGraph",
    "Edge",
    "EmbeddedSlotData",
    "EmbeddedSlotDataId",
    "ErrorKind",
    "LiveGraph",
    "MixType",
    "Node",
    "NodeGraph",
    "NodeId",
    "NodeState",
    "NodeType",
    "NodeTypeKind",
    "PatternKind",
    "PlaneBuffer",
    "PlaneBufferQueue",
    "Priority",
    "PriorityPropagator",
    "ResizeFilter",
    "ResizePolicy",
    "ResizePolicyKind",
    "Side",
    "Size",
    "Slot",
    "SlotData",
    "SlotId",
    "SlotImage",
    "SlotType",
    "TexProError",
    "TextureProcessor",
    "Tier",
    "compiler",
    "convert",
    "graphs",
    "models",
    "native",
    "parallel",
    "profiling",
]
