"""kanter_core_tpu_torch — the texture node-graph engine on PyTorch and CUDA.

A port of `kanter_core_tpu` (JAX/XLA with Pallas kernels for the TPU) to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100). Module
names mirror the JAX package's. The graph model (NodeGraph, LiveGraph, serde,
priorities, the tiered plane cache, the recipe cache) is the same; the pixel
math runs as eager torch ops on the `TextureProcessor`'s device, and each
TPU kernel becomes a CUDA kernel whose plain torch version serves the CPU.

This package never imports JAX or `kanter_core_tpu`.

Ported: the fused route and the per-node route (taken under `auto_update`
and with `fuse_subgraphs=False`) from `TextureProcessor` through `LiveGraph`
to `buffer_rgba` and `to_u8_srgb`, for all 26 node kinds: Blur (CUDA kernel
`csrc/blur.cu`), Distance (CUDA JFA kernels `csrc/jfa.cu`) and Warp (CUDA
gather kernel `csrc/warp.cu`) and the rest in plain torch, including the
reference's pow (`ops.exact_math`: glibc `powf` on the CPU, `ds_pow` on a
card), nested Graph nodes, and Image and Write through the port's own PNG
codec (`ops.image_io`). `TextureProcessor(mesh=...)` holds the planes
row-sharded over a device mesh (`parallel.make_mesh`), with the Blur and
Warp block kernels run per shard after a ring halo exchange.

The compiled-program API (`compile_graph`, `CompiledGraph` with targets and
u8 export) and the batched path (`parallel.BatchedGraph`,
`parallel.BatchedLiveSession`, batch-sharded over a `"batch"` mesh) run a
graph over `[B, H, W]` batches of canvases, the Blur, Distance and Warp
kernels taking a whole batch in one launch. Autodiff, checkpoints, the CLI,
and the tiled, bucketed and bf16 routes are not ported.
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
from .compiler import CompiledGraph, compile_graph
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
    "compile_graph",
    "compiler",
    "convert",
    "graphs",
    "models",
    "native",
    "parallel",
    "profiling",
]
