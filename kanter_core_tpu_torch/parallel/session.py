"""BatchedLiveSession: interactive editing over N canvases at once.

Port of `kanter_core_tpu/parallel/session.py`. The engine's LiveGraph
tracks one canvas per plane; BASELINE config 5 ("interactive dirty-subgraph
re-eval over 16 batched 4k canvases") wants the same editing loop over a
whole batch. The session keeps a `NodeGraph`, tracks edits by structure
fingerprint, and evaluates through a `BatchedGraph`: value and input edits
re-run the cached program, a structural edit builds one new program and
reuses it thereafter (programs are cached per fingerprint, like the
engine's).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..errors import ErrorKind, TexProError
from ..ids import NodeId
from .sharded import BATCH_AXIS, BatchedGraph, shard_planes_batch


class BatchedLiveSession:
    """`batch_input_ids` are the InputGray nodes that take a `[B, H, W]`
    batch (`set_input`); `targets`, `mesh` and `dtype` are `BatchedGraph`'s
    (a `"rows"` mesh and bf16 are not yet ported); `device` is the card
    unless given."""

    def __init__(self, node_graph, batch_input_ids: list, targets: Optional[list] = None,
                 mesh=None, dtype=None, device=None):
        from ..compiler import _resolve_device, resolve_dtype

        resolve_dtype(dtype)
        if mesh is not None and mesh.axis_name != BATCH_AXIS:
            raise TexProError(
                ErrorKind.NODE_PROCESSING,
                f"BatchedLiveSession over a {mesh.axis_name!r} mesh is not yet ported",
            )
        self.node_graph = node_graph
        self.batch_input_ids = [NodeId(n) for n in batch_input_ids]
        self.targets = targets
        self.mesh = mesh
        self.dtype = dtype
        self.device = mesh.devices[0] if mesh is not None else _resolve_device(device)
        self._inputs: dict = {}
        self._programs: "OrderedDict[str, BatchedGraph]" = OrderedDict()
        self.program_cache_cap = 32  # structural edits mint programs; bound them
        self._dirty = True
        self._last_result = None
        self._last_stamp = None  # image-file stamps at the last render

    # --- edits ---
    def set_input(self, input_node_id, stacked_planes) -> None:
        """Bind a `[B, H, W]`-stacked gray plane batch to an InputGray node:
        on a batch mesh its shares go to their devices once, here; a batch
        that does not divide over the mesh stays whole on its first device
        (the JAX package replicates it)."""
        key = f"input_{int(input_node_id)}"
        if isinstance(stacked_planes, torch.Tensor):
            batch = stacked_planes.to(torch.float32)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(stacked_planes, dtype=np.float32))
        mesh = self.mesh
        if mesh is not None and batch.dim() >= 1 and batch.shape[0] % mesh.n == 0:
            value = shard_planes_batch(mesh, batch)
        else:
            value = batch.to(self.device)
        self._inputs[key] = (value,)
        self._dirty = True

    def set_value(self, node_id, value: float) -> None:
        from ..node import NodeType, NodeTypeKind

        node = self.node_graph._node_with_id_mut(NodeId(node_id))
        if node is None or node.node_type.kind != NodeTypeKind.VALUE:
            raise TexProError(ErrorKind.INVALID_NODE_TYPE, "set_value targets a Value node")
        node.node_type = NodeType.Value(value)
        self._dirty = True

    def edit(self, fn) -> None:
        """Arbitrary structural edit: `fn(node_graph)`; rebuilds lazily."""
        fn(self.node_graph)
        self._dirty = True

    # --- evaluation ---
    def render(self) -> dict:
        """`{(node_id, slot_id): [B, ...] planes}` for the targets. Image
        files are stamped (size, mtime) into the program key and re-checked
        on every render, so a file rewritten in place is read again, and a
        clean session returns its last result."""
        from ..compiler import collect_value_bindings, graph_fingerprint
        from ..recipe_cache import _nested_content_stamp

        stamp = repr(_nested_content_stamp(self.node_graph))
        if not self._dirty and self._last_result is not None and stamp == self._last_stamp:
            return self._last_result
        self._last_stamp = stamp
        fingerprint = graph_fingerprint(self.node_graph) + stamp
        program = self._programs.get(fingerprint)
        if program is None:
            program = BatchedGraph(
                self.node_graph.clone(),
                batch_keys={f"input_{int(n)}" for n in self.batch_input_ids},
                targets=self.targets,
                mesh=self.mesh,
                dtype=self.dtype,
                device=self.device,
            )
            self._programs[fingerprint] = program
            while len(self._programs) > self.program_cache_cap:
                self._programs.popitem(last=False)
        else:
            self._programs.move_to_end(fingerprint)
        overrides = dict(self._inputs)
        overrides.update(collect_value_bindings(self.node_graph))
        self._last_result = program(**overrides)
        self._dirty = False
        return self._last_result
