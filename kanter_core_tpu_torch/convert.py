"""State carried across from the JAX package.

A texture engine holds no weights; what a user brings to it is a graph and
the planes bound to its inputs. These two functions take them from the JAX
package's forms (its serde JSON, numpy planes) without importing it, so the
same graph and the same planes can be fed to both packages.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .ids import NodeId
from .node_graph import NodeGraph


def node_graph_from_reference(json_str: str) -> NodeGraph:
    """The port's NodeGraph from `kanter_core_tpu`'s serde JSON (the text of
    `json.dumps(graph.to_json())` or of `NodeGraph.export_json`). The node id
    counter resumes after the largest id, as `NodeGraph.from_path` does."""
    graph = NodeGraph.from_json(json.loads(json_str))
    if graph.nodes:
        graph._node_id_counter = NodeId(max(int(n.node_id) for n in graph.nodes) + 1)
    graph.validate_acyclic()
    return graph


def planes_from_numpy(arrays, device) -> list[torch.Tensor]:
    """`[H, W]` numpy planes, or `[B, H, W]` stacks of them (a batch of
    canvases for `parallel.BatchedGraph`), as contiguous f32 tensors on
    `device`."""
    return [
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
        for a in arrays
    ]
