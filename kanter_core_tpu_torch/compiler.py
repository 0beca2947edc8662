"""Fused graph evaluation: a dirty partition → one pass over torch tensors.

Port of `kanter_core_tpu/compiler.py`. The JAX package traces a graph into
one jitted XLA program; here the "program" is a cached Python evaluator that
walks the graph in topological order and calls the ops' tensor functions
eagerly on the device of its bindings. What carries over unchanged:

- runtime-variable leaves are *arguments* (`Value` scalars, `InputGray`/
  `InputRgba` planes, `Embed` planes, and the preset planes of a partition's
  clean boundary), so an edit re-runs the cached evaluator with new
  bindings;
- the resize pass before every node (`calculate_size` + `resample_plane`),
  with the eager path's edge-insertion order for policy ties;
- the output layout (`call_with_layout`): every output plane is reported
  once, and outputs that alias one plane (Output re-keying, SeparateRgba,
  gray→rgba coercion) share its index, like the reference's Arc-shared
  channel planes;
- the structure fingerprint (`graph_fingerprint`) that keys the cache, with
  Value constants normalized out.

Not carried over: `_const_guard` and the `optimization_barrier` shims, which
keep XLA's constant folder away from constant planes — eager torch does not
fold. Node kinds whose ops are not yet ported (Image, Graph, Write and the
extension ops other than Blur) raise a `NODE_PROCESSING` error.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

import numpy as np
import torch

from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .node import NodeTypeKind
from .node_graph import NodeGraph
from .ops.blur import blur_plane
from .ops.height_to_normal import h2n_planes
from .ops.mix import _binary
from .ops.resize import calculate_size, resample_plane


def _topo_order(graph) -> list:
    """Iterative post-order topological sort (parents before children)."""
    order, done, in_progress = [], set(), set()
    for root in graph.nodes:
        if root.node_id in done:
            continue
        stack = [(root.node_id, False)]
        while stack:
            node_id, expanded = stack.pop()
            if node_id in done:
                continue
            if expanded:
                in_progress.discard(node_id)
                done.add(node_id)
                order.append(node_id)
                continue
            if node_id in in_progress:
                continue  # cycle guard (cannot happen in valid graphs)
            in_progress.add(node_id)
            stack.append((node_id, True))
            for parent in graph.get_parents(node_id):
                if parent not in done:
                    stack.append((parent, False))
    return order


class ImgVal:
    """An image during evaluation: 1 (gray) or 4 (rgba) plane tensors."""

    __slots__ = ("planes",)

    def __init__(self, planes):
        self.planes = list(planes)

    @property
    def is_rgba(self) -> bool:
        return len(self.planes) == 4

    @property
    def size(self) -> Size:
        h, w = self.planes[0].shape
        return Size(w, h)


class _SymData:
    """SlotData shim so `calculate_size` works on evaluation values."""

    __slots__ = ("node_id", "slot_id", "img")

    def __init__(self, node_id, slot_id, img: ImgVal):
        self.node_id = node_id
        self.slot_id = slot_id
        self.img = img

    def size(self) -> Size:
        return self.img.size


def _as_type(img: ImgVal, rgba: bool) -> ImgVal:
    if img.is_rgba == rgba:
        return img
    if rgba:
        g = img.planes[0]
        return ImgVal([g, g, g, torch.ones_like(g)])
    r, g, b = img.planes[:3]
    s = (r + g) + b
    # a full-tensor divisor: a scalar divisor may become a reciprocal
    # multiply on CUDA and round differently from the reference's division
    return ImgVal([s / torch.full_like(s, 3.0)])


def _not_ported(kind) -> TexProError:
    return TexProError(
        ErrorKind.NODE_PROCESSING, f"{kind.value} nodes are not yet ported"
    )


class GraphCompiler:
    """Evaluates a NodeGraph's nodes in topological order on `device`."""

    def __init__(self, node_graph: NodeGraph, device: torch.device, preset=None):
        self.node_graph = node_graph
        self.device = torch.device(device)
        # preset: {(NodeId, SlotId): n_planes} — nodes whose outputs are
        # already computed (clean boundary of a dirty partition); their
        # planes are arguments instead of being re-evaluated.
        self.preset = dict(preset or {})

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.device)

    def _from_value(self, size: Size, value: float, rgba: bool) -> ImgVal:
        shape = (size.height, size.width)
        plane = torch.full(shape, float(value), dtype=torch.float32, device=self.device)
        if rgba:
            return ImgVal([plane, plane, plane, self._ones(shape)])
        return ImgVal([plane])

    def _eval_graph(self, graph: NodeGraph, args: dict) -> dict:
        """Returns {(node_id, slot_id): ImgVal} for every node in `graph`."""
        values: dict = {}
        preset_nodes = {nid for nid, _ in self.preset}

        for node_id in _topo_order(graph):
            if node_id in preset_nodes:
                for (nid, slot), _count in self.preset.items():
                    if nid == node_id:
                        values[(nid, slot)] = ImgVal(
                            list(args[f"preset_{int(nid)}_{int(slot)}"])
                        )
                continue
            node = graph.node(node_id)
            # The eager path gathers inputs in edge INSERTION order and only
            # sorts the edge list (`node_type.rs:229-236`), so MostPixels/
            # LeastPixels pixel-count ties resolve by insertion order.
            edges_ins = [e for e in graph.edges if e.input_id == node_id]
            edges_sorted = sorted(edges_ins, key=lambda e: e.input_slot)
            inputs = [
                _SymData(e.output_id, e.output_slot, values[(e.output_id, e.output_slot)])
                for e in edges_ins
            ]

            # resize pass (`shared.rs:141-216`)
            if inputs:
                size = calculate_size(inputs, edges_sorted, node.resize_policy)
                inputs = [
                    _SymData(
                        sd.node_id,
                        sd.slot_id,
                        ImgVal(
                            [resample_plane(p, size, node.resize_filter) for p in sd.img.planes]
                        )
                        if sd.size() != size
                        else sd.img,
                    )
                    for sd in inputs
                ]
            # re-key to consumer slots (`node_type.rs:250-267`): first input
            # matching the edge's producer key, like `assign_slot_ids`
            by_slot = {}
            for edge in edges_sorted:
                for sd in inputs:
                    if sd.node_id == edge.output_id and sd.slot_id == edge.output_slot:
                        by_slot[edge.input_slot] = sd.img
                        break

            for slot_id, img in self._emit(node, by_slot, args):
                values[(node_id, slot_id)] = img
        return values

    def _emit(self, node, by_slot: dict, args):
        K = NodeTypeKind
        kind = node.node_type.kind
        nid = int(node.node_id)

        if kind == K.VALUE:
            # scalar argument → 1×1 plane
            val = args[f"value_{nid}"]
            return [(SlotId(0), ImgVal([
                torch.full((1, 1), float(val), dtype=torch.float32, device=self.device)
            ]))]

        if kind in (K.INPUT_GRAY, K.INPUT_RGBA):
            if kind == K.INPUT_RGBA:
                if "input_rgba_first" not in args:
                    raise TexProError(ErrorKind.NODE_PROCESSING, "InputRgba with no outer input")
                img = args["input_rgba_first"]
            else:
                key = f"input_{nid}"
                if key not in args:
                    raise TexProError(
                        ErrorKind.INVALID_BUFFER_COUNT,
                        f"InputGray node {nid} has no bound input",
                    )
                img = args[key]
            return [(SlotId(0), ImgVal(list(img)))]

        if kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
            if by_slot:
                return [(SlotId(0), by_slot[min(by_slot)])]
            if kind == K.OUTPUT_RGBA:
                z = self._zeros((1, 1))
                return [(SlotId(0), ImgVal([z, z, z, self._ones((1, 1))]))]
            return [(SlotId(0), ImgVal([self._zeros((1, 1))]))]

        if kind == K.MIX:
            left, right = by_slot.get(SlotId(0)), by_slot.get(SlotId(1))
            op = _binary(node.node_type.payload)
            if left is not None:
                rgba = left.is_rgba
                right = (
                    _as_type(right, rgba)
                    if right is not None
                    else self._from_value(left.size, 0.0, rgba)
                )
            elif right is not None:
                left = self._from_value(right.size, 0.0, right.is_rgba)
            else:
                return [(SlotId(0), ImgVal([self._zeros((1, 1))]))]
            if left.is_rgba:
                planes = [op(left.planes[i], right.planes[i]) for i in range(3)]
                planes.append(torch.ones_like(planes[0]))
            else:
                planes = [op(left.planes[0], right.planes[0])]
            return [(SlotId(0), ImgVal(planes))]

        if kind == K.HEIGHT_TO_NORMAL:
            inp = by_slot.get(SlotId(0))
            if inp is None or inp.is_rgba:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "HeightToNormal needs a Gray input"
                )
            return [(SlotId(0), ImgVal(list(h2n_planes(inp.planes[0]))))]

        if kind == K.BLUR:
            inp = by_slot.get(SlotId(0))
            if inp is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, "Blur needs an input"
                )
            sigma = node.node_type.payload
            return [(SlotId(0), ImgVal([blur_plane(p, sigma) for p in inp.planes]))]

        if kind == K.SEPARATE_RGBA:
            inp = by_slot.get(SlotId(0))
            if inp is not None and inp.is_rgba:
                return [(SlotId(i), ImgVal([inp.planes[i]])) for i in range(4)]
            return [(SlotId(i), ImgVal([self._zeros((1, 1))])) for i in range(4)]

        if kind == K.COMBINE_RGBA:
            size = by_slot[min(by_slot)].size if by_slot else Size(1, 1)
            shape = (size.height, size.width)
            shared_zero = None

            def plane_of(slot):
                img = by_slot.get(SlotId(slot))
                if img is not None and img.is_rgba:
                    # matches the eager op's fatal error (`combine_rgba.rs:22-25`)
                    raise TexProError(
                        ErrorKind.INVALID_SLOT_TYPE,
                        "RGBA image connected to a CombineRgba input slot",
                    )
                return None if img is None else img.planes[0]

            colors = []
            for slot in range(3):
                plane = plane_of(slot)
                if plane is None:
                    if shared_zero is None:
                        shared_zero = self._zeros(shape)
                    plane = shared_zero
                colors.append(plane)
            alpha = plane_of(3)
            if alpha is None:
                alpha = self._ones(shape)
            return [(SlotId(0), ImgVal([*colors, alpha]))]

        if kind == K.EMBED:
            planes = args.get(f"embed_{int(node.node_type.payload)}")
            if planes is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT,
                    f"no embedded slot data with id {int(node.node_type.payload)}",
                )
            return [(SlotId(0), ImgVal(list(planes)))]

        raise _not_ported(kind)


class CompiledGraph:
    """A cached, reusable evaluator for a node graph on one device.

    `call_with_layout` evaluates every node not in `preset` and returns the
    unique output planes plus the layout that maps each output slot to them.
    """

    def __init__(self, node_graph: NodeGraph, device, preset=None):
        self.node_graph = node_graph
        self.device = torch.device(device)
        self.preset = dict(preset or {})
        self._compiler = GraphCompiler(node_graph, self.device, preset=self.preset)
        self._bindings = collect_value_bindings(node_graph)

    def call_with_layout(self, **overrides):
        """Returns `(unique_planes, layout)`: `layout` maps
        `(node_id, slot_id) → (unique_plane_index, ...)`. Plane aliasing
        across outputs is kept by deduplicating identical tensors (every
        value stays referenced in `values` meanwhile, so `id` is unique)."""
        args = dict(self._bindings)
        args.update(overrides)
        values = self._compiler._eval_graph(self.node_graph, args)
        preset_node_ids = {nid for nid, _ in self.preset}
        unique: dict = {}  # id(tensor) → (index, tensor)
        layout: dict = {}
        for key, img in values.items():
            if key[0] in preset_node_ids:
                continue
            idxs = []
            for plane in img.planes:
                pid = id(plane)
                if pid not in unique:
                    unique[pid] = (len(unique), plane)
                idxs.append(unique[pid][0])
            layout[key] = tuple(idxs)
        ordered = sorted(unique.values(), key=lambda iv: iv[0])
        return tuple(plane for _, plane in ordered), layout


def _normalize_values(graph_json):
    """Zero out Value payloads: they are arguments, so two graphs differing
    only in those constants share one cached evaluator."""
    out = {"nodes": [], "edges": graph_json["edges"]}
    for node in graph_json["nodes"]:
        node_type = node["node_type"]
        if isinstance(node_type, dict):
            if "Value" in node_type:
                node = dict(node, node_type={"Value": 0.0})
            elif "Graph" in node_type:
                node = dict(node, node_type={"Graph": _normalize_values(node_type["Graph"])})
        out["nodes"].append(node)
    return out


def graph_fingerprint(node_graph: NodeGraph, extra: str = "") -> str:
    """Structure hash for evaluator caching: topology + params. Value-node
    constants are excluded (see `_normalize_values`)."""
    blob = json.dumps(_normalize_values(node_graph.to_json()), sort_keys=True) + extra
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def collect_value_bindings(node_graph: NodeGraph) -> dict:
    """Current Value payloads as argument overrides."""
    return {
        f"value_{int(node.node_id)}": np.float32(node.node_type.payload)
        for node in node_graph.nodes
        if node.node_type.kind == NodeTypeKind.VALUE
    }
