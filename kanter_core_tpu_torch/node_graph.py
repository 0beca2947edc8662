"""Pure graph topology + JSON persistence.

Mirrors `vismut_core/src/node_graph.rs`: node/edge storage, id allocation,
connect/disconnect semantics (including implicit disconnect of an occupied
input slot, `node_graph.rs:434`), input/output-node name deduplication
(`node_graph.rs:141-164`), parent/child queries, and a serde_json-compatible
`{nodes, edges}` JSON format (`vismut_core/data/invert_graph.json`).
"""

from __future__ import annotations

import json
from typing import Optional

from .edge import Edge
from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .node import Node, NodeType, NodeTypeKind, MixType, Side, Slot


class NodeGraph:
    def __init__(self):
        self.nodes: list[Node] = []
        self.edges: list[Edge] = []
        self._node_id_counter = NodeId(0)

    def clone(self) -> "NodeGraph":
        graph = NodeGraph()
        graph.nodes = [node.clone() for node in self.nodes]
        graph.edges = list(self.edges)
        graph._node_id_counter = self._node_id_counter
        return graph

    # --- persistence (`node_graph.rs:33-46,98-107`) ---
    @staticmethod
    def from_path(path: str) -> "NodeGraph":
        # malformed JSON surfaces as an IO-kind TexProError, matching the
        # reference's io::Result return (`node_graph.rs:33`, where
        # serde_json::Error converts into io::Error)
        with open(path, "r") as f:
            try:
                graph = NodeGraph.from_json(json.load(f))
            except TexProError as e:
                # structural validation inside from_json (e.g. a bogus
                # resize-policy tag) raises its own kinds; the documented
                # contract is IO for ANY malformed file
                raise TexProError(ErrorKind.IO, f"invalid graph JSON: {e}") from e
            except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
                raise TexProError(ErrorKind.IO, f"invalid graph JSON: {e}") from e
        if graph.nodes:
            graph._node_id_counter = NodeId(max(int(n.node_id) for n in graph.nodes) + 1)
        else:
            graph._node_id_counter = NodeId(0)
        graph.validate_acyclic()
        return graph

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    def to_json(self) -> dict:
        return {
            "nodes": [node.to_json() for node in self.nodes],
            "edges": [edge.to_json() for edge in self.edges],
        }

    @staticmethod
    def from_json(data: dict) -> "NodeGraph":
        graph = NodeGraph()
        graph.nodes = [Node.from_json(n) for n in data.get("nodes", [])]
        graph.edges = [Edge.from_json(e) for e in data.get("edges", [])]
        return graph

    # --- node settings edits (`node_graph.rs:48-83`) ---
    def set_mix_type(self, node_id: NodeId, mix_type: MixType) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.MIX:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Mix(mix_type)

    def set_blur_sigma(self, node_id: NodeId, sigma: float) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.BLUR:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Blur(sigma)

    def set_hsv(self, node_id: NodeId, hue, saturation, value) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.HSV:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Hsv(hue, saturation, value)

    def set_distance(self, node_id: NodeId, max_dist: float) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.DISTANCE:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Distance(max_dist)

    def set_ambient_occlusion(self, node_id: NodeId, strength: float,
                              radius: float) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.AMBIENT_OCCLUSION:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.AmbientOcclusion(strength, radius)

    def set_curvature(self, node_id: NodeId, strength: float) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.CURVATURE:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Curvature(strength)

    def set_levels(self, node_id: NodeId, in_lo, in_hi, gamma, out_lo, out_hi) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.LEVELS:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Levels(in_lo, in_hi, gamma, out_lo, out_hi)

    def set_noise(self, node_id: NodeId, width, height, cells, octaves,
                  seed, persistence) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.NOISE:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Noise(width, height, cells, octaves, seed, persistence)

    def set_pattern(self, node_id: NodeId, width, height, pattern, cells_x,
                    cells_y, mortar, bevel, seed) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.PATTERN:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Pattern(
            width, height, pattern, cells_x, cells_y, mortar, bevel, seed
        )

    def set_voronoi(self, node_id: NodeId, width, height, cells_x, cells_y,
                    jitter, seed) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.VORONOI:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Voronoi(
            width, height, cells_x, cells_y, jitter, seed
        )

    def set_ramp(self, node_id: NodeId, width, height, kind, angle,
                 cx, cy, scale) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.RAMP:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Ramp(
            width, height, kind, angle, cx, cy, scale
        )

    def set_transform(self, node_id: NodeId, offset_x, offset_y, rotation,
                      scale_x, scale_y) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.TRANSFORM:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Transform(
            offset_x, offset_y, rotation, scale_x, scale_y
        )

    def set_warp(self, node_id: NodeId, angle, intensity) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.WARP:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Warp(angle, intensity)

    def set_gradient_map(self, node_id: NodeId, stops) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.GRADIENT_MAP:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.GradientMap(stops)

    def set_image_node_path(self, node_id: NodeId, path: str) -> None:
        node = self._node_with_id_mut(node_id)
        if node is None or node.node_type.kind != NodeTypeKind.IMAGE:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        node.node_type = NodeType.Image(path)

    # --- id allocation (`node_graph.rs:86-96`) ---
    def new_id(self) -> NodeId:
        output = self._node_id_counter
        self._node_id_counter = NodeId(int(self._node_id_counter) + 1)
        while self._has_node_with_id(output):
            output = self._node_id_counter
            self._node_id_counter = NodeId(int(self._node_id_counter) + 1)
        return output

    def _index_of_node(self, node_id: NodeId) -> Optional[int]:
        for i, node in enumerate(self.nodes):
            if node.node_id == node_id:
                return i
        return None

    def _has_node_with_id(self, node_id: NodeId) -> bool:
        return any(node.node_id == node_id for node in self.nodes)

    def has_node_with_id(self, node_id: NodeId) -> None:
        if not self._has_node_with_id(node_id):
            raise TexProError(ErrorKind.INVALID_NODE_ID)

    def node_ids(self) -> list[NodeId]:
        return [node.node_id for node in self.nodes]

    def node(self, node_id: NodeId) -> Node:
        """Returns a clone sharing `priority`/`cancel` (reference `Node: Clone`)."""
        for node in self.nodes:
            if node.node_id == node_id:
                return node.clone()
        raise TexProError(ErrorKind.INVALID_NODE_ID)

    def node_kind(self, node_id: NodeId):
        """Non-cloning kind lookup (`node()` clones — including a GRAPH
        node's whole nested payload — which is far too heavy for hot-path
        callers that only need the kind). Returns None for a missing id."""
        for node in self.nodes:
            if node.node_id == node_id:
                return node.node_type.kind
        return None

    def _node_with_id_mut(self, node_id: NodeId) -> Optional[Node]:
        for node in self.nodes:
            if node.node_id == node_id:
                return node
        return None

    # --- name collision avoidance (`node_graph.rs:141-189`) ---
    @staticmethod
    def _avoid_name_collision(name_list: list[str], name: str) -> str:
        name_edit = str(name)
        while name_edit in name_list:
            head, sep, number = name_edit.rpartition("_")
            if sep:
                # Rust checks `number.chars().all(char::is_numeric)` (vacuously
                # true for an empty suffix), then `number.parse::<u32>()`:
                # success -> wrapping_add(1); failure (empty, > u32::MAX, or a
                # non-ASCII numeral) -> 0.
                if all(c.isdigit() for c in number):
                    try:
                        # Rust's u32::parse accepts ASCII digits ONLY —
                        # Python's int() also parses Unicode decimals
                        # (int('٣') == 3), which would dedup 'a_٣' to
                        # 'a_4' where the reference produces 'a_0'
                        parsed = (
                            int(number) if number and number.isascii() else -1
                        )
                    except ValueError:
                        parsed = -1
                    nxt = (parsed + 1) & 0xFFFFFFFF if 0 <= parsed <= 0xFFFFFFFF else 0
                    name_edit = f"{head}_{nxt}"
                else:
                    # Non-numeric suffix: the reference rebuilds from the HEAD
                    # (`format!("{}_0", name)` with `name` bound by rsplit_once),
                    # dropping the suffix: "foo_bar" -> "foo_0".
                    name_edit = f"{head}_0"
            else:
                name_edit = f"{name_edit}_0"
        return name_edit

    def _add_node_internal(self, node: Node, node_id: NodeId) -> NodeId:
        if node.node_type.name() is not None:
            name = node.node_type.name()
            if not name:
                name = "untitled"
            if node.node_type.is_input():
                name = self._avoid_name_collision(self.input_names(), name)
            else:
                name = self._avoid_name_collision(self.output_names(), name)
            node.node_type.set_name(name)
        node.node_id = NodeId(node_id)
        self.nodes.append(node)
        return node_id

    def input_nodes(self) -> list[Node]:
        return [node for node in self.nodes if node.node_type.is_input()]

    def output_nodes(self) -> list[Node]:
        return [node for node in self.nodes if node.node_type.is_output()]

    def input_names(self) -> list[str]:
        return [node.node_type.name() for node in self.input_nodes()]

    def output_names(self) -> list[str]:
        return [node.node_type.name() for node in self.output_nodes()]

    def rename_output_node(self, node_id: NodeId, new_name: str) -> str:
        """Renames an output node, returns the old name (`node_graph.rs:232-269`)."""
        name_list = self.output_names()
        node = self._node_with_id_mut(node_id)
        if node is None:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        if not node.node_type.is_output():
            raise TexProError(ErrorKind.INVALID_NODE_TYPE)
        old_name = node.node_type.name()
        name_list.remove(old_name)
        node.node_type.set_name(self._avoid_name_collision(name_list, new_name))
        return old_name

    # --- graph-as-node slot mapping: inner node id n ↔ outer SlotId(n)
    #     (`node_graph.rs:271-313`) ---
    def input_slot_id_with_name(self, name: str) -> Optional[SlotId]:
        for node in self.input_nodes():
            if node.node_type.name() == name:
                return SlotId(int(node.node_id))
        return None

    def output_slot_id_with_name(self, name: str) -> Optional[SlotId]:
        for node in self.output_nodes():
            if node.node_type.name() == name:
                return SlotId(int(node.node_id))
        return None

    def input_slots(self) -> list[Slot]:
        return [
            Slot(
                name=node.node_type.name(),
                slot_id=SlotId(int(node.node_id)),
                slot_type=node.node_type.to_slot_type(),
            )
            for node in self.input_nodes()
        ]

    def output_slots(self) -> list[Slot]:
        return [
            Slot(
                name=node.node_type.name(),
                slot_id=SlotId(int(node.node_id)),
                slot_type=node.node_type.to_slot_type(),
            )
            for node in self.output_nodes()
        ]

    def add_node(self, node: Node) -> NodeId:
        node_id = self.new_id()
        return self._add_node_internal(node, node_id)

    def add_node_with_id(self, node: Node) -> None:
        if self._has_node_with_id(node.node_id):
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        self._add_node_internal(node, node.node_id)

    def output_ids(self) -> list[NodeId]:
        return [node.node_id for node in self.nodes if node.node_type.is_output()]

    def input_ids(self) -> list[NodeId]:
        return [node.node_id for node in self.nodes if node.node_type.is_input()]

    def edge_indices_node(self, node_id: NodeId) -> list[int]:
        self.has_node_with_id(node_id)
        return [
            i
            for i, edge in enumerate(self.edges)
            if edge.output_id == node_id or edge.input_id == node_id
        ]

    def edge_indices_slot(self, node_id: NodeId, side: Side, slot_id: SlotId) -> list[int]:
        if side == Side.INPUT:
            return [
                i
                for i, edge in enumerate(self.edges)
                if edge.input_id == node_id and edge.input_slot == slot_id
            ]
        return [
            i
            for i, edge in enumerate(self.edges)
            if edge.output_id == node_id and edge.output_slot == slot_id
        ]

    def can_connect(
        self,
        output_node_id: NodeId,
        input_node_id: NodeId,
        output_slot_id: SlotId,
        input_slot_id: SlotId,
    ) -> None:
        self.node(output_node_id).output_slot_with_id(output_slot_id)
        self.node(input_node_id).input_slot_with_id(input_slot_id)
        if self.slot_occupied(input_node_id, Side.INPUT, input_slot_id):
            raise TexProError(ErrorKind.SLOT_OCCUPIED)
        self._check_no_cycle(output_node_id, input_node_id)

    def _check_no_cycle(self, output_node_id: NodeId, input_node_id: NodeId) -> None:
        """Rejects edges that would create a cycle (output reachable from input).

        Deliberate improvement over the reference: `node_graph.rs:416-446` has no
        reachability check, and a cyclic graph deadlocks evaluation (no node is
        ever processable, so `await_clean_*` spins forever).
        """
        if output_node_id == input_node_id or output_node_id in set(
            self.get_children_recursive(input_node_id)
        ):
            raise TexProError(ErrorKind.INVALID_EDGE, "connection would create a cycle")

    def validate_acyclic(self) -> None:
        """Raises InvalidEdge if the edge set contains a cycle, a dangling
        edge endpoint, or a cyclic NESTED subgraph (Graph-node payloads are
        validated recursively — an inner cycle hangs evaluation exactly like
        an outer one).

        Used by `LiveGraph.set_node_graph` and `NodeGraph.from_path` so that
        hand-edited or deserialized cyclic graphs fail loudly instead of
        hanging the engine (see `_check_no_cycle`). Kahn's algorithm.
        """
        from .node import NodeTypeKind

        ids = {node.node_id for node in self.nodes}
        for edge in self.edges:
            # explicit dangling checks: a missing consumer used to pass
            # silently (crashing later deep in evaluation) and a missing
            # producer was misreported as "contains a cycle"
            if edge.output_id not in ids or edge.input_id not in ids:
                raise TexProError(
                    ErrorKind.INVALID_EDGE,
                    f"dangling edge {int(edge.output_id)}->{int(edge.input_id)}"
                    " references a missing node",
                )
        indegree: dict[NodeId, int] = {node.node_id: 0 for node in self.nodes}
        for edge in self.edges:
            indegree[edge.input_id] += 1
        frontier = [nid for nid, deg in indegree.items() if deg == 0]
        seen = 0
        while frontier:
            nid = frontier.pop()
            seen += 1
            for edge in self.edges:
                if edge.output_id == nid:
                    indegree[edge.input_id] -= 1
                    if indegree[edge.input_id] == 0:
                        frontier.append(edge.input_id)
        if seen != len(indegree):
            raise TexProError(ErrorKind.INVALID_EDGE, "graph contains a cycle")
        for node in self.nodes:
            if node.node_type.kind == NodeTypeKind.GRAPH and node.node_type.payload:
                node.node_type.payload.validate_acyclic()

    def try_connect(
        self,
        output_node_id: NodeId,
        input_node_id: NodeId,
        output_slot_id: SlotId,
        input_slot_id: SlotId,
    ) -> None:
        self.can_connect(output_node_id, input_node_id, output_slot_id, input_slot_id)
        self.edges.append(Edge(output_node_id, input_node_id, output_slot_id, input_slot_id))

    def connect(
        self,
        output_node_id: NodeId,
        input_node_id: NodeId,
        output_slot_id: SlotId,
        input_slot_id: SlotId,
    ) -> Edge:
        """Force-connect: an occupied input slot is implicitly disconnected first
        (`node_graph.rs:416-446`)."""
        new_edge = Edge(output_node_id, input_node_id, output_slot_id, input_slot_id)

        output_node = self.node(output_node_id)
        input_node = self.node(input_node_id)

        output_slot_type = output_node.output_slot_with_id(output_slot_id).slot_type
        input_slot_type = input_node.input_slot_with_id(input_slot_id).slot_type
        output_slot_type.fits(input_slot_type)

        self._check_no_cycle(output_node_id, input_node_id)

        try:
            self.disconnect_slot(input_node_id, Side.INPUT, input_slot_id)
        except TexProError:
            pass  # don't care whether anything got disconnected

        # (no duplicate-edge check: the disconnect above just removed every
        # edge into this input slot, so `new_edge` cannot be present)
        self.edges.append(new_edge)
        return new_edge

    def slot_occupied(self, node_id: NodeId, side: Side, slot: SlotId) -> bool:
        if side == Side.INPUT:
            return any(e.input_id == node_id and e.input_slot == slot for e in self.edges)
        return any(e.output_id == node_id and e.output_slot == slot for e in self.edges)

    def remove_edge(self, edge: Edge) -> Edge:
        for i, edge_cmp in enumerate(self.edges):
            if edge_cmp == edge:
                self.node(edge.input_id).cancel.store(True)
                return self.edges.pop(i)
        raise TexProError(ErrorKind.INVALID_EDGE)

    def remove_node(self, node_id: NodeId) -> tuple[Node, list[Edge]]:
        removed_edges = self._disconnect_node(node_id)
        index = self._index_of_node(node_id)
        if index is None:
            raise TexProError(ErrorKind.INVALID_NODE_ID)
        return self.nodes.pop(index), removed_edges

    def _disconnect_node(self, node_id: NodeId) -> list[Edge]:
        self.node(node_id).cancel.store(True)
        removed = []
        for i in reversed(self.edge_indices_node(node_id)):
            removed.append(self.edges.pop(i))
        return removed

    def disconnect_slot(self, node_id: NodeId, side: Side, slot_id: SlotId) -> list[Edge]:
        self.node(node_id).cancel.store(True)
        removed = []
        for i in reversed(self.edge_indices_slot(node_id, side, slot_id)):
            removed.append(self.edges.pop(i))
        removed.reverse()
        if not removed:
            raise TexProError(ErrorKind.SLOT_NOT_OCCUPIED)
        return removed

    def connected_edges(self, node_id: NodeId, side: Side, slot_id: SlotId) -> list[Edge]:
        self.has_node_with_id(node_id)
        edges = [self.edges[i] for i in self.edge_indices_slot(node_id, side, slot_id)]
        if not edges:
            raise TexProError(ErrorKind.SLOT_NOT_OCCUPIED)
        return edges

    def input_edges(self, node_id: NodeId) -> list[Edge]:
        return [edge for edge in self.edges if edge.input_id == node_id]

    def get_children(self, node_id: NodeId) -> list[NodeId]:
        self.has_node_with_id(node_id)
        children = sorted({e.input_id for e in self.edges if e.output_id == node_id})
        return [NodeId(c) for c in children]

    def get_children_recursive(self, node_id: NodeId) -> list[NodeId]:
        # Iterative with a visited set: the reference's recursive version
        # (`node_graph.rs:566-575`) revisits shared descendants (exponential
        # on diamond graphs) and callers deduplicate anyway.
        output: list[NodeId] = []
        visited: set[NodeId] = set()
        stack = list(self.get_children(node_id))
        while stack:
            child = stack.pop()
            if child in visited:
                continue
            visited.add(child)
            output.append(child)
            stack.extend(self.get_children(child))
        return output

    def get_parents(self, node_id: NodeId) -> list[NodeId]:
        parents = sorted({e.output_id for e in self.edges if e.input_id == node_id})
        return [NodeId(p) for p in parents]
