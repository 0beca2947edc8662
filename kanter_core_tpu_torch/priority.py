"""Priority propagation.

Port of the algorithm in `vismut_core/src/priority.rs` — pure graph
arithmetic: a node's effective ("propagated") priority is the max of its own
priority and its children's propagated priorities, pushed transitively to
ancestors so prerequisites of a hot node are scheduled first
(`priority.rs:96-167`).

Priorities are i8-valued; `touched` marks nodes whose priorities must be
recomputed on the next propagation pass.
"""

from __future__ import annotations

import threading

I8_MIN = -128
I8_MAX = 127


def _clamp_i8(value: int) -> int:
    return max(I8_MIN, min(I8_MAX, int(value)))


class Priority:
    """Shared per-node priority handle (`priority.rs:12-16`)."""

    __slots__ = ("_lock", "_touched", "_priority", "_propagated")

    def __init__(self):
        self._lock = threading.Lock()
        self._touched = True
        self._priority = 0
        self._propagated = 0

    def set_priority(self, value: int) -> None:
        value = _clamp_i8(value)
        with self._lock:
            if self._priority != value:
                self._priority = value
                self._touched = True

    def priority(self) -> int:
        return self._priority

    def propagated_priority(self) -> int:
        return self._propagated

    def touch(self) -> None:
        with self._lock:
            self._touched = True

    def _untouch(self) -> None:
        with self._lock:
            self._touched = False

    def touched(self) -> bool:
        return self._touched

    def _store_propagated(self, value: int) -> None:
        self._propagated = _clamp_i8(value)

    def _fetch_max_propagated(self, value: int) -> int:
        """Atomic fetch_max on the propagated priority (`priority.rs:150-153`)."""
        with self._lock:
            old = self._propagated
            if value > old:
                self._propagated = _clamp_i8(value)
            return old


class PriorityPropagator:
    """Propagates priorities through the DAG (`priority.rs:81-167`)."""

    def __init__(self):
        self.priorities: list[tuple] = []  # [(NodeId, Priority)]

    def push_priority(self, node_id, priority: Priority) -> None:
        if all(nid != node_id for nid, _ in self.priorities):
            self.priorities.append((node_id, priority))

    def _prio_of_node_id(self, node_id):
        for entry in self.priorities:
            if entry[0] == node_id:
                return entry
        return None

    def _set_max_prio(self, priority: Priority, node_graph, node_id) -> int:
        max_child_prio = I8_MIN
        for child_id in node_graph.get_children(node_id):
            entry = self._prio_of_node_id(child_id)
            if entry is not None:
                max_child_prio = max(max_child_prio, entry[1].propagated_priority())
        prio = max(max_child_prio, priority.priority())
        priority._store_propagated(prio)
        return prio

    def update(self, node_graph) -> None:
        """One propagation pass over all touched priorities (`priority.rs:101-127`).

        In the reference, entries whose `Arc<Priority>` is solely owned by the
        propagator belong to removed nodes and are dropped; here, entries whose
        node no longer exists in the graph are dropped.
        """
        for i in reversed(range(len(self.priorities))):
            node_id = self.priorities[i][0]
            try:
                node_graph.has_node_with_id(node_id)
            except Exception:
                del self.priorities[i]

        self.priorities.sort(key=lambda entry: entry[1].priority())

        for node_id, priority in [e for e in reversed(self.priorities) if e[1].touched()]:
            new_prio = self._set_max_prio(priority, node_graph, node_id)
            priority._untouch()
            own = priority.priority()
            if new_prio < own:
                self._propagate_priority(node_id, priority, node_graph)
            elif new_prio > own:
                self._set_max_prio(priority, node_graph, node_id)
                self._propagate_priority(node_id, priority, node_graph)

    def _propagate_priority(self, this_node_id, this_prio: Priority, node_graph) -> None:
        # iterative worklist (deep chains must not hit the recursion limit)
        stack = [(this_node_id, this_prio)]
        while stack:
            node_id, prio = stack.pop()
            propagated = prio.propagated_priority()
            for parent in node_graph.get_parents(node_id):
                entry = self._prio_of_node_id(parent)
                if entry is None:
                    continue
                parent_node_id, parent_prio = entry
                old = parent_prio._fetch_max_propagated(propagated)
                if old < propagated:
                    stack.append((parent_node_id, parent_prio))
                elif old > propagated:
                    self._set_max_prio(parent_prio, node_graph, parent_node_id)
                    stack.append((parent_node_id, parent_prio))
