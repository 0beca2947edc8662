"""Identifier newtypes.

`NodeId` / `SlotId` mirror the u32 newtypes at
`vismut_core/src/node_graph.rs:595,612`. They subclass `int` so they stay
hashable/orderable and can be used directly as indices (`as_usize`).
"""

from __future__ import annotations


class NodeId(int):
    __slots__ = ()

    def __repr__(self) -> str:
        return f"NodeId({int(self)})"

    def as_usize(self) -> int:
        return int(self)


class SlotId(int):
    __slots__ = ()

    def __repr__(self) -> str:
        return f"SlotId({int(self)})"

    def as_usize(self) -> int:
        return int(self)
