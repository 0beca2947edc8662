"""Recipe-hash memoization: node outputs keyed by content hashes.

BASELINE.json's north star calls for a cache "keyed on node content hashes
so interactive LiveGraph edits re-evaluate only dirty subgraphs". Dirty-state
tracking alone re-evaluates everything an edit *touched*; recipe hashing goes
further — a node whose recipe (op kind, parameters, resize policy/filter,
and its inputs' recipes, Merkle-style) matches something already computed is
committed from cache without any device work. Undo/redo, disconnect +
reconnect, and A/B toggles between two values become O(hash) instead of
O(recompute).

Recipes of non-deterministic leaves:
- `Image`: path + file (size, mtime_ns) — editing the file changes the
  recipe, so stale pixels are never served;
- `Embed` / `InputGray` / `InputRgba`: the identity of the bound SlotImage
  (stable while the same data object is registered);
- `Write`: never cached (host side effect).

Cached planes live in ordinary `PlaneBuffer`s, so the tiered memory manager
evicts them device→host→disk like any other plane; the cache itself is
LRU-bounded by entry count.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional

from .node import NodeTypeKind, ResizePolicyKind


class RecipeCache:
    """LRU bounded by entry count AND pinned bytes: cached planes stay
    evictable to host/disk by the tier manager, but the cache must not pin
    unbounded host memory (512 entries of 4k RGBA would be ~0.5 TB)."""

    def __init__(self, capacity: int = 512, byte_budget: int = 1 << 30):
        self._entries: OrderedDict[str, list] = OrderedDict()  # hash → [(slot_id, SlotImage)]
        # planes alias ACROSS entries (an Output's SlotImage shares its
        # producer's PlaneBuffers, SeparateRgba outputs share the source's),
        # so byte accounting refcounts unique planes cache-wide — per-entry
        # sums would count one 64 MB plane N times and thrash the budget
        self._plane_refs: dict[int, list] = {}  # id(plane) → [bytes, refcount]
        self._total_bytes = 0
        self._lock = threading.Lock()
        self.capacity = capacity
        self.byte_budget = byte_budget
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _unique_planes(outputs: list):
        seen = {}
        for _, image in outputs:
            for plane in image.planes:
                seen[id(plane)] = plane
        return seen

    def _add_planes_locked(self, outputs: list) -> int:
        """Refcount an entry's planes in; returns bytes NEWLY pinned."""
        added = 0
        for pid, plane in self._unique_planes(outputs).items():
            ref = self._plane_refs.get(pid)
            if ref is None:
                self._plane_refs[pid] = [plane.bytes(), 1]
                added += plane.bytes()
            else:
                ref[1] += 1
        return added

    def _drop_planes_locked(self, outputs: list) -> int:
        """Refcount an entry's planes out; returns bytes UNPINNED."""
        removed = 0
        for pid in self._unique_planes(outputs):
            ref = self._plane_refs.get(pid)
            if ref is None:  # pragma: no cover — accounting invariant
                continue
            ref[1] -= 1
            if ref[1] == 0:
                removed += ref[0]
                del self._plane_refs[pid]
        return removed

    def get(self, recipe: str):
        with self._lock:
            entry = self._entries.get(recipe)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(recipe)
            self.hits += 1
            return list(entry)

    def _evict_lru_locked(self) -> None:
        _, outputs = self._entries.popitem(last=False)
        self._total_bytes -= self._drop_planes_locked(outputs)

    def put(self, recipe: str, outputs: list) -> None:
        with self._lock:
            if recipe in self._entries:
                old = self._entries.pop(recipe)
                self._total_bytes -= self._drop_planes_locked(old)
            # would-be-NEWLY-pinned bytes: planes already refcounted by
            # other entries (aliased Output re-keyings) cost nothing to
            # add — measuring the entry's total unique bytes here instead
            # rejected exactly the cheap-alias entries the refcounting
            # exists to credit
            fresh = sum(
                plane.bytes()
                for pid, plane in self._unique_planes(outputs).items()
                if pid not in self._plane_refs
            )
            if fresh > self.byte_budget:
                # an entry that alone exceeds the budget would drain the
                # whole cache down to itself and be evicted by the next
                # put anyway — don't insert it at all
                return
            self._entries[recipe] = list(outputs)
            self._total_bytes += self._add_planes_locked(outputs)
            while len(self._entries) > self.capacity or (
                self._total_bytes > self.byte_budget and len(self._entries) > 1
            ):
                self._evict_lru_locked()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._total_bytes,
                "hits": self.hits,
                "misses": self.misses,
            }


def _h(*parts) -> str:
    digest = hashlib.blake2b(digest_size=16)
    for part in parts:
        digest.update(repr(part).encode())
        digest.update(b"\x00")
    return digest.hexdigest()


def _nested_content_stamp(graph) -> tuple:
    """File stamps of every Image node inside a (possibly nested) subgraph."""
    stamps = []
    for node in graph.nodes:
        kind = node.node_type.kind
        if kind == NodeTypeKind.IMAGE:
            path = node.node_type.payload
            try:
                st = os.stat(path)
                stamps.append((int(node.node_id), st.st_size, st.st_mtime_ns))
            except OSError:
                stamps.append((int(node.node_id), "missing"))
        elif kind == NodeTypeKind.GRAPH:
            stamps.append((int(node.node_id), _nested_content_stamp(node.node_type.payload)))
    return tuple(stamps)


def node_recipe(node, input_recipes: list, live_graph) -> Optional[str]:
    """Merkle recipe hash for a node given its inputs' recipes (sorted by
    input slot). None → not cacheable."""
    kind = node.node_type.kind
    K = NodeTypeKind

    if kind == K.WRITE:
        return None

    policy = node.resize_policy
    policy_key = (
        policy.kind.value,
        int(policy.payload)
        if policy.kind == ResizePolicyKind.SPECIFIC_SLOT
        else (policy.payload.width, policy.payload.height)
        if policy.kind == ResizePolicyKind.SPECIFIC_SIZE
        else None,
    )
    base = (kind.value, policy_key, node.resize_filter.value)

    if kind == K.VALUE:
        import struct

        return _h(base, struct.pack("<f", node.node_type.payload))
    if kind == K.IMAGE:
        path = node.node_type.payload
        try:
            st = os.stat(path)
            stamp = (st.st_size, st.st_mtime_ns)
        except OSError:
            stamp = ("missing",)
        return _h(base, path, stamp)
    if kind == K.EMBED:
        esd_id = node.node_type.payload
        for esd in live_graph.embedded_slot_datas():
            if esd.slot_data_id == esd_id:
                return _h(base, int(esd_id), esd.image.uid)
        return None
    if kind in (K.INPUT_GRAY, K.INPUT_RGBA):
        datas = live_graph.input_slot_datas()
        if kind == K.INPUT_RGBA:
            if not datas:
                return None
            return _h(base, datas[0].image.uid)
        for slot_data in datas:
            if slot_data.node_id == node.node_id:
                return _h(base, slot_data.image.uid)
        return None
    if kind == K.GRAPH:
        import json

        # nested Value payloads DO matter for results, so hash the raw JSON;
        # nested Image files matter too — stamp their content like top-level
        # Image nodes, so rewriting a file inside a subgraph changes the recipe
        inner = json.dumps(node.node_type.payload.to_json(), sort_keys=True)
        return _h(base, inner, _nested_content_stamp(node.node_type.payload), input_recipes)
    if kind == K.MIX:
        return _h(base, node.node_type.payload.value, input_recipes)
    if kind == K.BLUR:
        import struct

        return _h(base, struct.pack("<f", node.node_type.payload), input_recipes)
    if kind == K.LEVELS:
        import struct

        return _h(base, struct.pack("<5f", *node.node_type.payload), input_recipes)
    if kind == K.CURVATURE:
        import struct

        return _h(base, struct.pack("<f", node.node_type.payload), input_recipes)
    if kind == K.AMBIENT_OCCLUSION:
        import struct

        return _h(base, struct.pack("<2f", *node.node_type.payload), input_recipes)
    if kind == K.DISTANCE:
        import struct

        return _h(base, struct.pack("<f", node.node_type.payload), input_recipes)
    if kind == K.HSV:
        import struct

        return _h(base, struct.pack("<3f", *node.node_type.payload), input_recipes)
    if kind == K.NOISE:
        import struct

        w, h, cells, octaves, seed, pers = node.node_type.payload
        return _h(
            base,
            (int(w), int(h), int(cells), int(octaves), int(seed)),
            struct.pack("<f", pers),
            input_recipes,
        )
    if kind == K.PATTERN:
        import struct

        w, h, pat, cx, cy, mortar, bevel, seed = node.node_type.payload
        return _h(
            base,
            (int(w), int(h), str(pat), int(cx), int(cy), int(seed)),
            struct.pack("<2f", mortar, bevel),
            input_recipes,
        )
    if kind == K.VORONOI:
        import struct

        w, h, cx, cy, jitter, seed = node.node_type.payload
        return _h(
            base,
            (int(w), int(h), int(cx), int(cy), int(seed)),
            struct.pack("<f", jitter),
            input_recipes,
        )
    if kind == K.RAMP:
        import struct

        w, h, rkind, angle, cx, cy, scale = node.node_type.payload
        return _h(
            base,
            (int(w), int(h), str(rkind)),
            struct.pack("<4f", angle, cx, cy, scale),
            input_recipes,
        )
    if kind == K.GRADIENT_MAP:
        import struct

        packed = b"".join(struct.pack("<5f", *s) for s in node.node_type.payload)
        return _h(base, packed, input_recipes)
    if kind == K.TRANSFORM:
        import struct

        return _h(base, struct.pack("<5f", *node.node_type.payload), input_recipes)
    if kind == K.WARP:
        import struct

        return _h(base, struct.pack("<2f", *node.node_type.payload), input_recipes)
    # the payload-LESS kinds: recipe is structure + inputs only
    if kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA, K.HEIGHT_TO_NORMAL,
                K.SEPARATE_RGBA, K.COMBINE_RGBA):
        return _h(base, input_recipes)
    # Unknown/new kind: its payload is NOT hashed above yet — refuse to
    # cache rather than serve stale results after a param edit (the
    # seed-11 soak caught AmbientOcclusion/Distance falling through a
    # payload-dropping default here: MISMATCH at iter 2, 256 bytes).
    return None
