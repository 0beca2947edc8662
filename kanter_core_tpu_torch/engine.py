"""Scheduler: turns dirty graph state into device dispatches.

Port of the fused route of `kanter_core_tpu/engine.py` (itself a port of
`vismut_core/src/engine.rs`). Each tick:

1. commit finished results (state transitions, cache fill, commit-time
   cancel/ProcessingDirty check — `engine.rs:34-123`);
2. drop orphaned live graphs (`engine.rs:126`);
3. per live graph, gather the dirty ancestor closure of every requested node
   into ONE partition (`_collect_fused_pack`) and propagate priorities;
4. admission-control the packs via `ProcessPackManager` (`:185-198`);
5. dispatch each admitted partition to a pooled worker thread, which serves
   what it can from the recipe cache and evaluates the rest with one cached
   `CompiledGraph` on the processor's device.

All device work runs on the device's current (default) stream, from every
thread. Fatal errors mirror the reference's engine panic (`engine.rs:111-119`)
by setting `shutdown` and recording the error on the live graph, so blocked
`await_clean_*` callers re-raise it instead of hanging.

With a mesh (`TextureProcessor(mesh=...)`) the fused dispatch row-shards
its argument planes by the JAX package's rule (`_shard_overrides`) and
evaluates the partition over the mesh; the sharded result planes are
committed as slot data (and kept by the recipe cache) as they are.

Not yet ported: the per-node route (taken under `auto_update`, with
`fuse_subgraphs=False`, and for Write sinks) and the tiled, bucketed and
segmented routes. A per-node dispatch fails its graph with a
`NODE_PROCESSING` error saying so.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict

from .errors import ErrorKind, TexProError
from .live_graph import LiveGraph, NodeState
from .process_pack import ProcessPack


def _shard_overrides(overrides: dict, mesh) -> dict:
    """Row-shard every plane of the evaluator's arguments whose rows shard
    over the mesh (rows ≥ n and divisible by n), the JAX package's
    `_shard_overrides`; every other plane is a tensor on the mesh's first
    device. Planes already sharded pass as they are."""
    from .parallel.sharded import place

    return {
        key: tuple(place(mesh, p) for p in value) if isinstance(value, tuple) else value
        for key, value in overrides.items()
    }


class _ThreadMessage:
    """Result of a per-node dispatch: today always the "not yet ported"
    error (`_dispatch`)."""

    __slots__ = ("node_id", "result", "live_graph", "event")

    def __init__(self, node_id, result, live_graph, event=None):
        self.node_id = node_id
        self.result = result  # BaseException
        self.live_graph = live_graph
        self.event = event  # profiling.NodeEvent


class _FusedMessage:
    """Result of a fused-partition evaluation: slot datas per node, in
    topological commit order."""

    __slots__ = ("node_results", "result", "live_graph", "events", "recipes")

    def __init__(self, node_results, result, live_graph, events=None, recipes=None):
        self.node_results = node_results  # list[(node_id, list[SlotData])]
        self.result = result  # None on success, BaseException on failure
        self.live_graph = live_graph
        self.events = events or {}  # node_id → profiling.NodeEvent
        self.recipes = recipes or {}  # node_id → recipe hash (for cache fill)


class _FusedPack:
    """An admission unit covering a whole dirty partition."""

    __slots__ = ("node_id", "priority", "live_graph", "partition")

    def __init__(self, node_id, priority, live_graph, partition):
        self.node_id = node_id  # the requested node (for admission/priority)
        self.priority = priority
        self.live_graph = live_graph
        self.partition = partition  # list[NodeId], topo order


def _contains_write(node) -> bool:
    """True if the node is (or nests) a Write node — a host-side sink the
    fused evaluator cannot represent."""
    from .node import NodeTypeKind

    if node.node_type.kind == NodeTypeKind.WRITE:
        return True
    if node.node_type.kind == NodeTypeKind.GRAPH:
        return any(_contains_write(inner) for inner in node.node_type.payload.nodes)
    return False


class _WorkerPool:
    """Cached-thread dispatch pool (replaces the reference's
    one-OS-thread-per-node spawn, `engine.rs:288-306`): submitting reuses an
    idle worker when one exists and spawns otherwise, so load never queues
    behind a fixed-size pool. Idle workers expire after `IDLE_TTL_SECONDS`.
    The token protocol is the JAX package's, where its races are documented."""

    IDLE_TTL_SECONDS = 10.0

    def __init__(self, name: str = "kanter-worker"):
        self._name = name
        self._tasks: queue.Queue = queue.Queue()
        # one token per waiting worker not yet claimed by a submit; tokens
        # are fungible (any waiter may serve any task)
        self._idle_tokens = threading.Semaphore(0)
        self._serial = 0
        self._serial_lock = threading.Lock()

    def submit(self, fn, /, *args) -> None:
        # claim a waiting worker BEFORE queueing; spawn if none is waiting
        spawn = not self._idle_tokens.acquire(blocking=False)
        self._tasks.put((fn, args))
        if spawn:
            with self._serial_lock:
                self._serial += 1
                serial = self._serial
            threading.Thread(
                target=self._run, daemon=True, name=f"{self._name}-{serial}"
            ).start()

    def _wait_for_task(self):
        self._idle_tokens.release()
        try:
            return self._tasks.get(timeout=self.IDLE_TTL_SECONDS)
        except queue.Empty:
            if self._idle_tokens.acquire(blocking=False):
                return None  # removed our own (or a sibling's) token: retire
            # a submit claimed this worker's token: serve its task
            return self._tasks.get()

    def _run(self) -> None:
        try:
            task = self._tasks.get(timeout=1.0)
        except queue.Empty:
            # a waiting worker stole this spawn's task; reclaim its token,
            # or serve the task a submit queued against it
            if self._idle_tokens.acquire(blocking=False):
                return
            task = self._tasks.get()
        while task is not None:
            fn, args = task
            fn(*args)
            # an idle worker must not keep the finished task's engine, live
            # graph and planes alive for its idle TTL
            fn = args = task = None
            task = self._wait_for_task()


class Engine:
    TICK_SECONDS = 0.001
    IDLE_TICK_SECONDS = 0.02  # edits/requests/results wake the loop anyway

    FUSED_PROGRAM_CACHE_CAP = 64  # LRU bound on retained evaluators

    def __init__(self, tex_pro):
        self.tex_pro = tex_pro
        self._results: queue.Queue = queue.Queue()
        self._wake_cv = threading.Condition(threading.Lock())
        self._fused_programs: "OrderedDict" = OrderedDict()  # fingerprint → CompiledGraph
        self._fused_programs_lock = threading.Lock()
        self._pool = _WorkerPool()

    def wake(self) -> None:
        with self._wake_cv:
            self._wake_cv.notify_all()

    def run(self) -> None:
        """Scheduler thread entry: the loop body, with a last-resort guard —
        an exception escaping the loop would otherwise kill the daemon
        silently and strand every blocked waiter."""
        try:
            self._run_loop()
        except BaseException as error:  # noqa: BLE001 — surfacing, not hiding
            for lg in self.tex_pro.live_graphs_snapshot():
                lg.fatal_error = error
                lg._notify_state_change()
            self.tex_pro.shutdown.store(True)
            raise  # daemon thread: the traceback still reaches stderr

    def _run_loop(self) -> None:
        tex_pro = self.tex_pro
        while not tex_pro.shutdown.load():
            self._drain_results()
            tex_pro.drop_unused_live_graphs()

            process_packs: list = []
            for live_graph in tex_pro.live_graphs_snapshot():
                with live_graph.write():
                    process_packs.extend(self._collect_packs(live_graph))
                    live_graph.propagate_priorities()

            admitted = tex_pro.update_process_packs(process_packs)
            if admitted is None:
                return  # unexpected admission error → shutdown (engine.rs:188-197)

            for pack in admitted:
                if isinstance(pack, _FusedPack):
                    self._dispatch_fused(pack)
                else:
                    self._dispatch(pack)

            idle = not admitted and self._results.empty()
            # drop loop locals: a lingering `live_graph`/`pack` reference in
            # this long-lived frame would defeat the refcount-based orphan GC
            live_graph = pack = None  # noqa: F841
            process_packs = admitted = None  # noqa: F841
            with self._wake_cv:
                self._wake_cv.wait(
                    timeout=self.IDLE_TICK_SECONDS if idle else self.TICK_SECONDS
                )

    # --- result commit (`engine.rs:34-123`) ---
    def _drain_results(self) -> None:
        tex_pro = self.tex_pro
        while True:
            try:
                message = self._results.get_nowait()
            except queue.Empty:
                return
            live_graph = message.live_graph
            if not tex_pro.has_live_graph(live_graph):
                # graph removed while its dispatch was in flight: still END
                # the timeline events
                if isinstance(message, _FusedMessage):
                    for event in message.events.values():
                        tex_pro.timeline.end(event, "graph-removed")
                elif message.event is not None:
                    tex_pro.timeline.end(message.event, "graph-removed")
                continue
            if isinstance(message, _FusedMessage):
                self._commit_fused(message)
                continue
            with live_graph.write() as lg:
                self._commit_error(lg, message.node_id, message.result, message.event)

    def _graph_fatal(self, lg, error) -> None:
        """Surface `error` on the graph's waiters. Capacity and IO errors are
        graph-fatal only; everything else mirrors the reference's engine
        panic (`engine.rs:111-119`) by also shutting the processor down."""
        lg.fatal_error = error
        if not (
            isinstance(error, TexProError)
            and error.kind in (ErrorKind.RESOURCE_EXHAUSTED, ErrorKind.IO)
        ):
            self.tex_pro.shutdown.store(True)
        lg._notify_state_change()

    def _commit_error(self, lg, node_id, error, event=None) -> None:
        canceled = isinstance(error, TexProError) and error.kind == ErrorKind.CANCELED
        if event is not None:
            self.tex_pro.timeline.end(event, "canceled" if canceled else "error")
        if canceled:
            try:
                node = lg.node(node_id)
            except TexProError:
                return
            lg.force_state(node_id, NodeState.DIRTY)
            node.cancel.store(False)
        else:
            self._graph_fatal(lg, error)

    def _commit_success(self, lg, node_id, slot_datas, event=None, recipe=None) -> None:
        for slot_data in slot_datas:
            self.tex_pro.buffer_queue.add_slot_data(slot_data)

        lg.remove_nodes_data(node_id)
        lg.slot_datas.extend(slot_datas)

        # Without use_cache, evict parents whose children are all done
        # or in-flight. (This node is still Processing here — order
        # matters, `engine.rs:58-75`.)
        if not lg.use_cache:
            for parent in lg.node_graph.get_parents(node_id):
                children = lg.node_graph.get_children(parent)
                if all(
                    lg.node_state(c) in (NodeState.CLEAN, NodeState.PROCESSING)
                    for c in children
                ):
                    lg.remove_nodes_data(parent)

        # Commit-time cancellation: work finished for a node that was
        # edited meanwhile is discarded (`engine.rs:77-102`).
        not_clean = False
        try:
            node = lg.node(node_id)
        except TexProError:
            not_clean = True  # node removed while processing
        else:
            if node.cancel.take() or lg.node_state(node_id) == NodeState.PROCESSING_DIRTY:
                not_clean = True
            else:
                lg.set_state(node_id, NodeState.CLEAN)

        if not_clean:
            lg.remove_nodes_data(node_id)
            try:
                lg.force_state(node_id, NodeState.DIRTY)
            except TexProError:
                pass  # node removed while processing — nothing to re-dirty
        elif recipe is not None:
            lg._recipes[node_id] = recipe
            self.tex_pro.recipe_cache.put(
                recipe, [(sd.slot_id, sd.image) for sd in slot_datas]
            )
        else:
            # a clean commit without a recipe must not leave an outdated
            # recipe behind — later memoize passes would trust it
            lg._recipes.pop(node_id, None)
        if event is not None:
            self.tex_pro.timeline.end(event, "discarded" if not_clean else "clean")

    def _commit_fused(self, message: _FusedMessage) -> None:
        """Commit a fused partition node by node in topo order, under ONE
        graph-lock acquisition; per-node cancel/dirty checks apply exactly
        as in the per-node path."""
        live_graph = message.live_graph
        if message.result is not None:
            error = message.result
            canceled = isinstance(error, TexProError) and error.kind == ErrorKind.CANCELED
            for event in message.events.values():
                self.tex_pro.timeline.end(event, "canceled" if canceled else "error")
            with live_graph.write() as lg:
                if canceled:
                    for node_id, _ in message.node_results:
                        try:
                            node = lg.node(node_id)
                        except TexProError:
                            continue
                        if lg.node_state(node_id) in (
                            NodeState.PROCESSING,
                            NodeState.PROCESSING_DIRTY,
                        ):
                            lg.force_state(node_id, NodeState.DIRTY)
                        node.cancel.store(False)
                else:
                    self._graph_fatal(lg, error)
            return

        with live_graph.write() as lg:
            for node_id, slot_datas in message.node_results:
                self._commit_success(
                    lg,
                    node_id,
                    slot_datas,
                    message.events.get(node_id),
                    recipe=message.recipes.get(node_id),
                )

    # --- frontier selection (`engine.rs:128-183`) ---
    def _collect_packs(self, live_graph: LiveGraph) -> list:
        if (
            live_graph.fuse_subgraphs
            and not live_graph.auto_update
            and live_graph.fatal_error is None
        ):
            fused = self._collect_fused_pack(live_graph)
            if fused is not None:
                return fused
        if live_graph.fatal_error is not None:
            return []
        if live_graph.auto_update:
            requested = [
                nid
                for nid, state in sorted(live_graph.node_states().items())
                if state
                not in (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY, NodeState.CLEAN)
            ]
        else:
            requested = [
                nid
                for nid, state in sorted(live_graph.node_states().items())
                if state in (NodeState.REQUESTED, NodeState.PRIORITISED)
            ]

        closest: list = []
        for node_id in requested:
            closest.extend(live_graph.get_closest_processable(node_id))
        closest = sorted(set(closest))

        packs = []
        for node_id in closest:
            try:
                node = live_graph.node(node_id)
            except TexProError:
                continue  # node deleted meanwhile
            packs.append(ProcessPack(node_id, node.priority, live_graph))
        return packs

    def _collect_fused_pack(self, live_graph: LiveGraph):
        """The dirty ancestor closure of all requested nodes becomes ONE
        partition, evaluated by one cached `CompiledGraph`.

        Unfusable nodes (Write sinks, nodes already in flight) do NOT defeat
        fusion for the rest of the request: they and their dirty descendants
        are carved out of the partition and the maximal fusable remainder
        runs. Returns None to hand the tick to the per-node path (nothing
        fusable but unfusable work pending), or [] / [one _FusedPack].
        """
        requested = [
            nid
            for nid, state in sorted(live_graph.node_states().items())
            if state in (NodeState.REQUESTED, NodeState.PRIORITISED)
        ]
        if not requested:
            return []

        graph = live_graph.node_graph
        partition: set = set()
        unfusable: set = set()
        visited: set = set()
        edges_by_input: dict = {}
        for edge in graph.edges:
            edges_by_input.setdefault(edge.input_id, []).append(edge)
        stack = list(requested)
        while stack:
            node_id = stack.pop()
            if node_id in visited:
                continue
            visited.add(node_id)
            try:
                state = live_graph.node_state(node_id)
            except TexProError:
                continue
            if state in (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY):
                # in flight: don't fuse anything that depends on it this tick
                unfusable.add(node_id)
                continue
            if state == NodeState.CLEAN:
                continue
            try:
                node = graph.node(node_id)
            except TexProError:
                continue
            if _contains_write(node):
                unfusable.add(node_id)  # host sink; its parents still fuse
            else:
                partition.add(node_id)
            for parent in graph.get_parents(node_id):
                try:
                    pstate = live_graph.node_state(parent)
                except TexProError:
                    continue
                if pstate != NodeState.CLEAN:
                    stack.append(parent)
                else:
                    # clean boundary parent: its data must still exist, else
                    # recompute it as part of the partition. The re-dirty is
                    # NON-propagating: the parent's value is unchanged (only
                    # its data was evicted).
                    for edge in edges_by_input.get(node_id, ()):
                        if edge.output_id == parent:
                            try:
                                live_graph.slot_data(parent, edge.output_slot)
                            except TexProError:
                                stack.append(parent)
                                visited.discard(parent)
                                partition.discard(parent)
                                live_graph.redirty_for_recompute(parent)
                                break

        if unfusable:
            # carve out everything downstream of an unfusable node — it
            # cannot run before that node commits
            blocked: set = set()
            stack = list(unfusable)
            while stack:
                node_id = stack.pop()
                for child in graph.get_children(node_id):
                    if child in partition and child not in blocked:
                        blocked.add(child)
                        stack.append(child)
            partition -= blocked

        if not partition:
            return None if unfusable else []

        # admission priority: the hottest requested node speaks for the
        # partition
        anchor, priority = None, None
        for node_id in requested:
            try:
                prio = live_graph.node(node_id).priority
            except TexProError:
                continue
            if priority is None or prio.propagated_priority() > priority.propagated_priority():
                anchor, priority = node_id, prio
        if anchor is None:
            return []
        return [_FusedPack(anchor, priority, live_graph, sorted(partition))]

    def _memoize_partition(self, lg, partition: list) -> tuple[list, dict]:
        """Recipe-cache pass over a dirty partition (topo order): nodes whose
        recipe hash hits the cache are committed instantly without device
        work; the rest stay in the partition with their recipes attached so
        the commit can populate the cache. Caller holds the graph lock."""
        from .recipe_cache import node_recipe
        from .slot_data import SlotData

        graph = lg.node_graph
        if len(partition) > 1:
            order = {nid: i for i, nid in enumerate(self._topo_order(graph))}
            partition = sorted(partition, key=lambda nid: order.get(nid, 0))
        partition_set = set(partition)
        recipes: dict = {}
        remaining: list = []

        edges_by_input: dict = {}
        for edge in graph.edges:
            edges_by_input.setdefault(edge.input_id, []).append(edge)

        for node_id in partition:
            pairs = []
            cacheable = True
            for edge in sorted(
                edges_by_input.get(node_id, ()), key=lambda e: e.input_slot
            ):
                parent = edge.output_id
                if parent in partition_set:
                    recipe = recipes.get(parent)
                else:
                    try:
                        clean = lg.node_state(parent) == NodeState.CLEAN
                    except TexProError:
                        clean = False
                    recipe = lg._recipes.get(parent) if clean else None
                if recipe is None:
                    cacheable = False
                    break
                pairs.append((int(edge.input_slot), int(edge.output_slot), recipe))

            recipe = None
            if cacheable:
                try:
                    node = graph.node(node_id)
                    recipe = node_recipe(node, pairs, lg)
                except TexProError:
                    recipe = None
            recipes[node_id] = recipe

            hit = self.tex_pro.recipe_cache.get(recipe) if recipe else None
            if hit is not None:
                slot_datas = [
                    SlotData(node_id, slot_id, image) for slot_id, image in hit
                ]
                event = self.tex_pro.timeline.begin(
                    node_id, graph.node(node_id).node_type.kind.value, memoized=True
                )
                # mimic a real dispatch: mark Processing so _commit_success's
                # use_cache=False parent-eviction ordering and
                # ProcessingDirty semantics hold
                lg._set_state_raw(node_id, NodeState.PROCESSING)
                self._commit_success(lg, node_id, slot_datas, event, recipe=recipe)
            else:
                remaining.append(node_id)
        return remaining, recipes

    def _dispatch_fused(self, pack: _FusedPack) -> None:
        live_graph = pack.live_graph
        with live_graph.write() as lg:
            partition = []
            for node_id in pack.partition:
                try:
                    state = lg.node_state(node_id)
                except TexProError:
                    continue  # deleted meanwhile
                if state in (NodeState.PROCESSING, NodeState.PROCESSING_DIRTY, NodeState.CLEAN):
                    continue
                partition.append(node_id)
            # per-node admission un-cancels each node it admits
            # (`process_pack.rs:121-129`); do the same for every partition
            # member — BEFORE the memoize pass, or a lingering edit-cancel
            # flag makes _commit_success discard a legitimate cache hit
            for node_id in partition:
                try:
                    lg.node(node_id).cancel.store(False)
                except TexProError:
                    pass
            recipes: dict = {}
            if partition and lg.memoize:
                partition, recipes = self._memoize_partition(lg, partition)
            if not partition:
                return
            # remember which members carried the user's request: the
            # boundary-eviction race below re-dirties the partition, and
            # plain DIRTY would silently drop a one-shot request()
            was_requested = {
                nid
                for nid in partition
                if lg.node_state(nid) in (NodeState.REQUESTED, NodeState.PRIORITISED)
            }
            for node_id in partition:
                lg._set_state_raw(node_id, NodeState.PROCESSING)

            snapshot = lg.node_graph.clone()
            partition_set = set(partition)
            # clean-boundary slot datas feeding the partition
            boundary: dict = {}
            for edge in snapshot.edges:
                if edge.input_id in partition_set and edge.output_id not in partition_set:
                    key = (edge.output_id, edge.output_slot)
                    if key in boundary:
                        continue
                    try:
                        boundary[key] = lg.slot_data(*key)
                    except TexProError:
                        # raced an eviction: re-dirty the parent (without
                        # propagation) and retry next tick, restoring request
                        # status so one-shot request() clients are served
                        lg.redirty_for_recompute(edge.output_id)
                        for node_id in partition:
                            lg._set_state_raw(
                                node_id,
                                NodeState.REQUESTED
                                if node_id in was_requested
                                else NodeState.DIRTY,
                            )
                        return
            embedded = lg.embedded_slot_datas()
            input_datas = lg.input_slot_datas()

        # prune the snapshot to partition + preset boundary so unrelated
        # clean subgraphs are not evaluated
        from .node_graph import NodeGraph

        keep = partition_set | {nid for nid, _ in boundary}
        pruned = NodeGraph()
        pruned.nodes = [n for n in snapshot.nodes if n.node_id in keep]
        pruned.edges = [
            e for e in snapshot.edges if e.output_id in keep and e.input_id in keep
        ]
        snapshot = pruned

        # topo order for commit
        order = {nid: i for i, nid in enumerate(self._topo_order(snapshot))}
        partition.sort(key=lambda nid: order.get(nid, 0))

        events = {}
        for node_id in partition:
            try:
                kind = snapshot.node(node_id).node_type.kind.value
            except TexProError:
                kind = "?"
            events[node_id] = self.tex_pro.timeline.begin(
                node_id, kind, fused=len(partition)
            )

        self._pool.submit(
            self._worker_fused,
            snapshot, partition, boundary, embedded, input_datas, live_graph,
            events, recipes,
        )

    @staticmethod
    def _topo_order(graph) -> list:
        from .compiler import _topo_order

        return _topo_order(graph)

    def _worker_fused(
        self, snapshot, partition, boundary, embedded, input_datas, live_graph,
        events=None, recipes=None,
    ) -> None:
        from .compiler import CompiledGraph, collect_value_bindings, graph_fingerprint
        from .slot_data import SlotData
        from .slot_image import SlotImage
        from .transient_buffer import plane_from_device

        from .parallel.sharded import ShardedPlane

        preset = {
            key: len(slot_data.image.planes) for key, slot_data in boundary.items()
        }
        mesh = self.tex_pro.mesh
        try:
            fingerprint = graph_fingerprint(
                snapshot,
                extra=repr(sorted((int(n), int(s), c) for (n, s), c in preset.items()))
                + ("" if mesh is None else repr(mesh.shape)),
            )
            with self._fused_programs_lock:
                prog = self._fused_programs.get(fingerprint)
                if prog is not None:
                    self._fused_programs.move_to_end(fingerprint)
            if prog is None:
                prog = CompiledGraph(snapshot, self.tex_pro.device, preset=preset, mesh=mesh)
                with self._fused_programs_lock:
                    self._fused_programs[fingerprint] = prog
                    while len(self._fused_programs) > self.FUSED_PROGRAM_CACHE_CAP:
                        self._fused_programs.popitem(last=False)

            # re-bind Value constants from the live snapshot: the evaluator
            # is cached across value edits (the fingerprint normalizes them)
            overrides = collect_value_bindings(snapshot)
            device = self.tex_pro.device

            def planes(image):
                # leaves bound from host memory (numpy planes) move to the
                # processor's device; device-resident and sharded planes
                # pass as they are
                return tuple(
                    d if isinstance(d, ShardedPlane) else d.to(device)
                    for d in (buf.data() for buf in image.planes)
                )

            for (nid, slot), slot_data in boundary.items():
                overrides[f"preset_{int(nid)}_{int(slot)}"] = planes(slot_data.image)
            for esd in embedded:
                overrides[f"embed_{int(esd.slot_data_id)}"] = planes(esd.image)
            if input_datas:
                overrides["input_rgba_first"] = planes(input_datas[0].image)
                for slot_data in input_datas:
                    overrides[f"input_{int(slot_data.node_id)}"] = planes(slot_data.image)

            if mesh is not None:
                overrides = _shard_overrides(overrides, mesh)
            unique_planes, layout = prog.call_with_layout(**overrides)
            # wrap each unique plane once; aliased outputs share the
            # PlaneBuffer (reference: Arc-shared channel planes), so a plane
            # shared by two outputs counts once against memory_threshold
            wrapped = [plane_from_device(p) for p in unique_planes]

            results: dict = {}
            partition_set = set(partition)
            for (node_id, slot_id), idxs in layout.items():
                if node_id not in partition_set:
                    continue
                image = SlotImage([wrapped[i] for i in idxs])
                results.setdefault(node_id, []).append(SlotData(node_id, slot_id, image))

            node_results = [
                (node_id, sorted(results.get(node_id, []), key=lambda sd: sd.slot_id))
                for node_id in partition
            ]
            message = _FusedMessage(node_results, None, live_graph, events, recipes)
        except Exception as e:  # noqa: BLE001 — the commit decides fatality
            message = _FusedMessage([(nid, []) for nid in partition], e, live_graph, events)
        self._results.put(message)
        self.wake()

    # --- per-node dispatch (`engine.rs:200-307`): not yet ported ---
    def _dispatch(self, pack: ProcessPack) -> None:
        live_graph = pack.live_graph
        with live_graph.write() as lg:
            try:
                lg.node_state(pack.node_id)
            except TexProError:
                return
            lg._set_state_raw(pack.node_id, NodeState.PROCESSING)
        error = TexProError(
            ErrorKind.NODE_PROCESSING,
            "the per-node route (auto_update, fuse_subgraphs=False, Write "
            "sinks) is not yet ported",
        )
        self._results.put(_ThreadMessage(pack.node_id, error, live_graph))
        self.wake()
