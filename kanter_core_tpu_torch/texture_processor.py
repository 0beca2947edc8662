"""Public facade: owns live graphs, the scheduler, and the memory manager.

Port of `kanter_core_tpu/texture_processor.py` (`vismut_core/src/
texture_processor.rs`): construction spawns the scheduler loop and the
buffer-queue manager as daemon threads (`texture_processor.rs:52-53`);
dropping the processor flips the shutdown flag (`:27-31`). It is also a
context manager for deterministic teardown.

The processor runs on one explicit `device`; every plane it computes lives
there, and everything below it takes the device from its inputs. With a
`mesh` (`parallel.make_mesh`), every plane whose rows shard over the mesh
is held row-sharded over its devices, and `device` is the mesh's first.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

import torch

from .engine import Engine
from .errors import ErrorKind, TexProError
from .ids import NodeId, SlotId
from .live_graph import LiveGraph
from .node import AtomicFlag
from .parallel.sharded import MESH_COUNTERS, Mesh
from .process_pack import ProcessPackManager
from .profiling import NodeTimeline
from .recipe_cache import RecipeCache
from .slot_data import Size, SlotData
from .transient_buffer import AtomicUsize, PlaneBufferQueue


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; a CUDA device must exist — there is no
    silent fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise TexProError(
                ErrorKind.GENERIC,
                f"device {device} requested but torch.cuda.is_available() is False",
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise TexProError(ErrorKind.GENERIC, f"unsupported device {device}")
    return device


class TextureProcessor:
    def __init__(
        self,
        memory_threshold=10_000_000,
        host_memory_threshold: Optional[int] = None,
        device="cuda",
        mesh=None,
        tile_bytes: Optional[int] = None,
        bucket_sizes: bool = False,
        precision=None,
    ):
        """`memory_threshold`: device-resident bytes above which the memory
        manager evicts least-recently-used planes to the host.
        `host_memory_threshold`: optional host bytes above which host planes
        spill to disk. `device`: "cuda" (default; raises without a card) or
        "cpu", where every kernel takes its plain torch version.

        `mesh`: an optional `parallel.Mesh` (`parallel.make_mesh`) whose
        devices are of `device`'s type. Every fused dispatch then holds each
        plane whose rows shard over the mesh row-sharded across its devices,
        with ring halo exchanges for the stencils and the Blur and Warp
        block kernels, bit-identically to one device (the JAX package's
        `TextureProcessor(mesh=...)`). `tp.metrics()["mesh"]` counts the
        exchanges and, by cause, every gather of a sharded plane.

        `tile_bytes`, `bucket_sizes` and `precision` select the JAX
        package's tiled, bucketed and bf16 routes, which are not yet
        ported: anything but their defaults raises."""
        unported = {
            "tile_bytes": tile_bytes is not None,
            "bucket_sizes": bool(bucket_sizes),
            "precision": precision not in (None, "float32"),
        }
        for name, requested in unported.items():
            if requested:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING, f"TextureProcessor({name}=...) is not yet ported"
                )
        self.device = resolve_device(device)
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TexProError(
                    ErrorKind.GENERIC,
                    f"mesh must be a kanter_core_tpu_torch.parallel.Mesh, got {type(mesh).__name__}",
                )
            if mesh.device_type != self.device.type:
                raise TexProError(
                    ErrorKind.GENERIC,
                    f"a {mesh.device_type} mesh for a {self.device.type} processor",
                )
            self.device = mesh.devices[0]
        self.mesh = mesh
        if not isinstance(memory_threshold, AtomicUsize):
            memory_threshold = AtomicUsize(memory_threshold)
        self.memory_threshold = memory_threshold
        self.host_memory_threshold = (
            AtomicUsize(host_memory_threshold) if host_memory_threshold is not None else None
        )
        self.shutdown = AtomicFlag(False)
        self.buffer_queue = PlaneBufferQueue(
            self.memory_threshold, self.shutdown, self.host_memory_threshold
        )
        self._live_graphs: list[LiveGraph] = []
        self._live_graphs_lock = threading.Lock()
        self._process_pack_manager = ProcessPackManager()
        self._ppm_lock = threading.Lock()
        self.timeline = NodeTimeline()
        self.recipe_cache = RecipeCache()
        self.engine = Engine(self)

        self._engine_thread = threading.Thread(
            target=self.engine.run, daemon=True, name="kanter-engine"
        )
        self._buffer_thread = threading.Thread(
            target=self.buffer_queue.thread_loop, daemon=True, name="kanter-memory"
        )
        self._engine_thread.start()
        self._buffer_thread.start()

    # --- lifecycle ---
    def shutdown_now(self) -> None:
        self.shutdown.store(True)
        self.engine.wake()
        for live_graph in self.live_graphs_snapshot():
            live_graph._notify_state_change()  # wake any blocked awaits
        # join the daemons (bounded) so no thread is mid device transfer at
        # interpreter exit
        for thread in (self._engine_thread, self._buffer_thread):
            if thread.is_alive():
                thread.join(timeout=60.0)

    def __enter__(self) -> "TextureProcessor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown_now()

    def __del__(self):
        try:
            self.shutdown.store(True)
        except AttributeError:
            pass  # construction failed before the flag existed

    # --- live graph management ---
    def new_live_graph(self) -> LiveGraph:
        live_graph = LiveGraph(self.buffer_queue)
        live_graph._wakers.append(self.engine.wake)
        live_graph._shutdown = self.shutdown
        with self._live_graphs_lock:
            self._live_graphs.append(live_graph)
        return live_graph

    def push_live_graph(self, live_graph: LiveGraph) -> None:
        if self.engine.wake not in live_graph._wakers:
            live_graph._wakers.append(self.engine.wake)
        live_graph._shutdown = self.shutdown
        with self._live_graphs_lock:
            self._live_graphs.append(live_graph)
        self.engine.wake()

    def remove_live_graph(self, live_graph: LiveGraph) -> None:
        with self._live_graphs_lock:
            self._live_graphs = [lg for lg in self._live_graphs if lg is not live_graph]

    def live_graphs_snapshot(self) -> list[LiveGraph]:
        with self._live_graphs_lock:
            return list(self._live_graphs)

    def has_live_graph(self, live_graph: LiveGraph) -> bool:
        with self._live_graphs_lock:
            return any(lg is live_graph for lg in self._live_graphs)

    def drop_unused_live_graphs(self) -> None:
        """Drop graphs no external code references (reference: Arc strong
        count of 1, `live_graph.rs:637-645`). CPython refcount heuristic:
        list entry + comprehension variable + getrefcount argument = 3."""
        with self._live_graphs_lock:
            self._live_graphs = [lg for lg in self._live_graphs if sys.getrefcount(lg) > 3]

    # --- admission control ---
    def update_process_packs(self, packs):
        with self._ppm_lock:
            try:
                return self._process_pack_manager.update(packs)
            except TexProError:
                self.shutdown.store(True)
                return None

    def processing_node_count(self) -> int:
        with self._ppm_lock:
            return len(self._process_pack_manager.process_packs)

    def set_max_processing_nodes(self, count: int) -> None:
        with self._ppm_lock:
            self._process_pack_manager.max_count = int(count)

    def metrics(self) -> dict:
        """Observability snapshot: buffer-tier bytes, in-flight dispatches,
        per-node-kind timing summary, evaluator cache size and, with a mesh,
        its devices and `parallel.MESH_COUNTERS` (ring exchanges, gathers by
        cause). Those counts are process-wide: they include every other
        processor's and every direct sharded call's in this process; reset
        them (`MESH_COUNTERS.reset()`) before the work to be counted."""
        mesh = None
        if self.mesh is not None:
            mesh = {"devices": [str(d) for d in self.mesh.devices], **MESH_COUNTERS.snapshot()}
        return {
            "device": str(self.device),
            "mesh": mesh,
            "bytes_device": self.buffer_queue.bytes_memory(),
            "bytes_host": self.buffer_queue.bytes_host(),
            "bytes_storage": self.buffer_queue.bytes_storage(),
            "processing_node_count": self.processing_node_count(),
            "fused_programs": len(self.engine._fused_programs),
            "recipe_cache": self.recipe_cache.stats(),
            "timeline": self.timeline.summary(),
        }

    # --- blocking getters (`texture_processor.rs:75-105`) ---
    @staticmethod
    def buffer_rgba(live_graph: LiveGraph, node_id: NodeId, slot_id: SlotId):
        with LiveGraph.await_clean_write(live_graph, node_id) as lg:
            slot_data = lg.slot_data(node_id, slot_id)
        # the u8 export runs device work + a readback OUTSIDE the graph lock
        # so the engine loop and editors aren't frozen meanwhile; the
        # SlotData snapshot holds its plane refs
        return slot_data.image.to_u8()

    @staticmethod
    def node_slot_datas(live_graph: LiveGraph, node_id: NodeId) -> list[SlotData]:
        with LiveGraph.await_clean_write(live_graph, node_id) as lg:
            return lg.node_slot_datas(node_id)

    @staticmethod
    def await_slot_data_size(live_graph: LiveGraph, node_id: NodeId, slot_id: SlotId) -> Size:
        while True:
            # re-prioritise EVERY pass (like `_await_clean`'s spin,
            # `live_graph.rs:168-178`): a mid-flight edit can discard the
            # result and drop the node back to Dirty with no one requesting it
            with live_graph.write() as lg:
                if lg.fatal_error is not None:
                    raise lg.fatal_error
                if lg._shutdown is not None and lg._shutdown.load():
                    raise TexProError(
                        ErrorKind.NODE_PROCESSING,
                        "texture processor is shut down; slot data will never arrive",
                    )
                try:
                    return lg.slot_data_size(node_id, slot_id)
                except TexProError as e:
                    if e.kind != ErrorKind.NO_SLOT_DATA:
                        raise
                lg.prioritise(node_id)
            with live_graph._state_cv:
                live_graph._state_cv.wait(timeout=0.002)
