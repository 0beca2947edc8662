"""Tiered channel-plane buffers (device → host DRAM → disk).

Port of `kanter_core_tpu/transient_buffer.py` (itself a rework of
`vismut_core/src/transient_buffer.rs`). A plane is an f32 `[H, W]` array in
one of three tiers:

- ``DEVICE``: a `torch.Tensor` on the processor's device (the compute tier:
  CUDA memory on a GPU, or CPU memory when the processor runs on the CPU);
- ``HOST``: a NumPy array in host DRAM (first spill tier);
- ``STORAGE``: a salted-hash-verified file on disk (second spill tier,
  preserving the reference's crash-detecting reload semantics).

``in_memory`` maps to "device-resident". A manager thread
(`PlaneBufferQueue.thread_loop`) enforces the device watermark by evicting
least-recently-touched planes device→host, and an optional host watermark by
spilling host→disk. Every plane remembers its home device, so a fault-in
returns it to the device it was evicted from.

A row-sharded plane (`parallel.sharded.ShardedPlane`, under
`TextureProcessor(mesh=...)`) is one DEVICE-tier plane: it counts its total
bytes, is evicted to the host as one array (a `host` gather), and a fault-in
shards it over its mesh again.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from enum import Enum
from typing import Optional

import numpy as np
import torch

from .errors import ErrorKind, TexProError
from .geometry import Size
from .parallel.sharded import Mesh, ShardedPlane, shard_planes_rows

# per-process spill directory: files are deleted on reload/drop, but a
# crashed process can't clean up after itself — stale sibling directories
# whose owning pid is gone are swept on startup (`_sweep_stale_spill_dirs`)
_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "kanter_torch_cache")
_CACHE_DIR = os.path.join(_CACHE_ROOT, str(os.getpid()))


def _sweep_stale_spill_dirs() -> None:
    try:
        entries = os.listdir(_CACHE_ROOT)
    except OSError:
        return
    for name in entries:
        if not name.isdigit() or name == str(os.getpid()):
            continue
        try:
            os.kill(int(name), 0)
            continue  # owner still alive
        except ProcessLookupError:
            pass
        except OSError:
            continue
        stale = os.path.join(_CACHE_ROOT, name)
        try:
            for f in os.listdir(stale):
                try:
                    os.remove(os.path.join(stale, f))
                except OSError:
                    pass
            os.rmdir(stale)
        except OSError:
            pass


class Tier(Enum):
    DEVICE = "device"
    HOST = "host"
    STORAGE = "storage"


class AtomicUsize:
    """Shared mutable counter (reference: `Arc<AtomicUsize>`)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = int(value)
        self._lock = threading.Lock()

    def store(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    def load(self) -> int:
        return self._value


def _hash_plane(salt: int, data: bytes) -> str:
    """Salted content hash for spill-file names (verified on reload;
    reference `transient_buffer.rs:98-133`)."""
    from . import native

    return native.salted_hash64(data, salt)


class PlaneBuffer:
    """One f32 channel plane in one of three memory tiers.

    Analog of `TransientBufferContainer` + `TransientBuffer`
    (`transient_buffer.rs:28-247`). The size is cached so size queries never
    fault data in (`transient_buffer.rs:188-201`). `home` is the device the
    DEVICE tier lives on, or the `Mesh` a sharded plane is sharded over.
    """

    __slots__ = ("_lock", "_tier", "_device", "_host", "_path", "_salt", "_height",
                 "_width", "_queue", "_home", "__weakref__")

    _dtype = np.dtype(np.float32)

    def __init__(self, *, device=None, host=None, home=None):
        self._lock = threading.RLock()
        self._queue = None  # PlaneBufferQueue that manages this buffer, if any
        if device is not None:
            if device.dtype != torch.float32 or len(device.shape) != 2:
                raise TexProError(
                    ErrorKind.GENERIC, "a plane is a 2-D float32 tensor"
                )
            self._tier = Tier.DEVICE
            self._device = device
            self._host = None
            self._home = device.mesh if isinstance(device, ShardedPlane) else device.device
            self._height, self._width = device.shape
        else:
            host = np.ascontiguousarray(host, dtype=np.float32)
            self._tier = Tier.HOST
            self._device = None
            self._host = host
            self._home = torch.device(home if home is not None else "cpu")
            self._height, self._width = host.shape
        self._path = None
        self._salt = None

    # --- introspection ---
    @property
    def size(self) -> Size:
        return Size(self._width, self._height)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._height, self._width)

    def bytes(self) -> int:
        return self._height * self._width * self._dtype.itemsize

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def in_memory(self) -> bool:
        """True when device-resident (reference: RAM-vs-disk)."""
        return self._tier == Tier.DEVICE

    @property
    def tier(self) -> Tier:
        return self._tier

    # --- access ---
    def data(self):
        """The plane as a tensor on its home device (a `ShardedPlane` over
        its home mesh), faulting it in if
        spilled. Faulting holds only the PLANE lock; the LRU move happens
        after, under the queue lock alone (lock order is queue → plane
        everywhere, so taking the queue lock while holding the plane lock
        would deadlock against the evictor). The evictor may pick a
        just-faulted plane as victim in the gap — wasted work, not a
        correctness issue: the returned tensor stays valid for the caller."""
        queue = self._queue
        with self._lock:
            if self._tier != Tier.DEVICE:
                self._fault_in_locked()
            device = self._device
        if queue is not None:
            with queue._lock:
                queue._move_to_back_locked(self)
        return device

    def try_data(self) -> torch.Tensor:
        """Non-blocking accessor: the tensor if already resident, else
        raises (reference `try_transient_buffer`,
        `transient_buffer.rs:219-228`)."""
        queue = self._queue
        with self._lock:
            device = self._device if self._tier == Tier.DEVICE else None
        if device is not None:
            if queue is not None:
                with queue._lock:
                    queue._move_to_back_locked(self)
            return device
        raise TexProError(ErrorKind.GENERIC, "plane not device-resident")

    def host_data(self) -> np.ndarray:
        """The plane as a host ndarray without promoting it to the device."""
        with self._lock:
            if self._tier == Tier.DEVICE:
                return _to_host(self._device)
            if self._tier == Tier.STORAGE:
                self._load_from_storage_locked()
                self._tier = Tier.HOST
            return self._host

    def _fault_in_locked(self) -> None:
        if self._tier == Tier.STORAGE:
            self._load_from_storage_locked()
        plane = torch.from_numpy(self._host)
        if isinstance(self._home, Mesh):
            self._device = shard_planes_rows(self._home, plane.to(self._home.devices[0]))
        else:
            self._device = plane.to(self._home)
        self._host = None
        self._tier = Tier.DEVICE

    # --- tier transitions (manager thread) ---
    def begin_evict(self) -> bool:
        """True if this plane is a device-resident eviction candidate (the
        JAX package starts an async copy here; the copy below is already
        one blocking transfer per plane)."""
        with self._lock:
            return self._tier == Tier.DEVICE

    def evict_to_host(self) -> bool:
        """DEVICE → HOST. Returns True if a move happened.

        All device work of the processor runs on the device's current
        (default) stream, shared by every thread. `.cpu()` enqueues the copy
        on that stream and blocks until it — and every launch enqueued
        before it, including any still reading this plane — has finished.
        Dropping the device reference afterwards therefore cannot hand
        memory that an in-flight launch reads back to the allocator; the
        caching allocator only reuses a freed block for work ordered after
        it on the same stream anyway."""
        with self._lock:
            if self._tier != Tier.DEVICE:
                return False
            self._host = _to_host(self._device)
            self._device = None
            self._tier = Tier.HOST
            return True

    def spill_to_storage(self, host_only: bool = False) -> bool:
        """HOST → STORAGE with a salted content hash as the file name; the
        hash is verified on reload and the file deleted, erroring on
        mismatch (`transient_buffer.rs:98-183`). `host_only=True` refuses
        DEVICE-tier planes atomically under the plane lock (a plane that
        faulted hot since the manager selected it must not go to disk)."""
        with self._lock:
            if self._tier == Tier.DEVICE:
                if host_only:
                    return False
                self.evict_to_host()
            if self._tier != Tier.HOST:
                return False
            salt = random.getrandbits(64)
            raw = self._host.tobytes()
            digest = _hash_plane(salt, raw)
            os.makedirs(_CACHE_DIR, exist_ok=True)
            path = os.path.join(_CACHE_DIR, digest)
            with open(path, "wb") as f:
                f.write(raw)
            self._path = path
            self._salt = salt
            self._host = None
            self._tier = Tier.STORAGE
            return True

    def _load_from_storage_locked(self) -> None:
        path = self._path
        with open(path, "rb") as f:
            raw = f.read()
        digest = _hash_plane(self._salt, raw)
        try:
            os.remove(path)
        except OSError:
            pass
        if digest != os.path.basename(path):
            raise TexProError(ErrorKind.GENERIC, "spill file hash mismatch")
        self._host = (
            np.frombuffer(raw, dtype=self._dtype)
            .reshape(self._height, self._width)
            .copy()
        )
        self._path = None
        self._salt = None

    def __del__(self):
        if getattr(self, "_path", None):
            try:
                os.remove(self._path)
            except OSError:
                pass


def _to_host(plane) -> np.ndarray:
    """A device-tier plane as a host array (a sharded plane is gathered,
    counted as a `host` gather)."""
    if isinstance(plane, ShardedPlane):
        return plane.gather("cpu", "host").numpy()
    return plane.cpu().numpy()


def plane_from_host(array, home=None) -> PlaneBuffer:
    """A HOST-tier plane that faults in to `home` (default: the CPU)."""
    return PlaneBuffer(host=array, home=home)


def plane_from_device(tensor) -> PlaneBuffer:
    return PlaneBuffer(device=tensor)


def pixel_buffer(value: float) -> PlaneBuffer:
    """A 1×1 gray plane (`vismut_core/src/node/mod.rs:239-243`)."""
    return PlaneBuffer(host=np.full((1, 1), value, dtype=np.float32))


class PlaneBufferQueue:
    """LRU spill manager (analog of `TransientBufferQueue`,
    `transient_buffer.rs:250-434`).

    Holds every live plane once (deduplicated by identity), drops planes no
    one else references, moves touched planes to the back, and evicts from
    the front while the device-resident byte count exceeds
    `memory_threshold`.
    """

    TICK_SECONDS = 0.001
    IDLE_TICK_SECONDS = 0.02

    def __init__(self, memory_threshold: AtomicUsize, shutdown,
                 host_threshold: Optional[AtomicUsize] = None):
        _sweep_stale_spill_dirs()
        # id(buf) → buf, ordered front (coldest) → back (hottest)
        self._entries: "OrderedDict[int, PlaneBuffer]" = OrderedDict()
        self.memory_threshold = memory_threshold
        self.host_threshold = host_threshold
        self.shutdown = shutdown
        self._incoming: list[PlaneBuffer] = []
        # One reentrant lock guards queue order, membership, and eviction.
        # Lock order everywhere is queue lock → plane lock.
        self._lock = threading.RLock()

    # --- ingestion (`transient_buffer.rs:297-345`) ---
    def add_buffer(self, buffer: PlaneBuffer) -> None:
        with self._lock:
            self._incoming.append(buffer)

    def add_slot_data(self, slot_data) -> None:
        for buf in slot_data.image.bufs():
            self.add_buffer(buf)

    @property
    def queue(self) -> list:
        """Snapshot of managed planes, coldest first (introspection/tests)."""
        with self._lock:
            return list(self._entries.values())

    def _move_to_back_locked(self, buffer: PlaneBuffer) -> None:
        if id(buffer) in self._entries:
            self._entries.move_to_end(id(buffer))

    def _handle_incoming_locked(self) -> None:
        incoming, self._incoming = self._incoming, []
        for buf in incoming:
            if id(buf) in self._entries:
                continue
            buf._queue = self
            self._entries[id(buf)] = buf
            if not buf.in_memory():
                self._entries.move_to_end(id(buf), last=False)  # coldest end

    # --- accounting ---
    def _tier_bytes(self, tier: Tier) -> int:
        with self._lock:
            return sum(b.bytes() for b in self._entries.values() if b.tier == tier)

    def bytes_memory(self) -> int:
        return self._tier_bytes(Tier.DEVICE)

    def bytes_host(self) -> int:
        return self._tier_bytes(Tier.HOST)

    def bytes_storage(self) -> int:
        return self._tier_bytes(Tier.STORAGE)

    def _sweep_orphans_locked(self) -> None:
        # A plane referenced only by this queue belongs to no SlotData
        # anymore (reference: `Arc::strong_count == 1`,
        # `transient_buffer.rs:364`). CPython refcount via direct dict
        # access: dict value + getrefcount argument = 2.
        dead = [
            key
            for key in list(self._entries)
            if sys.getrefcount(self._entries[key]) <= 2
        ]
        for key in dead:
            del self._entries[key]

    def tick(self) -> bool:
        """One manager pass; True if it did any work (the thread loop backs
        off while idle). The queue lock covers only bookkeeping and victim
        selection; the blocking transfers and disk writes run outside it,
        each under its plane's own lock."""
        worked = False
        evict_victims: list = []
        spill_victims: list = []
        with self._lock:
            before = len(self._entries)
            worked |= bool(self._incoming)
            self._handle_incoming_locked()
            self._sweep_orphans_locked()
            worked |= len(self._entries) != before

            threshold = self.memory_threshold.load()
            in_memory = sum(
                b.bytes() for b in self._entries.values() if b.tier == Tier.DEVICE
            )
            if in_memory > threshold:
                pending = in_memory
                for buf in list(self._entries.values()):
                    if pending <= threshold or self.shutdown.load():
                        break
                    if buf.begin_evict():
                        evict_victims.append(buf)
                        pending -= buf.bytes()

            if self.host_threshold is not None:
                host_threshold = self.host_threshold.load()
                on_host = sum(
                    b.bytes() for b in self._entries.values() if b.tier == Tier.HOST
                )
                if on_host > host_threshold:
                    for buf in list(self._entries.values()):
                        if on_host <= host_threshold:
                            break
                        if buf.tier == Tier.HOST:
                            spill_victims.append(buf)
                            on_host -= buf.bytes()

        for buf in evict_victims:
            if self.shutdown.load():
                return worked
            if buf.evict_to_host():
                worked = True
        for buf in spill_victims:
            if self.shutdown.load():
                return worked
            if buf.spill_to_storage(host_only=True):
                worked = True
        return worked

    def dump(self) -> str:
        """Debug listing of every managed plane and its tier (reference:
        `Display for TransientBufferQueue`, `transient_buffer.rs:257-285`)."""
        with self._lock:
            entries = list(self._entries.values())
            lines = [
                f"Thres: {self.memory_threshold.load()}",
                f"Devic: {sum(b.bytes() for b in entries if b.tier == Tier.DEVICE)}",
                f"Host : {sum(b.bytes() for b in entries if b.tier == Tier.HOST)}",
                f"Stora: {sum(b.bytes() for b in entries if b.tier == Tier.STORAGE)}",
            ]
            tags = {Tier.DEVICE: "DEV", Tier.HOST: "HST", Tier.STORAGE: "STO"}
            for buf in entries:
                lines.append(f"{tags[buf.tier]} {buf.bytes():>10} {buf.size} 0x{id(buf):x}")
            return "\n".join(lines)

    def __str__(self) -> str:
        return self.dump()

    def thread_loop(self) -> None:
        while not self.shutdown.load():
            worked = self.tick()
            time.sleep(self.TICK_SECONDS if worked else self.IDLE_TICK_SECONDS)
