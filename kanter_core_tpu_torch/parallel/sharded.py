"""Row-sharded planes over a device mesh.

Port of the row side of `kanter_core_tpu/parallel/sharded.py`. The JAX
package places a plane with `NamedSharding(mesh, P("rows", None))` and lets
GSPMD partition the program; here the sharding is explicit data:

- a `Mesh` is an ordered tuple of `torch.device`s along the one axis
  `"rows"`. One device may appear more than once (the shards then share a card, or the
  CPU), so every sharding step, halo exchange and block kernel runs on one
  card as it would on several;
- a `ShardedPlane` is an `[H, W]` plane held as `n` contiguous row bands of
  `H // n` rows, band `j` on `mesh.devices[j]`;
- `ShardedPlane.ring_halos(r)` is the ring `ppermute` of the JAX package's
  sharded kernels: shard `j` receives the last `r` rows of shard `j−1` and
  the first `r` rows of shard `j+1`, wrapping toroidally. Each is a copy to
  the receiving shard's device (a peer copy between two cards, no copy at
  all when both shards share one), outside any kernel;
  `ring_halo_addresses(r)` is the same exchange for a kernel that reads a
  halo in place, by its device address.

The process is single-controller, as in the JAX package: one
`TextureProcessor` and one `LiveGraph` drive every shard. There are no
`torch.distributed` ranks.

`MESH_COUNTERS` counts the exchanges and every gather of a sharded plane
into one tensor, by cause, so that no route gathers silently. The counts
are process-wide, like the kernels' launch counters: they sum over every
processor and every direct call in the process.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from ..errors import ErrorKind, TexProError

ROW_AXIS = "rows"


class MeshCounters:
    """Ring exchanges (`ring_halos` calls) and gathers by cause: `distance`
    (Distance runs on one device), `transform` (a Transform node's source
    rows are unbounded: one gather per plane), `blur_gate`
    and `warp_gate` (a geometry the block kernels cannot serve), `resize`
    (a sharded plane resized to another size), `export` (the u8 export of a
    sharded image) and `host` (a plane read back or evicted to host
    memory)."""

    CAUSES = ("distance", "transform", "blur_gate", "warp_gate", "resize", "export", "host")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.exchanges = 0
            self.gathers = dict.fromkeys(self.CAUSES, 0)

    def count_exchange(self) -> None:
        with self._lock:
            self.exchanges += 1

    def count_gather(self, cause: str) -> None:
        if cause not in self.CAUSES:
            raise TexProError(ErrorKind.GENERIC, f"unknown gather cause {cause!r}")
        with self._lock:
            self.gathers[cause] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "exchanges": self.exchanges,
                "gathers": dict(self.gathers),
            }


MESH_COUNTERS = MeshCounters()


def _resolve(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise TexProError(
                ErrorKind.GENERIC,
                f"mesh device {device} requested but torch.cuda.is_available() is False",
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise TexProError(ErrorKind.GENERIC, f"unsupported mesh device {device}")
    return device


class Mesh:
    """A 1-D device mesh along `axis_name` (`"rows"`): an ordered tuple of
    devices of one type. A device may appear more than once."""

    __slots__ = ("devices", "ring_local")
    axis_name = ROW_AXIS

    def __init__(self, devices):
        devices = tuple(_resolve(d) for d in devices)
        if not devices:
            raise TexProError(ErrorKind.GENERIC, "a mesh needs at least one device")
        types = {d.type for d in devices}
        if len(types) != 1:
            raise TexProError(
                ErrorKind.GENERIC, f"a mesh mixes device types: {sorted(types)}"
            )
        self.devices = devices
        # per shard: do its ring neighbours (before, after) share its device?
        self.ring_local = tuple((devices[j - 1] == d, devices[(j + 1) % len(devices)] == d)
                                for j, d in enumerate(devices))

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.n}

    def shardable(self, height: int) -> bool:
        """The placement rule of the JAX package's `_shard_overrides`: a
        plane is row-sharded when its rows are at least `n` and divide
        evenly over `n` shards."""
        return height >= self.n and height % self.n == 0

    def __eq__(self, other):
        if not isinstance(other, Mesh):
            return NotImplemented
        return self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D `"rows"` mesh. `devices` is an explicit list and may repeat a
    device; otherwise the first `n_devices` CUDA devices (all of them when
    `n_devices` is None). Raises when fewer CUDA devices are visible: this
    never puts two shards on one card unless `devices` says so."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and n_devices != len(devices):
            raise TexProError(
                ErrorKind.GENERIC,
                f"make_mesh: n_devices={n_devices} but {len(devices)} devices given",
            )
        return Mesh(devices)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise TexProError(
            ErrorKind.GENERIC,
            f"make_mesh({n_devices}) needs {max(n, 1)} CUDA devices; {visible} visible",
        )
    return Mesh([torch.device("cuda", i) for i in range(n)])


class ShardedPlane:
    """An `[H, W]` plane as `mesh.n` contiguous row bands of `H // n` rows,
    band `j` on `mesh.devices[j]`. Immutable, like every plane of the
    engine."""

    __slots__ = ("mesh", "bands", "shape")

    def __init__(self, mesh: Mesh, bands):
        bands = tuple(bands)
        if len(bands) != mesh.n:
            raise TexProError(
                ErrorKind.GENERIC, f"{len(bands)} bands for a mesh of {mesh.n}"
            )
        first = bands[0]
        for band, device in zip(bands, mesh.devices):
            if (
                band.dim() != 2 or band.shape != first.shape
                or band.dtype != first.dtype or band.device != device
            ):
                raise TexProError(
                    ErrorKind.GENERIC,
                    f"band {tuple(band.shape)} {band.dtype} on {band.device} does not "
                    f"match {tuple(first.shape)} {first.dtype} on {device}",
                )
        self.mesh = mesh
        self.bands = bands
        self.shape = (first.shape[0] * mesh.n, first.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.bands[0].dtype

    @property
    def band_rows(self) -> int:
        return self.bands[0].shape[0]

    @property
    def nbytes(self) -> int:
        return self.shape[0] * self.shape[1] * self.bands[0].element_size()

    def gather(self, device, cause: str) -> torch.Tensor:
        """The whole plane as one tensor on `device`, counted under `cause`
        (`MeshCounters.CAUSES`)."""
        MESH_COUNTERS.count_gather(cause)
        out = torch.empty(self.shape, dtype=self.dtype, device=torch.device(device))
        bh = self.band_rows
        for j, band in enumerate(self.bands):
            out[j * bh:(j + 1) * bh].copy_(band)  # each band copied once, into place
        return out

    def ring_halos(self, r: int) -> list:
        """`[(top, bot)]` per shard: `top` the `r` rows before shard `j`
        (the last rows of shard `j−1`), `bot` the `r` rows after it (the
        first rows of shard `j+1`), wrapping toroidally, each on shard
        `j`'s device. One ring hop: needs `1 ≤ r ≤ H // n`."""
        n, bh = self.mesh.n, self.band_rows
        if not 1 <= r <= bh:
            raise TexProError(
                ErrorKind.GENERIC, f"a ring halo of {r} rows needs blocks of >= {r} rows, got {bh}"
            )
        halos = []
        for j, device in enumerate(self.mesh.devices):
            top = self.bands[(j - 1) % n][bh - r:].to(device)
            bot = self.bands[(j + 1) % n][:r].to(device)
            halos.append((top, bot))
        MESH_COUNTERS.count_exchange()
        return halos

    def ring_halo_addresses(self, r: int) -> tuple:
        """`ring_halos` for a kernel that takes device addresses: `(tops,
        bots, copies)`, where `tops[j]` is the address of the first of the
        `r` rows before shard `j` and `bots[j]` that of the first of the `r`
        rows after it. A halo on shard `j`'s own device is addressed where
        it lies, in its neighbour's band: no view is made (each costs
        microseconds of host time, and four planes over four shards need
        32). One on another device is copied there as `ring_halos` copies
        it; `copies` holds those copies, for the caller to keep until its
        kernels are enqueued. Needs contiguous bands; counted as one
        exchange."""
        n, bh = self.mesh.n, self.band_rows
        if not 1 <= r <= bh:
            raise TexProError(
                ErrorKind.GENERIC, f"a ring halo of {r} rows needs blocks of >= {r} rows, got {bh}"
            )
        bands = self.bands
        starts = [b.data_ptr() for b in bands]
        skip = (bh - r) * bands[0].stride(0) * bands[0].element_size()
        tops, bots, copies = [], [], []
        for j, (prev_local, next_local) in enumerate(self.mesh.ring_local):
            if prev_local:
                tops.append(starts[j - 1] + skip)
            else:
                copies.append(bands[j - 1][bh - r:].to(self.mesh.devices[j]))
                tops.append(copies[-1].data_ptr())
            if next_local:
                bots.append(starts[(j + 1) % n])
            else:
                copies.append(bands[(j + 1) % n][:r].to(self.mesh.devices[j]))
                bots.append(copies[-1].data_ptr())
        MESH_COUNTERS.count_exchange()
        return tops, bots, copies

    def __repr__(self) -> str:
        return f"ShardedPlane({self.shape}, {self.dtype}, {self.mesh})"


def shard_planes_rows(mesh: Mesh, plane: torch.Tensor) -> ShardedPlane:
    """Place one `[H, W]` plane row-sharded over the mesh. A band on the
    plane's own device is a view of it; elsewhere it is a copy."""
    h, w = plane.shape
    if not mesh.shardable(h):
        raise TexProError(
            ErrorKind.GENERIC, f"{h} rows do not shard over {mesh.n} devices"
        )
    bh = h // mesh.n
    return ShardedPlane(
        mesh,
        [plane[j * bh:(j + 1) * bh].to(device).contiguous()
         for j, device in enumerate(mesh.devices)],
    )


def place(mesh: Mesh, plane):
    """The placement rule of `_shard_overrides` for one plane: a 2-D plane
    whose rows shard over the mesh becomes a `ShardedPlane`; anything else
    is a tensor on the mesh's first device. A `ShardedPlane` passes as is."""
    if isinstance(plane, ShardedPlane):
        return plane
    plane = plane.to(mesh.devices[0])
    if plane.dim() == 2 and mesh.shardable(plane.shape[0]):
        return shard_planes_rows(mesh, plane)
    return plane


def map_bands(fn, *operands):
    """`fn` applied shard by shard. Operands are `ShardedPlane`s of one mesh
    and shape, 1×1 tensors (copied once to each shard's device) or other
    values (passed as they are); any other tensor raises, a plane of the
    full shape too (the placement rule shards every such plane, so a dense
    one here is a placement fault, not something to copy quietly). Returns a `ShardedPlane`, or a tuple of them when `fn` returns a
    tuple or list. With no sharded operand it is `fn(*operands)`."""
    sharded = next((o for o in operands if isinstance(o, ShardedPlane)), None)
    if sharded is None:
        return fn(*operands)
    mesh, shape = sharded.mesh, sharded.shape
    per_band = []
    for o in operands:
        if isinstance(o, ShardedPlane):
            if o.mesh != mesh or o.shape != shape:
                raise TexProError(
                    ErrorKind.GENERIC, f"cannot combine {o} with {sharded} band by band"
                )
            per_band.append(o.bands)
        elif isinstance(o, torch.Tensor) and o.dim() == 2 and tuple(o.shape) == (1, 1):
            copies = {d: o.to(d) for d in set(mesh.devices)}
            per_band.append(tuple(copies[d] for d in mesh.devices))
        elif isinstance(o, torch.Tensor):
            raise TexProError(
                ErrorKind.GENERIC,
                f"a {tuple(o.shape)} tensor cannot meet a sharded {shape} plane",
            )
        else:
            per_band.append((o,) * mesh.n)
    results = [fn(*args) for args in zip(*per_band)]
    if isinstance(results[0], (tuple, list)):
        return tuple(ShardedPlane(mesh, bands) for bands in zip(*results))
    return ShardedPlane(mesh, results)
