"""Row-sharded planes and batch-sharded canvases over a device mesh.

Port of `kanter_core_tpu/parallel/sharded.py`. The JAX package places a
plane with `NamedSharding(mesh, P("rows", None))` (or a batch with
`P("batch", None, None)`) and lets GSPMD partition the program; here the
sharding is explicit data:

- a `Mesh` is an ordered tuple of `torch.device`s along one axis, `"rows"`
  (`TextureProcessor(mesh=...)`) or `"batch"` (`BatchedGraph`,
  `BatchedLiveSession`). One device may appear more than once (the shards then share a card, or the
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

On a `"batch"` mesh a `[B, ...]` batch is held as a `BatchShards`: `n`
contiguous shares of `B // n` canvases, share `j` on `mesh.devices[j]`
(`shard_planes_batch`). `BatchedGraph` evaluates each share on its device
with the kernels, no exchange between them, and its outputs stay there until
the caller gathers them (`BatchShards.gather`, counted under `batch`). A
mesh with both axes (the JAX package's vmap of the row-sharded kernels) is
not yet ported.

The process is single-controller, as in the JAX package: one
`TextureProcessor` and one `LiveGraph` drive every shard. There are no
`torch.distributed` ranks.

`MESH_COUNTERS` counts the exchanges and every gather of a sharded plane
into one tensor, by cause, so that no route gathers silently. The counts
are process-wide, like the kernels' launch counters: they sum over every
processor and every direct call in the process.
"""

from __future__ import annotations

import copy
import re
import threading
from typing import Optional

import numpy as np
import torch

from ..errors import ErrorKind, TexProError

ROW_AXIS = "rows"
BATCH_AXIS = "batch"


class MeshCounters:
    """Ring exchanges (`ring_halos` calls) and gathers by cause: `distance`
    (Distance runs on one device), `transform` (a Transform node's source
    rows are unbounded: one gather per plane), `blur_gate`
    and `warp_gate` (a geometry the block kernels cannot serve), `resize`
    (a sharded plane resized to another size), `export` (the u8 export of a
    sharded image), `host` (a plane read back or evicted to host memory)
    and `batch` (a batch-sharded output gathered into one tensor)."""

    CAUSES = ("distance", "transform", "blur_gate", "warp_gate", "resize", "export", "host",
              "batch")

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
    """A 1-D device mesh along `axis_name` (`"rows"` or `"batch"`): an
    ordered tuple of devices of one type. A device may appear more than
    once."""

    __slots__ = ("devices", "ring_local", "axis_name")

    def __init__(self, devices, axis_name: str = ROW_AXIS):
        if axis_name not in (ROW_AXIS, BATCH_AXIS):
            raise TexProError(ErrorKind.GENERIC, f"unknown mesh axis {axis_name!r}")
        self.axis_name = axis_name
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
        return self.devices == other.devices and self.axis_name == other.axis_name

    def __hash__(self):
        return hash((self.devices, self.axis_name))

    def __repr__(self) -> str:
        axis = "" if self.axis_name == ROW_AXIS else f", {self.axis_name!r}"
        return f"Mesh({[str(d) for d in self.devices]}{axis})"


def make_mesh(n_devices: Optional[int] = None, devices=None, axes=(ROW_AXIS,)) -> Mesh:
    """A 1-D mesh along `axes`, one of `("rows",)` (the default, the row
    sharding of `TextureProcessor(mesh=...)`) and `("batch",)` (the batch
    sharding of `BatchedGraph`). `devices` is an explicit list and may
    repeat a device; otherwise the first `n_devices` CUDA devices (all of
    them when `n_devices` is None). Raises when fewer CUDA devices are
    visible: this never puts two shards on one card unless `devices` says
    so. A mesh of two axes is not yet ported."""
    axes = tuple(axes)
    if len(axes) != 1:
        raise TexProError(
            ErrorKind.NODE_PROCESSING, f"a mesh of axes {axes} is not yet ported (one axis only)"
        )
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and n_devices != len(devices):
            raise TexProError(
                ErrorKind.GENERIC,
                f"make_mesh: n_devices={n_devices} but {len(devices)} devices given",
            )
        return Mesh(devices, axes[0])
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise TexProError(
            ErrorKind.GENERIC,
            f"make_mesh({n_devices}) needs {max(n, 1)} CUDA devices; {visible} visible",
        )
    return Mesh([torch.device("cuda", i) for i in range(n)], axes[0])


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

class BatchShards:
    """A `[B, ...]` batch held as `mesh.n` contiguous shares of `B // n`
    canvases along the first axis, share `j` on `mesh.devices[j]`: an input
    placed by `shard_planes_batch`, or an output of `BatchedGraph` on a
    batch mesh, which stays where it was computed until `gather`."""

    __slots__ = ("mesh", "shares", "shape")

    def __init__(self, mesh: Mesh, shares):
        shares = tuple(shares)
        if len(shares) != mesh.n:
            raise TexProError(ErrorKind.GENERIC, f"{len(shares)} shares for a mesh of {mesh.n}")
        first = shares[0]
        for share, device in zip(shares, mesh.devices):
            if (share.dim() < 1 or share.shape != first.shape or share.dtype != first.dtype
                    or share.device != device):
                raise TexProError(
                    ErrorKind.GENERIC,
                    f"share {tuple(share.shape)} {share.dtype} on {share.device} does not "
                    f"match {tuple(first.shape)} {first.dtype} on {device}",
                )
        self.mesh = mesh
        self.shares = shares
        self.shape = (first.shape[0] * mesh.n, *first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shares[0].dtype

    def gather(self, device) -> torch.Tensor:
        """The whole batch as one tensor on `device`, counted as a `batch`
        gather."""
        MESH_COUNTERS.count_gather("batch")
        out = torch.empty(self.shape, dtype=self.dtype, device=torch.device(device))
        b = self.shares[0].shape[0]
        for j, share in enumerate(self.shares):
            out[j * b:(j + 1) * b].copy_(share)  # each share copied once, into place
        return out

    def __repr__(self) -> str:
        return f"BatchShards({self.shape}, {self.dtype}, {self.mesh})"


def shard_planes_batch(mesh: Mesh, stacked) -> BatchShards:
    """Place a `[B, H, W]` batch (a tensor or a numpy array) over a batch
    mesh: `B // n` consecutive canvases to each shard's device, as f32.
    Raises unless the mesh's axis is `"batch"` and `B` divides over it."""
    if mesh.axis_name != BATCH_AXIS:
        raise TexProError(
            ErrorKind.GENERIC, f"shard_planes_batch needs a {BATCH_AXIS!r} mesh, got {mesh}"
        )
    if not isinstance(stacked, torch.Tensor):
        stacked = torch.from_numpy(np.ascontiguousarray(stacked, dtype=np.float32))
    if stacked.dim() < 1 or stacked.shape[0] % mesh.n:
        raise TexProError(
            ErrorKind.GENERIC,
            f"a batch of {tuple(stacked.shape)} does not shard over {mesh.n} devices",
        )
    b = stacked.shape[0] // mesh.n
    return BatchShards(mesh, [
        stacked[j * b:(j + 1) * b].to(device=device, dtype=torch.float32).contiguous()
        for j, device in enumerate(mesh.devices)
    ])


def _is_planes(value) -> bool:
    """A plane-tuple argument (`input_`, `image_`, `embed_`, `preset_`)."""
    return isinstance(value, (tuple, list)) and bool(value) and all(
        isinstance(p, (np.ndarray, torch.Tensor, BatchShards)) for p in value)


def _with_batch(t: torch.Tensor, rank: int, b: int) -> torch.Tensor:
    """`t`, whose one canvas has `rank` axes, as a batch of `b`: a batched
    one as it is, an unbatched one broadcast (a view, as vmap's
    `out_axes=0` gives it)."""
    return t if t.dim() == rank + 1 else t.expand(b, *t.shape)


class BatchedGraph:
    """A fused graph program over a batch of canvases: the JAX package's
    `BatchedGraph`, vmap of `CompiledGraph` over the arguments named in
    `batch_keys`.

    A batch key names a plane tuple whose planes are `[B, H, W]` batches
    (`input_<id>`, `image_<id>`, ...; a `BatchShards` from
    `shard_batch_arg` too) or a Value (`value_<id>`, a `[B]` vector, one
    value per canvas); every other argument is shared by all canvases. The
    evaluator runs once over the whole batch: the ops broadcast, an
    unbatched value is computed once, and the Blur, Distance and Warp
    kernels take the whole batch in one launch each. A call returns
    `{(node_id, slot_id): planes}` for the targets, each plane `[B, H, W]`
    (an unbatched target broadcast), or with `include_u8` the
    `[B, H, W, 4]` u8 export. Canvas `i` is bit-identical to the
    single-canvas `CompiledGraph` on canvas `i`.

    `mesh`: a `"batch"` mesh (`make_mesh(..., axes=("batch",))`). Each
    device evaluates its contiguous share of the batch, with the kernels;
    the outputs are `BatchShards` that stay on their devices until the
    caller gathers them. A batch that does not divide over the mesh is
    evaluated whole on the mesh's first device (the JAX package replicates
    it). A `"rows"` mesh (the JAX package's vmap of the row-sharded kernels)
    and `dtype="bfloat16"` are not yet ported. `device` is the card unless
    given (with a mesh, its first device).
    """

    def __init__(self, node_graph, batch_keys, targets=None, include_u8: bool = False,
                 mesh=None, dtype=None, device=None):
        from ..compiler import CompiledGraph

        if mesh is not None:
            if mesh.axis_name != BATCH_AXIS:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING,
                    f"BatchedGraph over a {mesh.axis_name!r} mesh is not yet ported",
                )
            device = mesh.devices[0]
        self.base = CompiledGraph(node_graph, targets, include_u8, dtype=dtype, device=device)
        self.batch_keys = set(batch_keys)
        self.mesh = mesh
        self._programs = {self.base.device: self.base}  # device → its program

    def _program(self, device):
        """The base program evaluated on another device of the mesh."""
        from ..compiler import GraphCompiler

        program = self._programs.get(device)
        if program is None:
            program = copy.copy(self.base)
            program._compiler = GraphCompiler(program.node_graph, device, preset=program.preset)
            program.device = program._compiler.device
            self._programs[device] = program
        return program

    def _batch_size(self, args: dict) -> int:
        sizes = set()
        for key in self.batch_keys & set(args):
            value = args[key]
            if _is_planes(value):
                dims = {tuple(p.shape)[:1] if len(p.shape) == 3 else None for p in value}
            elif re.fullmatch(r"(g\d+_)*value_\d+", key) and np.ndim(value) == 1:
                dims = {tuple(np.shape(value))}
            else:
                raise TexProError(
                    ErrorKind.NODE_PROCESSING,
                    f"batch key {key!r} must hold [B, H, W] planes or a [B] Value vector; "
                    "other batched arguments are not yet ported",
                )
            if None in dims or len(dims) != 1:
                raise TexProError(
                    ErrorKind.GENERIC, f"batch key {key!r} holds no single batch axis: {dims}"
                )
            sizes |= dims
        if len(sizes) != 1:
            raise TexProError(
                ErrorKind.GENERIC, f"the batch keys bound hold batches of {sorted(sizes)}"
            )
        return sizes.pop()[0]

    def _share_args(self, args: dict, j: int, lo: int, hi: int, device) -> dict:
        """The arguments of share `j` (canvases `lo:hi`) on `device`."""
        out = {}
        for key, value in args.items():
            batched = key in self.batch_keys
            if _is_planes(value):
                planes = []
                for p in value:
                    if isinstance(p, BatchShards):
                        p = p.shares[j] if p.mesh == self.mesh else p.gather(device)[lo:hi]
                    elif batched:
                        p = p[lo:hi]
                    planes.append(torch.as_tensor(p))
                value = tuple(p.to(device=device, dtype=torch.float32) for p in planes)
            elif batched:
                value = np.asarray(value, np.float32)[lo:hi]
            out[key] = value
        return out

    def _run(self, program, args: dict, b: int) -> dict:
        rank = 3 if self.base.include_u8 else 2
        return {key: _with_batch(out, rank, b) if self.base.include_u8
                else tuple(_with_batch(p, rank, b) for p in out)
                for key, out in program(**args).items()}

    def __call__(self, **overrides) -> dict:
        args = dict(self.base._bindings)
        args.update(overrides)
        batch = self._batch_size(args)
        mesh = self.mesh
        if mesh is None or batch % mesh.n:
            device = self.base.device
            return self._run(self.base, self._share_args(args, 0, 0, batch, device), batch)
        b = batch // mesh.n
        per_share = [
            self._run(self._program(d), self._share_args(args, j, j * b, (j + 1) * b, d), b)
            for j, d in enumerate(mesh.devices)
        ]
        out = {}
        for key, first in per_share[0].items():
            if self.base.include_u8:
                out[key] = BatchShards(mesh, [r[key] for r in per_share])
            else:
                out[key] = tuple(BatchShards(mesh, [r[key][i] for r in per_share])
                                 for i in range(len(first)))
        return out

    def shard_batch_arg(self, stacked_planes):
        """A `[B, ...]` argument placed over the mesh's batch axis
        (`shard_planes_batch`); without a mesh, as it is."""
        if self.mesh is None:
            return stacked_planes
        return shard_planes_batch(self.mesh, stacked_planes)
