"""Fused graph evaluation: a dirty partition → one pass over torch tensors.

Port of `kanter_core_tpu/compiler.py`. The JAX package traces a graph into
one jitted XLA program; here the "program" is a cached Python evaluator that
walks the graph in topological order and calls the ops' tensor functions
eagerly on the device of its bindings. What carries over unchanged:

- runtime-variable leaves are *arguments* (`Value` scalars, the argument
  fields of the parametric nodes — see `collect_value_bindings` —,
  `InputGray`/`InputRgba` planes, `Embed` planes, and the preset planes of a
  partition's clean boundary), so an edit re-runs the cached evaluator with
  new bindings; an Image node decodes its file on every evaluation (the JAX
  package re-decodes the Image nodes of each dirty partition);
- a nested Graph node is inlined: its graph is evaluated in place with its
  arguments under the prefix `g<node id>_` (nested graphs nest the
  prefixes), outer input slot n feeding inner Input node n, and its outputs
  re-keyed as `SlotId(inner output node id)`. A Write node is a host sink
  the evaluator cannot hold: it yields nothing here, and the engine runs
  Write nodes, and Graph nodes that nest one, on the per-node route;
- the resize pass before every node (`calculate_size` + `resample_plane`),
  with the eager path's edge-insertion order for policy ties;
- the output layout (`call_with_layout`): every output plane is reported
  once, and outputs that alias one plane (Output re-keying, SeparateRgba,
  gray→rgba coercion) share its index, like the reference's Arc-shared
  channel planes;
- the structure fingerprint (`graph_fingerprint`) that keys the cache, with
  the argument fields normalized out.

With a `mesh` (`TextureProcessor(mesh=...)`), every plane whose rows shard
over the mesh is a `parallel.sharded.ShardedPlane` — the engine shards the
leaf planes by the placement rule of the JAX package's `_shard_overrides`,
and the evaluator creates constant and procedural planes, and resizes, the
same way — while smaller planes (1×1 Values) stay tensors on the mesh's
first device. Each op dispatches on `ShardedPlane`: elementwise ops run
shard by shard, the stencils (HeightToNormal, Curvature) and the Blur and
Warp kernels exchange ring halos, and Distance gathers (see the ops). The
results are bit-identical to the single-device evaluator.

Each node's rules (defaults, aliases, type checks, where constant and
procedural planes are made) are the op modules', which the per-node route
(`ops.process_node`) calls too.

Every op takes planes with a leading batch axis as well (`[B, H, W]`),
with `jax.vmap`'s semantics: a batched value is computed canvas by canvas,
bit for bit as on its own, and an unbatched one (a procedural source, a 1×1
Value, a plane made from them) is computed once and broadcast where it meets
a batched one. So the same evaluator serves the batched path
(`parallel.BatchedGraph`, `parallel.BatchedLiveSession`); the Blur, Distance
and Warp kernels take a whole batch in one launch.

The standalone API is the JAX package's: `CompiledGraph(graph, targets,
include_u8)` called with argument overrides returns the targets' planes,
`compile_graph` caches programs by fingerprint. A call with targets drops
every node's planes after their last consumer (XLA's liveness does this for
the JAX package), so a batched call at full width holds only the live
planes; the engine's `call_with_layout` keeps every plane, as it reports
them all.

Not carried over: `_const_guard` and the `optimization_barrier` shims, which
keep XLA's constant folder away from constant planes — eager torch does not
fold; `pallas_ok`, as the kernels always run on the card; the bf16 pipeline
(`dtype="bfloat16"` raises "not yet ported").
"""

from __future__ import annotations

import copy
import hashlib
import json
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .errors import ErrorKind, TexProError
from .geometry import Size
from .ids import NodeId, SlotId
from .node import NodeTypeKind
from .node_graph import NodeGraph
from .ops.ambient_occlusion import ao_plane
from .ops.blur import blur_images
from .ops.common import Placement, connected_input, gray_input
from .ops.curvature import curvature_plane
from .ops.distance import distance_plane
from .ops.gradient import gradient_bindings, gradient_planes
from .ops.height_to_normal import h2n_planes
from .ops.hsv import hsv_bindings, hsv_planes
from .ops.inout import image_node_planes, no_outer_input, output_planes, value_plane
from .ops.levels import levels_bindings, levels_images
from .ops.mix import mix_images
from .ops.noise import noise_bindings, noise_source
from .ops.pattern import pattern_bindings, pattern_source
from .ops.ramp import ramp_bindings, ramp_source
from .ops.resize import calculate_size, resample_any
from .ops.separate_combine import combine_planes, separate_planes
from .ops.transform import transform_bindings, transform_images
from .ops.voronoi import voronoi_bindings, voronoi_source
from .ops.warp import warp_bindings, warp_images

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
        h, w = self.planes[0].shape[-2:]
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


class GraphCompiler:
    """Evaluates a NodeGraph's nodes in topological order on `device`, or
    row-sharded over `mesh` (whose first device is then `device`)."""

    def __init__(self, node_graph: NodeGraph, device: torch.device, preset=None, mesh=None):
        self.node_graph = node_graph
        self.mesh = mesh
        self.place = Placement(device, mesh)
        self.device = self.place.device
        # preset: {(NodeId, SlotId): n_planes} — nodes whose outputs are
        # already computed (clean boundary of a dirty partition); their
        # planes are arguments instead of being re-evaluated.
        self.preset = dict(preset or {})

    def _eval_graph(self, graph: NodeGraph, args: dict, prefix: str = "",
                    outer_inputs: Optional[dict] = None, keep=None) -> dict:
        """Returns {(node_id, slot_id): ImgVal} for every node in `graph`,
        or, with `keep` (a set of node ids), for those nodes only: every
        other node's values are dropped once its last consumer has run.

        `prefix` namespaces the argument keys of an inlined nested graph;
        `outer_inputs` maps its inner Input node ids to the outer ImgVals
        (`graph.rs:25-31`). Presets apply to the outermost graph only."""
        values: dict = {}
        ordered_outer = [outer_inputs[k] for k in sorted(outer_inputs)] if outer_inputs else []
        preset_nodes = {nid for nid, _ in self.preset} if prefix == "" else set()
        consumers: dict = {}  # node id → edges still to read its values
        if keep is not None:
            for e in graph.edges:
                consumers[e.output_id] = consumers.get(e.output_id, 0) + 1

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
                            [resample_any(p, size, node.resize_filter, self.mesh)
                             for p in sd.img.planes]
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
                by_slot[edge.input_slot] = next(
                    sd.img for sd in inputs
                    if sd.node_id == edge.output_id and sd.slot_id == edge.output_slot
                )
            del inputs  # the resized copies live as long as `by_slot`

            for slot_id, img in self._emit(node, by_slot, args, prefix, ordered_outer):
                values[(node_id, slot_id)] = img
            del by_slot
            if keep is not None:
                for e in edges_ins:
                    consumers[e.output_id] -= 1
                for done in {e.output_id for e in edges_ins} | {node_id}:
                    if consumers.get(done, 0) == 0 and done not in keep:
                        for key in [k for k in values if k[0] == done]:
                            del values[key]
        return values

    def _emit(self, node, by_slot: dict, args, prefix: str, ordered_outer: list):
        """The node's `[(output SlotId, ImgVal)]` from its inputs' ImgVals by
        input slot. The rules are the op modules', shared with the per-node
        route (`ops.process_node`)."""
        K = NodeTypeKind
        kind = node.node_type.kind
        nid = int(node.node_id)
        place = self.place
        planes = {slot: img.planes for slot, img in by_slot.items()}
        inp = planes.get(SlotId(0))

        def one(out_planes):
            return [(SlotId(0), ImgVal(out_planes))]

        def arg(name):
            return args[f"{prefix}{name}_{nid}"]

        if kind == K.VALUE:
            # scalar argument → 1×1 plane
            return one([value_plane(arg("value"), self.device)])

        if kind == K.IMAGE:
            bound = args.get(f"{prefix}image_{nid}")  # the standalone API's binding
            if bound is not None:
                return one(list(bound))
            return one(image_node_planes(node.node_type.payload, place))

        if kind == K.INPUT_RGBA:
            # the first outer input (`input_rgba.rs:7-13` indexes [0])
            if ordered_outer:
                return [(SlotId(0), ordered_outer[0])]
            if f"{prefix}input_rgba_first" not in args:
                raise no_outer_input()
            return one(list(args[f"{prefix}input_rgba_first"]))

        if kind == K.INPUT_GRAY:
            key = f"{prefix}input_{nid}"
            if key not in args:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT, f"InputGray node {nid} has no bound input"
                )
            bound = args[key]
            return [(SlotId(0), bound if isinstance(bound, ImgVal) else ImgVal(bound))]

        if kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
            connected = planes[min(planes)] if planes else None
            return one(output_planes(connected, kind == K.OUTPUT_RGBA, place))

        if kind == K.MIX:
            return one(mix_images(node.node_type.payload, inp, planes.get(SlotId(1)), place))

        if kind == K.HEIGHT_TO_NORMAL:
            return one(list(h2n_planes(gray_input(inp, "HeightToNormal"))))

        if kind == K.BLUR:
            return one(blur_images(inp, node.node_type.payload))

        if kind == K.SEPARATE_RGBA:
            return [(SlotId(i), ImgVal(p)) for i, p in enumerate(separate_planes(inp, place))]

        if kind == K.COMBINE_RGBA:
            return one(combine_planes(planes, place))

        if kind == K.EMBED:
            embedded = args.get(f"{prefix}embed_{int(node.node_type.payload)}")
            if embedded is None:
                raise TexProError(
                    ErrorKind.INVALID_BUFFER_COUNT,
                    f"no embedded slot data with id {int(node.node_type.payload)}",
                )
            return one(list(embedded))

        if kind == K.HSV:
            return one(hsv_planes(connected_input(inp, "Hsv"), arg("hsv")))

        if kind == K.CURVATURE:
            return one([curvature_plane(gray_input(inp, "Curvature"), arg("curv"))])

        if kind == K.DISTANCE:
            return one([distance_plane(gray_input(inp, "Distance"), arg("dist"))])

        if kind == K.AMBIENT_OCCLUSION:
            radius = node.node_type.payload[1]
            plane = gray_input(inp, "AmbientOcclusion")
            return one([ao_plane(plane, arg("ao"), radius)])

        if kind == K.LEVELS:
            return one(levels_images(inp, arg("levels")))

        if kind == K.GRADIENT_MAP:
            return one(gradient_planes(inp, arg("grad")))

        if kind == K.TRANSFORM:
            return one(transform_images(inp, arg("xform")))

        if kind == K.NOISE:
            return one([noise_source(arg("noise"), place)])

        if kind == K.PATTERN:
            # the kind is structure, not an argument
            mask, cells = pattern_source(node.node_type.payload[2], arg("pattern"), place)
            return [(SlotId(0), ImgVal([mask])), (SlotId(1), ImgVal([cells]))]

        if kind == K.VORONOI:
            outs = voronoi_source(arg("voronoi"), place)
            return [(SlotId(i), ImgVal([p])) for i, p in enumerate(outs)]

        if kind == K.RAMP:
            return one([ramp_source(node.node_type.payload[2], arg("ramp"), place)])

        if kind == K.WARP:
            return one(warp_images(inp, planes.get(SlotId(1)), arg("warp")))

        if kind == K.GRAPH:
            nested = node.node_type.payload
            # outer input slot n ≡ inner Input node n (`node_graph.rs:271-313`)
            outer = {NodeId(int(slot)): img for slot, img in by_slot.items()}
            nested_prefix = f"{prefix}g{nid}_"
            nested_args = dict(args)
            for inner_id, img in outer.items():
                nested_args[f"{nested_prefix}input_{int(inner_id)}"] = img
            inner = self._eval_graph(nested, nested_args, nested_prefix, outer)
            return [(SlotId(int(out_id)), inner[(out_id, SlotId(0))])
                    for out_id in nested.output_ids()]

        if kind == K.WRITE:
            return []  # a host sink: the engine runs it on the per-node route

        raise TexProError(ErrorKind.INVALID_NODE_TYPE, f"cannot evaluate {node.node_type!r}")


def resolve_dtype(dtype) -> torch.dtype:
    """The pipeline's storage dtype: float32, the bit-exact default. The
    JAX package's bf16 mode (`dtype="bfloat16"`) is not yet ported."""
    if dtype in (None, "float32", torch.float32, np.float32):
        return torch.float32
    raise TexProError(ErrorKind.NODE_PROCESSING, f"dtype={dtype!r} is not yet ported")


def _resolve_device(device) -> torch.device:
    """`device` (the card when None) as the processor resolves it: a CUDA
    device must exist, there is no fallback to the CPU."""
    from .texture_processor import resolve_device

    return resolve_device("cuda" if device is None else device)


def default_targets(node_graph: NodeGraph) -> list:
    """The Output nodes' slot 0, else every terminal node's slot 0 except
    a Write's."""
    targets = [(nid, SlotId(0)) for nid in node_graph.output_ids()]
    if not targets:
        with_children = {e.output_id for e in node_graph.edges}
        targets = [
            (n.node_id, SlotId(0))
            for n in node_graph.nodes
            if n.node_id not in with_children and n.node_type.kind != NodeTypeKind.WRITE
        ]
    return targets


def planes_on(planes, device) -> tuple:
    """A plane tuple (numpy arrays or tensors) as f32 tensors on `device`;
    tensors already there pass as they are."""
    return tuple(
        torch.as_tensor(np.asarray(p, np.float32) if not isinstance(p, torch.Tensor) else p)
        .to(device=device, dtype=torch.float32)
        for p in planes
    )


class CompiledGraph:
    """A cached, reusable evaluator for a node graph on one device, or
    row-sharded over a `mesh`: the JAX package's `CompiledGraph`.

    `targets` selects the `(node_id, slot_id)` outputs a call returns
    (default: the Output nodes, else every terminal node's slot 0 except a
    Write's); `include_u8` returns each as its `[..., H, W, 4]` u8 export
    instead of its planes. The arguments are `_bindings` (Value constants and
    the other nodes' argument fields, Image planes decoded at construction)
    updated by `bind_input`, `bind_input_rgba`, `bind_embed`, `set_value`
    and each call's overrides.

    The engine builds it with `emit_all=True` and a `preset`: then
    `call_with_layout` evaluates every node not in `preset` and returns the
    unique output planes plus the layout that maps each output slot to
    them, and Image nodes decode their files on every evaluation.

    `device` is the card (`"cuda"`) unless given; `dtype` other than float32
    raises (the bf16 pipeline is not yet ported).
    """

    def __init__(self, node_graph: NodeGraph, targets: Optional[list] = None,
                 include_u8: bool = False, preset=None, emit_all: bool = False, mesh=None,
                 dtype=None, device=None):
        self.dtype = resolve_dtype(dtype)
        self.node_graph = node_graph
        self.mesh = mesh
        self.preset = dict(preset or {})
        self.emit_all = emit_all
        if emit_all:
            targets = []
        elif targets is None:
            targets = default_targets(node_graph)
        self.targets = [(NodeId(n), SlotId(s)) for n, s in targets]
        self.include_u8 = include_u8
        if mesh is None:
            device = _resolve_device(device)
        self._compiler = GraphCompiler(node_graph, device, preset=self.preset, mesh=mesh)
        self.device = self._compiler.device
        self._bindings = collect_value_bindings(node_graph)
        if not emit_all:
            preset_ids = {nid for nid, _ in self.preset}
            self._bindings.update(collect_image_bindings(
                node_graph, [n.node_id for n in node_graph.nodes if n.node_id not in preset_ids],
                device=self.device))

    def _placed(self, given: dict) -> dict:
        """`given` with its plane tuples moved to the device (and placed
        over the mesh, if any)."""
        args = {}
        for key, value in given.items():
            if isinstance(value, (tuple, list)) and all(
                    isinstance(p, (np.ndarray, torch.Tensor)) for p in value):
                value = planes_on(value, self.device)
                if self.mesh is not None:
                    value = tuple(self._compiler.place.place(p) for p in value)
            args[key] = value
        return args

    def _evaluate(self, args: dict) -> dict:
        """`{target: ImgVal}`: the targets' values, every other node's
        planes dropped after their last consumer."""
        keep = {nid for nid, _ in self.targets}
        values = self._compiler._eval_graph(self.node_graph, args, keep=keep)
        return {key: values[key] for key in self.targets}

    def _raw_fn(self, args: dict) -> dict:
        """The program as a plain function of a whole argument dict (the JAX
        package's un-jitted `_raw_fn`, which it vmaps): the targets'
        outputs, as `__call__` gives them."""
        out = {}
        for key, img in self._evaluate(self._placed(args)).items():
            out[key] = _u8_export(img) if self.include_u8 else tuple(img.planes)
        return out

    def __call__(self, **overrides) -> dict:
        """`{(node_id, slot_id): planes}` for the targets: a tuple of plane
        tensors, or with `include_u8` the u8 export."""
        return self._raw_fn({**self._bindings, **overrides})

    def call_with_layout(self, **overrides):
        """Returns `(unique_planes, layout)`: `layout` maps
        `(node_id, slot_id) → (unique_plane_index, ...)`. Plane aliasing
        across outputs is kept by deduplicating identical tensors (every
        value stays referenced in `values` meanwhile, so `id` is unique)."""
        values = self._compiler._eval_graph(self.node_graph,
                                            self._placed({**self._bindings, **overrides}))
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

    def bind_embed(self, embedded_slot_data_id, planes) -> None:
        self._bindings[f"embed_{int(embedded_slot_data_id)}"] = planes_on(planes, self.device)

    def bind_input(self, input_node_id, planes, prefix: str = "") -> None:
        self._bindings[f"{prefix}input_{int(input_node_id)}"] = planes_on(planes, self.device)

    def bind_input_rgba(self, planes, prefix: str = "") -> None:
        """Bind the graph's FIRST outer input (InputRgba semantics — the
        reference indexes `input_slot_datas[0]`, `input_rgba.rs:7-13`)."""
        self._bindings[f"{prefix}input_rgba_first"] = planes_on(planes, self.device)

    def set_value(self, node_id, value: float, prefix: str = "") -> None:
        """Re-bind a Value node without rebuilding. Raises on a non-Value
        node id — a silently unused binding would make edits no-ops."""
        key = f"{prefix}value_{int(node_id)}"
        if key not in self._bindings:
            raise TexProError(
                ErrorKind.INVALID_NODE_TYPE,
                f"{key} is not a Value binding of this program",
            )
        self._bindings[key] = np.float32(value)


def _u8_export(img: ImgVal):
    """An image's u8 export, `[..., H, W, 4]`: RGBA stacked on the last
    axis, gray as `v, v, v, 255` (planes of one batch broadcast together;
    a row-sharded plane is gathered, an `export` gather)."""
    from .ops.common import f32_to_u8
    from .parallel.sharded import ShardedPlane

    planes = [p.gather(p.mesh.devices[0], "export") if isinstance(p, ShardedPlane) else p
              for p in img.planes]
    if len(planes) == 4:
        return torch.stack(torch.broadcast_tensors(*[f32_to_u8(p) for p in planes]), dim=-1)
    v = f32_to_u8(planes[0])
    return torch.stack([v, v, v, torch.full_like(v, 255)], dim=-1)


def _normalize_values(graph_json):
    """Zero out the payload fields that are evaluator arguments (Value
    constants, Levels and Transform parameters, GradientMap stop values,
    Curvature/AO strength, Distance spread, Hsv adjust, the procedural
    sources' cells/seed/persistence/mortar/bevel/jitter/angle/centre/scale,
    Warp angle and intensity), recursing into nested graphs, so two graphs
    differing only in those share one cached evaluator. What shapes the
    evaluation stays: sizes, octaves, Pattern and Ramp kinds, the AO
    radius, Blur sigma, the GradientMap stop count, Image and Write paths.
    Warp is zeroed whole: the JAX package keeps its intensity's halo bucket
    for the tiled and mesh programs, which the port does not have."""
    out = {"nodes": [], "edges": graph_json["edges"]}
    for node in graph_json["nodes"]:
        node_type = node["node_type"]
        if isinstance(node_type, dict):
            if "Value" in node_type:
                node = dict(node, node_type={"Value": 0.0})
            elif "Levels" in node_type:
                node = dict(node, node_type={"Levels": {
                    "in_lo": 0.0, "in_hi": 0.0, "gamma": 0.0, "out_lo": 0.0, "out_hi": 0.0,
                }})
            elif "GradientMap" in node_type:
                node = dict(node, node_type={"GradientMap": {
                    "stops": [[0.0] * 5] * len(node_type["GradientMap"]["stops"]),
                }})
            elif "Transform" in node_type:
                node = dict(node, node_type={"Transform": {
                    "offset_x": 0.0, "offset_y": 0.0, "rotation": 0.0,
                    "scale_x": 0.0, "scale_y": 0.0,
                }})
            elif "Curvature" in node_type:
                node = dict(node, node_type={"Curvature": 0.0})
            elif "AmbientOcclusion" in node_type:
                node = dict(node, node_type={"AmbientOcclusion": dict(
                    node_type["AmbientOcclusion"], strength=0.0,
                )})
            elif "Distance" in node_type:
                node = dict(node, node_type={"Distance": 0.0})
            elif "Hsv" in node_type:
                node = dict(node, node_type={"Hsv": {
                    "hue": 0.0, "saturation": 0.0, "value": 0.0,
                }})
            elif "Noise" in node_type:
                node = dict(node, node_type={"Noise": dict(
                    node_type["Noise"], cells=0, seed=0, persistence=0.0,
                )})
            elif "Pattern" in node_type:
                node = dict(node, node_type={"Pattern": dict(
                    node_type["Pattern"], cells_x=0, cells_y=0,
                    mortar=0.0, bevel=0.0, seed=0,
                )})
            elif "Voronoi" in node_type:
                node = dict(node, node_type={"Voronoi": dict(
                    node_type["Voronoi"], cells_x=0, cells_y=0,
                    jitter=0.0, seed=0,
                )})
            elif "Ramp" in node_type:
                node = dict(node, node_type={"Ramp": dict(
                    node_type["Ramp"], angle=0.0, cx=0.0, cy=0.0, scale=0.0,
                )})
            elif "Warp" in node_type:
                node = dict(node, node_type={"Warp": {"angle": 0.0, "intensity": 0.0}})
            elif "Graph" in node_type:
                node = dict(node, node_type={"Graph": _normalize_values(node_type["Graph"])})
        out["nodes"].append(node)
    return out


def graph_fingerprint(node_graph: NodeGraph, extra: str = "") -> str:
    """Structure hash for evaluator caching: topology + params. Value-node
    constants are excluded (see `_normalize_values`)."""
    blob = json.dumps(_normalize_values(node_graph.to_json()), sort_keys=True) + extra
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def collect_value_bindings(node_graph: NodeGraph, prefix: str = "") -> dict:
    """The current evaluator arguments of every node (the payload fields
    `_normalize_values` zeroes), as overrides, recursing into nested graphs
    under their prefixes."""
    K = NodeTypeKind
    scalar = {K.VALUE: "value", K.CURVATURE: "curv", K.DISTANCE: "dist"}
    derived = {
        K.LEVELS: ("levels", levels_bindings),
        K.HSV: ("hsv", hsv_bindings),
        K.NOISE: ("noise", noise_bindings),
        K.PATTERN: ("pattern", pattern_bindings),
        K.VORONOI: ("voronoi", voronoi_bindings),
        K.RAMP: ("ramp", ramp_bindings),
        K.GRADIENT_MAP: ("grad", gradient_bindings),
        K.TRANSFORM: ("xform", transform_bindings),
        K.WARP: ("warp", warp_bindings),
    }
    bindings = {}
    for node in node_graph.nodes:
        kind = node.node_type.kind
        payload = node.node_type.payload
        nid = int(node.node_id)
        if kind in scalar:
            bindings[f"{prefix}{scalar[kind]}_{nid}"] = np.float32(payload)
        elif kind == K.AMBIENT_OCCLUSION:
            bindings[f"{prefix}ao_{nid}"] = np.float32(payload[0])
        elif kind in derived:
            name, fn = derived[kind]
            bindings[f"{prefix}{name}_{nid}"] = fn(payload)
        elif kind == K.GRAPH:
            bindings.update(collect_value_bindings(payload, f"{prefix}g{nid}_"))
    return bindings


def collect_image_bindings(node_graph: NodeGraph, node_ids=None, prefix: str = "",
                           dtype=None, device=None) -> dict:
    """Freshly decoded planes for Image nodes (optionally restricted to
    `node_ids` at the top level), as `image_<id>` arguments on `device`
    (the card unless given): a file that cannot be read gives the 1×1
    magenta placeholder, as the node does."""
    from .ops.image_io import image_planes

    resolve_dtype(dtype)
    device = _resolve_device(device)
    bindings = {}
    for node in node_graph.nodes:
        kind = node.node_type.kind
        if kind == NodeTypeKind.IMAGE:
            if prefix == "" and node_ids is not None and node.node_id not in node_ids:
                continue
            bindings[f"{prefix}image_{int(node.node_id)}"] = planes_on(
                image_planes(node.node_type.payload), device)
        elif kind == NodeTypeKind.GRAPH:
            bindings.update(collect_image_bindings(
                node.node_type.payload, None, f"{prefix}g{int(node.node_id)}_", device=device))
    return bindings


_PROGRAM_CACHE: OrderedDict = OrderedDict()
_PROGRAM_CACHE_CAP = 128  # LRU bound: programs pin their decoded Image planes


def compile_graph(node_graph: NodeGraph, targets: Optional[list] = None,
                  include_u8: bool = False, cache: bool = True, dtype=None,
                  device=None) -> CompiledGraph:
    """A `CompiledGraph` for `node_graph`, from an LRU cache of programs
    keyed by the graph's fingerprint, the targets and `include_u8` (and the
    device). `targets=None` (the default outputs) and `[]` (a program that
    computes nothing) are distinct keys. A hit returns a shallow handle that
    shares the program but owns its bindings, refreshed from this graph's
    Value constants, so an edit through one handle never reaches another."""
    dtype = resolve_dtype(dtype)
    device = _resolve_device(device)
    key = None
    if cache:
        key = (
            graph_fingerprint(
                node_graph,
                extra="default" if targets is None else repr(sorted(
                    (int(n), int(s)) for n, s in targets)),
            ),
            include_u8,
            str(device),
        )
        hit = _PROGRAM_CACHE.get(key)
        if hit is not None:
            _PROGRAM_CACHE.move_to_end(key)
            handle = copy.copy(hit)
            handle._bindings = dict(hit._bindings)
            handle._bindings.update(collect_value_bindings(node_graph))
            return handle
    program = CompiledGraph(node_graph, targets, include_u8, dtype=dtype, device=device)
    if cache:
        _PROGRAM_CACHE[key] = program
        while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_CAP:
            _PROGRAM_CACHE.popitem(last=False)
    return program
