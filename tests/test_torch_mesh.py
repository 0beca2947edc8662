"""The port's mesh route (`TextureProcessor(mesh=...)`) against the JAX
package, on the CPU.

The port's mesh may name one device more than once; here every shard lies
on the CPU (`make_mesh(devices=["cpu"] * n)`), so each shard runs the plain
versions of the block kernels. The JAX package's sharded kernels run in
interpret mode on the virtual CPU mesh of `tests/conftest.py`, as its own
tests run them.

- The plain block functions against the JAX package's block kernels
  (`_blur_block`, `_warp_block` in interpret mode).
- The sharded blur and warp over 2 and 4 shards against the JAX package's
  sharded kernels (`_blur_pallas_sharded`, `_warp_pallas_sharded`) and
  against the port's dense plain versions.
- The gates against the JAX package's `fits_mesh` and `warp_halo`.
- The PBR graph and the flagship at 128² through the port's mesh
  `TextureProcessor` against the JAX package's single-device
  `TextureProcessor` and the port's single-device one, after the render and
  every edit.

Tolerance everywhere: bit-identical f32 (int32 view), equal u8.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from __graft_entry__ import _flagship
from kanter_core_tpu import models as ref_models
from kanter_core_tpu.ops import blur as ref_blur
from kanter_core_tpu.ops import pallas_blur as ref_pallas_blur
from kanter_core_tpu.ops import pallas_warp as ref_pallas_warp
from kanter_core_tpu.ops import warp as ref_warp
from kanter_core_tpu_torch.convert import node_graph_from_reference, planes_from_numpy
from kanter_core_tpu_torch.ops import blur as port_blur
from kanter_core_tpu_torch.ops import warp as port_warp
from kanter_core_tpu_torch.ops.resize import resample_any, resample_plane
from kanter_core_tpu_torch.parallel import (
    MESH_COUNTERS,
    Mesh,
    ShardedPlane,
    make_mesh,
    shard_planes_rows,
)

torch.set_num_threads(1)

CANVAS = 128


def _bits(a) -> np.ndarray:
    if isinstance(a, ShardedPlane):
        a = torch.cat(a.bands)
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same(got, want) -> bool:
    g, w = _bits(got), _bits(want)
    return g.shape == w.shape and int((g != w).sum()) == 0


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _jax_mesh(n):
    from jax.sharding import Mesh as JaxMesh

    return JaxMesh(np.asarray(jax.devices()[:n]), ("rows",))


def _plane(h, w, seed):
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


# --- the mesh and the sharded plane ---------------------------------------


def test_make_mesh_rules():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.n == 3 and mesh.shape == {"rows": 3}
    assert mesh.shardable(6) and not mesh.shardable(7) and not mesh.shardable(2)
    if not torch.cuda.is_available():
        with pytest.raises(port.TexProError):
            make_mesh(4)  # never co-locates shards on its own
        with pytest.raises(port.TexProError):
            make_mesh(devices=["cpu", "cuda:0"])
    with pytest.raises(port.TexProError):
        make_mesh(devices=[])
    with pytest.raises(port.TexProError):
        make_mesh(2, devices=["cpu"] * 3)


def test_ring_halos_wrap_toroidally_and_are_counted():
    plane = torch.from_numpy(_plane(24, 5, 0))
    sp = shard_planes_rows(_cpu_mesh(4), plane)
    assert sp.shape == (24, 5) and sp.nbytes == 24 * 5 * 4 and len(sp.bands) == 4
    MESH_COUNTERS.reset()
    halos = sp.ring_halos(3)
    assert MESH_COUNTERS.snapshot()["exchanges"] == 1
    for j, (top, bot) in enumerate(halos):
        rows = torch.arange(j * 6 - 3, j * 6) % 24
        assert torch.equal(top, plane[rows])
        assert torch.equal(bot, plane[torch.arange(j * 6 + 6, j * 6 + 9) % 24])
    with pytest.raises(port.TexProError):
        sp.ring_halos(7)  # more than one hop
    assert torch.equal(sp.gather("cpu", "host"), plane)
    assert MESH_COUNTERS.snapshot()["gathers"]["host"] == 1


@pytest.mark.parametrize("route", ["map_bands", "warp_strength", "warp_plane"])
def test_dense_full_plane_meeting_a_sharded_one_raises(route):
    """Nothing shards a plane quietly: a dense full-size plane beside a
    sharded one is a placement fault, not a copy."""
    from kanter_core_tpu_torch.parallel import map_bands

    mesh = _cpu_mesh(4)
    dense = torch.from_numpy(_plane(16, 8, 1))
    sp = shard_planes_rows(mesh, torch.from_numpy(_plane(16, 8, 2)))
    k = port_warp.warp_bindings((37.0, 1.0))["k"]
    MESH_COUNTERS.reset()
    with pytest.raises(port.TexProError):
        if route == "map_bands":
            map_bands(torch.add, sp, dense)
        elif route == "warp_strength":
            port_warp.warp_planes([sp], dense, k, halo=3)
        else:
            port_warp.warp_planes([dense], sp, k, halo=3)
    assert MESH_COUNTERS.snapshot() == {"exchanges": 0, "gathers": dict.fromkeys(
        MESH_COUNTERS.CAUSES, 0)}
    # a 1×1 operand is still copied to each shard
    assert _same(map_bands(torch.add, sp, torch.ones((1, 1))), torch.cat(sp.bands) + 1.0)


# --- plain blocks against the JAX package's block kernels ------------------


@pytest.mark.parametrize("h,w,sigma,n", [
    (256, 128, 1.0, 8),
    (64, 256, 2.2, 8),   # block 8 rows, radius 7
    (96, 128, 5.0, 4),
])
def test_blur_block_plain_matches_jax_block(h, w, sigma, n):
    taps = ref_blur.gaussian_taps(round(float(sigma), 6))
    r = (len(taps) - 1) // 2
    plane = _plane(h, w, h + w)
    bh = h // n
    for j in (0, n - 1):
        rows = np.arange(j * bh, (j + 1) * bh)
        block, top, bot = (plane[rows], plane[(rows[0] - r + np.arange(r)) % h],
                           plane[(rows[-1] + 1 + np.arange(r)) % h])
        want = ref_pallas_blur._blur_block(
            jnp.asarray(block), tuple(float(t) for t in taps), jnp.asarray(top),
            jnp.asarray(bot), interpret=True,
        )
        got = port_blur.blur_block_plain(*(torch.from_numpy(a) for a in (block, top, bot)), sigma)
        assert _same(got, np.asarray(want))


@pytest.mark.parametrize("h,w,angle,intensity,n", [
    (256, 128, 57.0, 6.0, 8),
    (64, 256, 213.0, 2.0, 8),   # block 8 rows == the aligned strip
    (96, 128, 33.0, 14.0, 4),
])
def test_warp_block_plain_matches_jax_block(h, w, angle, intensity, n):
    b = ref_warp.warp_bindings((angle, intensity))
    halo = ref_warp.warp_halo(intensity)
    rp = -(-halo // 8) * 8
    plane = _plane(h, w, h * w)
    m = _plane(h, w, 7) * np.float32(1.4) - np.float32(0.2)
    m.flat[::13] = np.nan
    bh = h // n
    k = port_warp.warp_bindings((angle, intensity))["k"]
    assert np.array_equal(k, b["k"])
    for j in (0, 1, n - 1):
        rows = np.arange(j * bh, (j + 1) * bh)
        top = plane[(rows[0] - rp + np.arange(rp)) % h]
        bot = plane[(rows[-1] + 1 + np.arange(rp)) % h]
        want = ref_pallas_warp._warp_block(
            jnp.asarray(plane[rows]), jnp.asarray(m[rows]), jnp.asarray(b["k"]),
            jnp.asarray(b["pairs"]), jnp.asarray(b["npairs"]), jnp.asarray(top),
            jnp.asarray(bot), j * bh, interpret=True,
        )
        (got,) = port_warp.warp_block_plain(
            [torch.from_numpy(plane[rows])], torch.from_numpy(m[rows]), k,
            [torch.from_numpy(top)], [torch.from_numpy(bot)], j * bh, h,
        )
        assert _same(got, np.asarray(want))


# --- sharded against the JAX package's sharded kernels and the dense plain --


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("h,w,sigma", [(256, 128, 1.0), (64, 256, 2.2), (96, 128, 5.0)])
def test_blur_plane_sharded_matches_jax_sharded_and_dense(n, h, w, sigma):
    taps = tuple(float(t) for t in ref_blur.gaussian_taps(round(float(sigma), 6)))
    assert ref_pallas_blur.fits_sharded(h, w, len(taps), n)
    p = _plane(h, w, n * h + w)
    want = np.asarray(jax.jit(ref_pallas_blur._blur_pallas_sharded(taps, _jax_mesh(n), True))(p))
    MESH_COUNTERS.reset()
    got = port_blur.blur_plane(shard_planes_rows(_cpu_mesh(n), torch.from_numpy(p)), sigma)
    assert isinstance(got, ShardedPlane) and got.mesh.n == n
    assert _same(got, want)
    assert _same(got, port_blur.blur_plane_plain(torch.from_numpy(p), sigma))
    counts = MESH_COUNTERS.snapshot()
    assert counts["exchanges"] == 1 and not any(counts["gathers"].values())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("h,w,angle,intensity", [
    (256, 128, 57.0, 6.0), (64, 256, 213.0, 2.0), (96, 128, 33.0, 14.0),
])
def test_warp_planes_mesh_matches_jax_sharded_and_dense(n, h, w, angle, intensity):
    b = ref_warp.warp_bindings((angle, intensity))
    halo = ref_warp.warp_halo(intensity)
    assert ref_pallas_warp.fits_sharded(h, w, halo, n) and ref_warp.fits_mesh(h, n, halo)
    rng = np.random.default_rng(n * h + w)
    p = rng.random((h, w), dtype=np.float32)
    s = rng.random((h, w), dtype=np.float32) * np.float32(1.4) - np.float32(0.2)
    fn = ref_pallas_warp._warp_pallas_sharded(halo, int(b["pairs"].shape[0]), _jax_mesh(n), True)
    want = np.asarray(jax.jit(fn)(p, s, jnp.asarray(b["k"]), jnp.asarray(b["pairs"]),
                                  jnp.asarray(b["npairs"])))
    pb = port_warp.warp_bindings((angle, intensity))
    assert pb["halo"] == halo
    mesh = _cpu_mesh(n)
    MESH_COUNTERS.reset()
    (got,) = port_warp.warp_planes(
        [shard_planes_rows(mesh, torch.from_numpy(p))], shard_planes_rows(mesh, torch.from_numpy(s)),
        pb["k"], halo=pb["halo"],
    )
    assert isinstance(got, ShardedPlane)
    assert _same(got, want)
    (dense,) = port_warp.warp_planes_plain([torch.from_numpy(p)], torch.from_numpy(s), pb["k"])
    assert _same(got, dense)
    counts = MESH_COUNTERS.snapshot()
    assert counts["exchanges"] == 1 and not any(counts["gathers"].values())


def test_warp_planes_mesh_rgba_matches_dense():
    """Four planes share one exchange each and one block call per shard."""
    h, w, n = 64, 48, 4
    rng = np.random.default_rng(5)
    planes = [rng.random((h, w), dtype=np.float32) for _ in range(4)]
    s = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    s.flat[::7] = np.nan
    b = port_warp.warp_bindings((37.0, 5.0))
    mesh = _cpu_mesh(n)
    got = port_warp.warp_planes([shard_planes_rows(mesh, torch.from_numpy(p)) for p in planes],
                                shard_planes_rows(mesh, torch.from_numpy(s)), b["k"], halo=b["halo"])
    want = port_warp.warp_planes_plain([torch.from_numpy(p) for p in planes],
                                       torch.from_numpy(s), b["k"])
    assert all(_same(g, r) for g, r in zip(got, want))


# --- gates -------------------------------------------------------------------


def test_gates_match_reference_over_a_grid():
    for intensity in (0.0, 1.0, 5.0, 6.0, 9.0, 14.0, 63.0, 64.0, 1000.0, -7.5,
                      float("inf"), float("nan")):
        assert port_warp.warp_halo(intensity) == ref_warp.warp_halo(intensity)
    for h in (1, 8, 16, 24, 64, 96, 100, 128, 4096):
        for n in (1, 2, 3, 4, 8):
            for halo in (None, 4, 8, 16, 32, 64):
                assert port_warp.fits_mesh(h, n, halo) == ref_warp.fits_mesh(h, n, halo)


def test_blur_gate_failure_gathers_counted_and_matches_dense():
    """Blocks shorter than the radius take the counted gather path."""
    p = torch.from_numpy(_plane(32, 40, 3))
    sigma = 6.0  # radius 18 > 8-row blocks
    assert not port_blur.fits_sharded(32, len(port_blur.gaussian_taps(sigma)), 4)
    MESH_COUNTERS.reset()
    got = port_blur.blur_plane(shard_planes_rows(_cpu_mesh(4), p), sigma)
    assert isinstance(got, ShardedPlane)
    assert MESH_COUNTERS.snapshot()["gathers"]["blur_gate"] == 1
    assert _same(got, port_blur.blur_plane_plain(p, sigma))


@pytest.mark.parametrize("intensity,n", [(float("inf"), 4), (40.0, 4), (5.0, 1)])
def test_warp_gate_failure_gathers_counted_and_matches_dense(intensity, n):
    """Unbounded intensity, blocks shorter than the halo, or one shard."""
    h, w = 64, 32
    rng = np.random.default_rng(6)
    p, s = rng.random((h, w), dtype=np.float32), rng.random((h, w), dtype=np.float32)
    b = port_warp.warp_bindings((37.0, intensity))
    assert not port_warp.fits_mesh(h, n, b["halo"])
    mesh = _cpu_mesh(n)
    MESH_COUNTERS.reset()
    (got,) = port_warp.warp_planes([shard_planes_rows(mesh, torch.from_numpy(p))],
                                   shard_planes_rows(mesh, torch.from_numpy(s)), b["k"],
                                   halo=b["halo"])
    assert MESH_COUNTERS.snapshot()["gathers"]["warp_gate"] == 2  # the plane and the strength
    (want,) = port_warp.warp_planes_plain([torch.from_numpy(p)], torch.from_numpy(s), b["k"])
    assert np.array_equal(np.isnan(_bits(got).view(np.float32)), np.isnan(want.numpy()))
    finite = ~np.isnan(want.numpy())
    assert np.array_equal(_bits(got)[finite], _bits(want)[finite])


def test_resize_under_a_mesh():
    """A 1×1 plane resized to a shardable size is built band by band; a
    sharded plane resized to another size is a counted gather."""
    from kanter_core_tpu_torch import ResizeFilter, Size

    mesh = _cpu_mesh(4)
    one = torch.full((1, 1), 0.3)
    got = resample_any(one, Size(24, 16), ResizeFilter.TRIANGLE, mesh)
    assert isinstance(got, ShardedPlane)
    assert _same(got, resample_plane(one, Size(24, 16), ResizeFilter.TRIANGLE))
    plain = torch.from_numpy(_plane(10, 6, 1))  # 10 rows do not shard over 4
    assert _same(resample_any(plain, Size(6, 10), ResizeFilter.NEAREST, mesh),
                 resample_plane(plain, Size(6, 10), ResizeFilter.NEAREST))
    src = torch.from_numpy(_plane(16, 12, 2))
    MESH_COUNTERS.reset()
    got = resample_any(shard_planes_rows(mesh, src), Size(20, 32), ResizeFilter.CATMULL_ROM)
    assert MESH_COUNTERS.snapshot()["gathers"]["resize"] == 1
    assert isinstance(got, ShardedPlane)
    assert _same(got, resample_plane(src, Size(20, 32), ResizeFilter.CATMULL_ROM))


# --- the slice end to end ---------------------------------------------------


class _Session:
    """One processor holding `graph_json` with gray inputs bound: the JAX
    package's (`pkg=ref`), the port's on one device (`mesh=None`) or the
    port's over a mesh."""

    def __init__(self, pkg, graph_json, inputs, mesh=None, keep=False, memory=100_000_000):
        self.pkg = pkg
        if pkg is port:
            self.tp = port.TextureProcessor(memory, device="cpu", mesh=mesh)
            graph = node_graph_from_reference(graph_json)
        else:
            self.tp = ref.TextureProcessor(memory)
            graph = ref.NodeGraph.from_json(json.loads(graph_json))
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
            g.use_cache = keep
            g.set_node_graph(graph)
            for node_id, plane in inputs.items():
                if pkg is port:
                    (plane,) = planes_from_numpy([plane], "cpu")
                g.add_input_slot_data(
                    pkg.SlotData(pkg.NodeId(node_id), pkg.SlotId(0), pkg.SlotImage.Gray(plane))
                )

    def read(self, node_id):
        pkg = self.pkg
        u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(self.lg, pkg.NodeId(node_id), pkg.SlotId(0)))
        planes = self.lg.slot_data(pkg.NodeId(node_id), pkg.SlotId(0)).image.planes
        return u8, [np.asarray(p.host_data()) for p in planes]

    def close(self):
        self.tp.shutdown_now()


def _check_reads(sessions, outputs, label):
    for node_id in outputs:
        (want_u8, want), *others = [s.read(node_id) for s in sessions]
        for got_u8, got in others:
            assert got_u8.dtype == np.uint8 and np.array_equal(got_u8, want_u8), (label, node_id)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert _same(g, w), (label, node_id)


def _node(graph, kind, pred=lambda p: True):
    return next(int(n.node_id) for n in graph.nodes
                if n.node_type.kind == kind and pred(n.node_type.payload))


@pytest.mark.parametrize("n", [2, 4])
def test_pbr_mesh_matches_reference_and_single_device(n):
    graph = ref_models.pbr_material_graph()
    text = json.dumps(graph.to_json())
    (inp,) = [int(x.node_id) for x in graph.nodes if x.node_type.kind == ref.NodeTypeKind.INPUT_GRAY]
    outputs = [int(o) for o in graph.output_ids()]
    inputs = {inp: _plane(CANVAS, CANVAS, 0)}
    sessions = [_Session(ref, text, inputs), _Session(port, text, inputs),
                _Session(port, text, inputs, mesh=_cpu_mesh(n))]
    try:
        MESH_COUNTERS.reset()
        _check_reads(sessions, outputs, "render")
        ao_strength = _node(graph, ref.NodeTypeKind.VALUE, lambda p: p == 0.75)
        for s in sessions:
            with s.lg.write() as g:
                g.node_mut(s.pkg.NodeId(ao_strength)).node_type = s.pkg.NodeType.Value(0.6)
        _check_reads(sessions, outputs, "value edit")
        ao_blur = _node(graph, ref.NodeTypeKind.BLUR, lambda p: p == 6.0)
        for s in sessions:
            s.lg.set_blur_sigma(s.pkg.NodeId(ao_blur), 4.0)
        _check_reads(sessions, outputs, "sigma edit")
        mesh_metrics = sessions[2].tp.metrics()["mesh"]
        assert mesh_metrics["devices"] == ["cpu"] * n and mesh_metrics["exchanges"] > 0
        gathers = mesh_metrics["gathers"]
        assert gathers["export"] == 3 * len(outputs)  # one per read of the mesh processor
        assert gathers["distance"] == gathers["blur_gate"] == gathers["warp_gate"] == 0
        assert gathers["resize"] == 0
    finally:
        for s in sessions:
            s.close()


@pytest.mark.parametrize("n", [2, 4])
def test_flagship_mesh_matches_reference_and_single_device(n):
    ref_graph, ref_inputs, out = _flagship(CANVAS)
    text = json.dumps(ref_graph.to_json())
    rng = np.random.default_rng(0)
    inputs = {int(i): rng.random((CANVAS, CANVAS), dtype=np.float32) for i in ref_inputs}
    sessions = [_Session(ref, text, inputs), _Session(port, text, inputs, keep=True),
                _Session(port, text, inputs, mesh=_cpu_mesh(n), keep=True)]
    K = ref.NodeTypeKind
    v = _node(ref_graph, K.VALUE, lambda p: float(p) == np.float32(0.96))
    dist, warp = _node(ref_graph, K.DISTANCE), _node(ref_graph, K.WARP)
    try:
        MESH_COUNTERS.reset()
        _check_reads(sessions, [int(out)], "render")
        for s in sessions:
            with s.lg.write() as g:
                g.node_mut(s.pkg.NodeId(v)).node_type = s.pkg.NodeType.Value(0.93)
        _check_reads(sessions, [int(out)], "value edit")
        for s in sessions:
            s.lg.set_distance(s.pkg.NodeId(dist), CANVAS / 16.0)
        _check_reads(sessions, [int(out)], "distance edit")
        for s in sessions:
            s.lg.set_warp(s.pkg.NodeId(warp), 37.0, 9.0)
        _check_reads(sessions, [int(out)], "warp edit")
        gathers = sessions[2].tp.metrics()["mesh"]["gathers"]
        # Distance ran on the render and on its own edit; four exports
        assert gathers["distance"] == 2 and gathers["export"] == 4
        assert gathers["blur_gate"] == gathers["warp_gate"] == gathers["resize"] == 0
    finally:
        for s in sessions:
            s.close()


def _stencil_graph():
    """input → h2n → blur → out, the JAX package's mesh-engine stencil
    chain without the image decode."""
    g = port.NodeGraph()
    inp = g.add_node(port.Node(port.NodeType.InputGray("in")))
    h2n = g.add_node(port.Node(port.NodeType.HeightToNormal()))
    blur = g.add_node(port.Node(port.NodeType.Blur(1.5)))
    out = g.add_node(port.Node(port.NodeType.OutputRgba("out")))
    g.connect(inp, h2n, port.SlotId(0), port.SlotId(0))
    g.connect(h2n, blur, port.SlotId(0), port.SlotId(0))
    g.connect(blur, out, port.SlotId(0), port.SlotId(0))
    return g, inp, out


def test_mesh_engine_output_is_sharded():
    """The committed output planes are row-sharded over the mesh (not a
    silently gathered result), and equal the single-device render."""
    graph, inp, out = _stencil_graph()
    text = json.dumps(graph.to_json())
    inputs = {int(inp): _plane(64, 48, 9)}
    mesh = _cpu_mesh(4)
    sessions = [_Session(port, text, inputs), _Session(port, text, inputs, mesh=mesh)]
    try:
        _check_reads(sessions, [int(out)], "render")
        planes = sessions[1].lg.slot_data(out, port.SlotId(0)).image.planes
        for buf in planes:
            data = buf.data()
            assert isinstance(data, ShardedPlane) and data.mesh == mesh
            assert data.shape == (64, 48) and [b.shape[0] for b in data.bands] == [16] * 4
    finally:
        for s in sessions:
            s.close()


def test_mesh_slice_under_eviction_matches_resident_run():
    """With zero device and host budgets every idle sharded plane is
    evicted to the host and to disk, and faulted back sharded."""
    graph = ref_models.pbr_material_graph()
    text = json.dumps(graph.to_json())
    (inp,) = [int(x.node_id) for x in graph.nodes if x.node_type.kind == ref.NodeTypeKind.INPUT_GRAY]
    inputs = {inp: _plane(40, 40, 1)}
    resident = _Session(port, text, inputs, mesh=_cpu_mesh(4))
    evicting = _Session(port, text, inputs, mesh=_cpu_mesh(4), memory=0)
    evicting.tp.buffer_queue.host_threshold = port.AtomicUsize(0)
    try:
        for node_id in graph.output_ids():
            _check_reads([resident, evicting], [int(node_id)], "evicted")
        m = evicting.tp.metrics()
        assert m["bytes_host"] + m["bytes_storage"] > 0
        assert m["mesh"]["gathers"]["host"] > 0
    finally:
        resident.close()
        evicting.close()


def test_mesh_must_match_the_processor_device():
    with pytest.raises(port.TexProError):
        port.TextureProcessor(device="cpu", mesh=["cpu", "cpu"])
    tp = port.TextureProcessor(device="cpu", mesh=Mesh(["cpu"] * 2))
    try:
        assert tp.device == torch.device("cpu") and tp.metrics()["mesh"]["devices"] == ["cpu"] * 2
    finally:
        tp.shutdown_now()


def test_u8_export_of_a_sharded_image_gathers_u8_rows():
    from kanter_core_tpu_torch.transient_buffer import plane_from_device

    mesh = _cpu_mesh(4)
    planes = [torch.from_numpy(_plane(16, 8, s) * np.float32(1.2) - np.float32(0.1))
              for s in range(4)]
    dense = port.SlotImage([plane_from_device(p) for p in planes])
    sharded = port.SlotImage([plane_from_device(shard_planes_rows(mesh, p)) for p in planes])
    MESH_COUNTERS.reset()
    assert np.array_equal(sharded.to_u8(), dense.to_u8())
    assert MESH_COUNTERS.snapshot()["gathers"]["export"] == 1
    gray = port.SlotImage([plane_from_device(shard_planes_rows(mesh, planes[0]))])
    assert np.array_equal(gray.to_u8(), port.SlotImage([plane_from_device(planes[0])]).to_u8())
