"""The port's f32 pow against the JAX package's, on the CPU.

The JAX package's CPU pow is glibc `powf` (`jnp.power` on XLA:CPU); off
the CPU it is `exact_math.ds_pow`. The port computes the same split by the
tensor's device: `powf_glibc` on the CPU, its own `ds_pow` on a card. Here,
over the full u8 grid (`a = i/255`, `b = 4·j/255`, 65,536 pairs) and on
special values, `powf_glibc` must give the bits of `jnp.power` and the
port's `ds_pow` (run on the CPU) those of the JAX `ds_pow`. Mix POW and the
sRGB export (`SlotImage.to_u8_srgb`, Gray and RGBA) must then match the
JAX package bit for bit, f32 and u8.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu.ops import exact_math as ref_exact
from kanter_core_tpu.ops import mix as ref_mix
from kanter_core_tpu_torch.ops import exact_math as port_exact
from kanter_core_tpu_torch.ops import mix as port_mix

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _mismatches(got, want) -> int:
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape
    return int((got != want).sum())


def _u8_grid():
    i = np.arange(256, dtype=np.float32)
    a = np.ascontiguousarray(np.broadcast_to(i[:, None] / np.float32(255), (256, 256)))
    b = np.ascontiguousarray(np.broadcast_to(np.float32(4) * i[None, :] / np.float32(255),
                                             (256, 256)))
    return a, b


# no pair has a subnormal operand or result: XLA:CPU flushes those to zero,
# while glibc and torch keep them (a divergence of every op, not of pow)
_SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5, 3.0, -3.5, np.inf, -np.inf,
                     np.nan, 1e-30, 1e30, 1e-10, 0.9999999, 1.0000001, 100.5, -100.0],
                    np.float32)


def _special_grid():
    a, b = np.meshgrid(_SPECIAL, _SPECIAL, indexing="ij")
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


@pytest.mark.parametrize("grid", ["u8", "special"])
def test_powf_glibc_matches_jax_cpu_power(grid):
    a, b = _u8_grid() if grid == "u8" else _special_grid()
    want = np.asarray(jnp.power(a, b))
    got = port_exact.powf_glibc(torch.from_numpy(a), torch.from_numpy(b))
    assert _mismatches(got, want) == 0


@pytest.mark.parametrize("grid", ["u8", "special"])
def test_ds_pow_matches_jax_ds_pow(grid):
    a, b = _u8_grid() if grid == "u8" else _special_grid()
    want = np.asarray(jax.jit(ref_exact.ds_pow)(a, b))
    got = port_exact.ds_pow(torch.from_numpy(a), torch.from_numpy(b))
    assert _mismatches(got, want) == 0


def test_ds_pow_and_glibc_differ_only_where_glibc_misrounds():
    """The pow class: on the u8 grid the two differ by one ulp at most, on
    a few dozen points (the JAX package measured 48 on a TPU)."""
    a, b = (torch.from_numpy(x) for x in _u8_grid())
    glibc, ds = port_exact.powf_glibc(a, b), port_exact.ds_pow(a, b)
    ulps = (_bits(glibc).astype(np.int64) - _bits(ds)).__abs__()
    assert 0 < int((ulps != 0).sum()) <= 100
    assert int(ulps.max()) == 1


def test_pow_f32_routes_by_device_only():
    a, b = (torch.from_numpy(x) for x in _u8_grid())
    assert _mismatches(port_exact.pow_f32(a, b), port_exact.powf_glibc(a, b)) == 0
    with pytest.raises(port.TexProError):
        port_exact.powf_glibc(a.to("meta"), b)


def test_mix_pow_op_matches_reference():
    rng = np.random.default_rng(7)
    left = rng.random((61, 47), dtype=np.float32) * np.float32(2.0) - np.float32(0.5)
    right = rng.random((61, 47), dtype=np.float32) * np.float32(4.0) - np.float32(1.0)
    right[::5, ::3] = np.round(right[::5, ::3])  # integer exponents of negative bases
    want = jax.jit(ref_mix._binary(ref.MixType.POW))(jnp.asarray(left), jnp.asarray(right))
    got = port_mix._binary(port.MixType.POW)(torch.from_numpy(left), torch.from_numpy(right))
    assert _mismatches(got, want) == 0


def _mix_pow_graph(pkg):
    g = pkg.NodeGraph()
    base = g.add_node(pkg.Node(pkg.NodeType.InputGray("base")))
    exp = g.add_node(pkg.Node(pkg.NodeType.InputRgba("exp")))
    mix = g.add_node(pkg.Node(pkg.NodeType.Mix(pkg.MixType.POW)))
    g.connect(exp, mix, pkg.SlotId(0), pkg.SlotId(0))
    g.connect(base, mix, pkg.SlotId(0), pkg.SlotId(1))
    out = g.add_node(pkg.Node(pkg.NodeType.OutputRgba("out")))
    g.connect(mix, out, pkg.SlotId(0), pkg.SlotId(0))
    return g, int(base), int(exp), int(out)


@pytest.mark.parametrize("route", ["fused", "auto_update", "no_fuse"])
def test_mix_pow_graph_matches_reference(route):
    """Mix POW of an RGBA base by a Gray exponent (coerced rgba-wards)
    through each route of both packages."""
    rng = np.random.default_rng(3)
    gray = [rng.random((20, 24), dtype=np.float32) * np.float32(3.0)]
    rgba = [rng.random((20, 24), dtype=np.float32) for _ in range(4)]
    reads = []
    for pkg in (ref, port):
        graph, base, exp, out = _mix_pow_graph(pkg)
        kw = {"device": "cpu"} if pkg is port else {}
        tp = pkg.TextureProcessor(100_000_000, **kw)
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.auto_update = route == "auto_update"
                g.fuse_subgraphs = route == "fused"
                g.set_node_graph(graph)
                for node_id, planes in ((exp, rgba), (base, gray)):
                    if pkg is port:
                        planes = [torch.from_numpy(p) for p in planes]
                    image = (pkg.SlotImage.Gray(planes[0]) if len(planes) == 1
                             else pkg.SlotImage.Rgba(planes))
                    g.add_input_slot_data(pkg.SlotData(pkg.NodeId(node_id), pkg.SlotId(0), image))
            u8 = np.asarray(pkg.TextureProcessor.buffer_rgba(lg, pkg.NodeId(out), pkg.SlotId(0)))
            sd = lg.slot_data(pkg.NodeId(out), pkg.SlotId(0))
            reads.append((u8, [np.asarray(p.host_data()) for p in sd.image.planes]))
        finally:
            tp.shutdown_now()
    (want_u8, want), (got_u8, got) = reads
    assert np.array_equal(got_u8, want_u8)
    assert sum(_mismatches(g, w) for g, w in zip(got, want)) == 0


def _srgb_planes(kind, n_planes):
    if kind == "u8_grid":
        v = np.arange(256, dtype=np.float32) / np.float32(255)
        plane = np.ascontiguousarray(np.broadcast_to(v, (8, 256)))
        return [plane] * n_planes
    rng = np.random.default_rng(11)
    planes = []
    for _ in range(n_planes):
        p = rng.random((33, 40), dtype=np.float32) * np.float32(1.4) - np.float32(0.2)
        p.flat[::17] = np.nan
        p.flat[::29] = np.float32(0.04045)  # the branch point itself
        planes.append(p)
    return planes


@pytest.mark.parametrize("kind", ["u8_grid", "random"])
@pytest.mark.parametrize("n_planes", [1, 4], ids=["gray", "rgba"])
def test_to_u8_srgb_matches_reference(kind, n_planes):
    planes = _srgb_planes(kind, n_planes)
    want = ref.SlotImage([ref.transient_buffer.plane_from_host(p) for p in planes]).to_u8_srgb()
    got = port.SlotImage([port.PlaneBuffer(device=torch.from_numpy(p)) for p in planes]).to_u8_srgb()
    assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(want))


def test_to_u8_srgb_over_a_cpu_mesh_matches_one_device():
    from kanter_core_tpu_torch.parallel import make_mesh, shard_planes_rows

    planes = [torch.from_numpy(p) for p in _srgb_planes("random", 4)[:3]]
    planes = [torch.cat([p, p[:7]]) for p in planes] + [torch.ones((40, 40))]
    mesh = make_mesh(devices=["cpu"] * 2)
    one = port.SlotImage([port.PlaneBuffer(device=p) for p in planes]).to_u8_srgb()
    sharded = port.SlotImage([port.PlaneBuffer(device=shard_planes_rows(mesh, p))
                              for p in planes]).to_u8_srgb()
    assert np.array_equal(one, sharded)


def test_levels_gamma_class_serde_round_trip():
    """A Levels node with gamma ≠ 1 survives the port's serde byte for
    byte, as the JAX package writes it."""
    g = port.NodeGraph()
    g.add_node(port.Node(port.NodeType.Levels(0.1, 0.9, 2.2, 0.05, 0.95)))
    text = json.dumps(g.to_json())
    again = port.NodeGraph.from_json(json.loads(text))
    r = ref.NodeGraph()
    r.add_node(ref.Node(ref.NodeType.Levels(0.1, 0.9, 2.2, 0.05, 0.95)))
    assert json.dumps(again.to_json()) == text == json.dumps(r.to_json())
