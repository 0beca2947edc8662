"""The port's ops against the JAX package's, on the CPU.

Seeded numpy planes go through the JAX function (jitted, as the fused
compiler runs it) and through the port's torch function; the f32 planes
must be bit-identical (int32 view) and u8 exports identical. Covered: every
ported Mix mode, the resampler (five filters; up, down and 1×1→N),
HeightToNormal, Separate/Combine, rgba→gray coercion and the u8 export.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kanter_core_tpu as ref
import kanter_core_tpu_torch as port
from kanter_core_tpu.ops import inout as ref_inout
from kanter_core_tpu.ops import mix as ref_mix
from kanter_core_tpu.ops import resize as ref_resize
from kanter_core_tpu.ops import separate_combine as ref_sc
from kanter_core_tpu.ops.height_to_normal import h2n_traceable
from kanter_core_tpu_torch.ops import inout as port_inout
from kanter_core_tpu_torch.ops import mix as port_mix
from kanter_core_tpu_torch.ops import resize as port_resize
from kanter_core_tpu_torch.ops import separate_combine as port_sc
from kanter_core_tpu_torch.ops.common import Placement
from kanter_core_tpu_torch.ops.height_to_normal import h2n_planes

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_bits_equal(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


def _operands(seed, shape=(61, 47)):
    rng = np.random.default_rng(seed)
    left = rng.random(shape, dtype=np.float32)
    right = rng.random(shape, dtype=np.float32)
    # out-of-range and special values: negatives, >1, zeros (÷0 → inf/NaN);
    # no operand pair whose product or minimum is a signed zero (see
    # test_mix_signed_zero_divergence)
    left[0, :8] = [-1.5, 2.0, 0.0, 0.5, 3.25, 1.0, 0.5, 1.0]
    right[0, :8] = [0.25, 0.0, 0.0, -2.0, 1e-30, 0.0, 0.5, 7.0]
    return left, right


PORTED_MODES = [m for m in ref.MixType if m != ref.MixType.POW]


@pytest.mark.parametrize("mode", PORTED_MODES, ids=lambda m: m.value)
def test_mix_mode_matches_reference(mode):
    left, right = _operands(seed=len(mode.value))
    want = jax.jit(ref_mix._binary(mode))(jnp.asarray(left), jnp.asarray(right))
    got = port_mix._binary(port.MixType(mode.value))(
        torch.from_numpy(left), torch.from_numpy(right)
    )
    _assert_bits_equal(got, want)


def test_mix_signed_zero_divergence():
    """A deliberate divergence, pinned: the JAX package's CPU multiply
    (`exact_math.nc_mul`, its documented quirk) returns +0.0 for a −0.0
    product, where its TPU path and the Rust reference keep −0.0; the port
    keeps −0.0 on every device. Darken/Lighten of (−0.0, +0.0) may pick
    either zero (IEEE minNum/maxNum leave it open): XLA:CPU and torch pick
    differently. Every u8 export maps both zeros to 0."""
    left = torch.tensor([0.0, -0.0])
    right = torch.tensor([-2.0, 0.0])
    product = port_mix._binary(port.MixType.MULTIPLY)(left, right)
    assert torch.signbit(product).tolist() == [True, True]
    want = jax.jit(ref_mix._binary(ref.MixType.MULTIPLY))(
        jnp.asarray(left.numpy()), jnp.asarray(right.numpy())
    )
    assert np.signbit(np.asarray(want)).tolist() == [False, False]
    assert np.array_equal(np.asarray(want), product.numpy())  # equal as values


@pytest.mark.parametrize("filt", list(ref.ResizeFilter), ids=lambda f: f.value)
@pytest.mark.parametrize(
    "in_hw,out_hw", [((37, 23), (64, 50)), ((100, 90), (31, 47)), ((1, 1), (32, 16))],
    ids=["up", "down", "1x1-to-N"],
)
def test_resample_matches_reference(filt, in_hw, out_hw):
    plane = np.random.default_rng(in_hw[0]).random(in_hw, dtype=np.float32)
    plane.flat[::7] *= np.float32(1.5)  # values above 1 exercise the per-pass clamp
    size = ref.Size(out_hw[1], out_hw[0])
    want = jax.jit(lambda p: ref_resize.resample_plane(p, size, filt))(jnp.asarray(plane))
    got = port_resize.resample_plane(
        torch.from_numpy(plane), port.Size(size.width, size.height),
        port.ResizeFilter(filt.value),
    )
    _assert_bits_equal(got, want)


def test_resample_weights_and_policies_are_the_reference_code():
    for args in ((13, 40, "Lanczos3"), (90, 31, "CatmullRom"), (1, 7, "Gaussian")):
        lw, ww = ref_resize.resample_weights(args[0], args[1], ref.ResizeFilter(args[2]))
        lg, wg = port_resize.resample_weights(args[0], args[1], port.ResizeFilter(args[2]))
        assert np.array_equal(lw, lg) and _bits(ww).tolist() == _bits(wg).tolist()


@pytest.mark.parametrize("h,w", [(64, 64), (97, 411), (1, 1), (1, 9), (9, 1)])
def test_height_to_normal_matches_reference(h, w):
    height = np.random.default_rng(h * w).random((h, w), dtype=np.float32)
    want = jax.jit(h2n_traceable)(jnp.asarray(height))
    got = h2n_planes(torch.from_numpy(height))
    for g, r in zip(got, want):
        _assert_bits_equal(g, r)


def _slot_data(pkg, node_id, slot, planes):
    if pkg is port:
        planes = [torch.from_numpy(p) for p in planes]
    image = pkg.SlotImage.Gray(planes[0]) if len(planes) == 1 else pkg.SlotImage.Rgba(planes)
    return pkg.SlotData(pkg.NodeId(node_id), pkg.SlotId(slot), image)


def _place(pkg) -> tuple:
    """The port's per-node ops take the processor's placement; the JAX
    package's none."""
    return (Placement("cpu"),) if pkg is port else ()


def _host_planes(slot_datas):
    return [[np.asarray(p.host_data()) for p in sd.image.planes] for sd in slot_datas]


def test_separate_matches_reference():
    planes = [np.random.default_rng(i).random((5, 7), dtype=np.float32) for i in range(4)]
    outs = {}
    for pkg, sc in ((ref, ref_sc), (port, port_sc)):
        node = pkg.Node(pkg.NodeType.SeparateRgba(), pkg.NodeId(9))
        outs[pkg] = sc.process_separate([_slot_data(pkg, 1, 0, planes)], node, *_place(pkg))
        # aliasing: each output plane IS one of the input's planes
        assert len({id(sd.image.planes[0]) for sd in outs[pkg]}) == 4
    assert [int(sd.slot_id) for sd in outs[port]] == [int(sd.slot_id) for sd in outs[ref]]
    for g, r in zip(_host_planes(outs[port]), _host_planes(outs[ref])):
        _assert_bits_equal(g[0], r[0])


@pytest.mark.parametrize("connected", [(0, 3), (1,), (0, 1, 2, 3), ()], ids=str)
def test_combine_matches_reference(connected):
    rng = np.random.default_rng(len(connected))
    planes = {slot: rng.random((6, 4), dtype=np.float32) for slot in connected}
    outs = {}
    for pkg, sc in ((ref, ref_sc), (port, port_sc)):
        node = pkg.Node(pkg.NodeType.CombineRgba(), pkg.NodeId(9))
        inputs = [_slot_data(pkg, 1, slot, [p]) for slot, p in planes.items()]
        outs[pkg] = sc.process_combine(inputs, node, *_place(pkg))
    for g, r in zip(_host_planes(outs[port])[0], _host_planes(outs[ref])[0]):
        _assert_bits_equal(g, r)


@pytest.mark.parametrize("kind", ["OutputGray", "OutputRgba"])
@pytest.mark.parametrize("connected", [True, False])
def test_output_matches_reference(kind, connected):
    planes = [np.random.default_rng(2).random((3, 5), dtype=np.float32)]
    if kind == "OutputRgba":
        planes = planes * 4
    outs = {}
    for pkg, inout in ((ref, ref_inout), (port, port_inout)):
        node = pkg.Node(getattr(pkg.NodeType, kind)("out"), pkg.NodeId(4))
        inputs = [_slot_data(pkg, 1, 0, planes)] if connected else []
        outs[pkg] = inout.process_output(inputs, node, *_place(pkg))
        assert [(int(sd.node_id), int(sd.slot_id)) for sd in outs[pkg]] == [(4, 0)]
    for g, r in zip(_host_planes(outs[port])[0], _host_planes(outs[ref])[0]):
        _assert_bits_equal(g, r)


def _export_planes(seed, shape=(9, 13)):
    rng = np.random.default_rng(seed)
    planes = [(rng.random(shape, dtype=np.float32) * 1.4 - 0.2).astype(np.float32)
              for _ in range(4)]
    planes[0][0, :6] = [np.nan, np.inf, -np.inf, -0.0, 1.0, 0.99999994]
    planes[1][0, :3] = [np.float32(1 / 255), np.float32(254.5 / 255), np.nan]
    return planes


@pytest.mark.parametrize("rgba", [False, True], ids=["gray", "rgba"])
def test_to_u8_matches_reference(rgba):
    planes = _export_planes(seed=int(rgba))
    if not rgba:
        planes = planes[:1]
    images = {
        ref: (ref.SlotImage.Rgba if rgba else ref.SlotImage.Gray)(
            [jnp.asarray(p) for p in planes] if rgba else jnp.asarray(planes[0])
        ),
        port: (port.SlotImage.Rgba if rgba else port.SlotImage.Gray)(
            [torch.from_numpy(p) for p in planes] if rgba else torch.from_numpy(planes[0])
        ),
    }
    want = np.asarray(images[ref].to_u8())
    got = images[port].to_u8()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_to_u8_of_spilled_planes_matches_reference():
    """Planes off the device export from the host copy, identically."""
    planes = _export_planes(seed=5)
    want = np.asarray(ref.SlotImage.Rgba([jnp.asarray(p) for p in planes]).to_u8())
    image = port.SlotImage.Rgba([port.PlaneBuffer(host=p) for p in planes])
    assert all(p.tier == port.Tier.HOST for p in image.planes)
    assert np.array_equal(image.to_u8(), want)


def test_rgba_to_gray_coercion_matches_reference():
    planes = _export_planes(seed=7)
    want = ref.SlotImage.Rgba([jnp.asarray(p) for p in planes]).as_type(False)
    got = port.SlotImage.Rgba([torch.from_numpy(p) for p in planes]).as_type(False)
    _assert_bits_equal(got.planes[0].host_data(), want.planes[0].host_data())


def test_plane_tiers_round_trip_through_storage():
    """DEVICE → HOST → STORAGE (salted-hash spill file) → DEVICE keeps the
    bits, and the fault-in returns the plane to its home device."""
    plane = np.random.default_rng(3).random((33, 17), dtype=np.float32)
    buf = port.PlaneBuffer(device=torch.from_numpy(plane.copy()))
    assert buf.evict_to_host() and buf.tier == port.Tier.HOST
    assert buf.spill_to_storage() and buf.tier == port.Tier.STORAGE
    back = buf.data()
    assert buf.tier == port.Tier.DEVICE and back.device == torch.device("cpu")
    _assert_bits_equal(back, plane)
