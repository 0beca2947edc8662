"""Tests of the port that need a CUDA card (marker `cuda`; they skip on a
machine without one). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The CUDA kernels (blur, the JFA step ladder, the warp gather, and the
blur and warp block kernels of the mesh route) must be bit-identical to
their plain torch versions, and the PBR slice and the flagship must give
the same f32 planes and u8 exports on the card as on the CPU, and over a
four-shard mesh on the card as on one device.
"""

import numpy as np
import pytest
import torch

import kanter_core_tpu_torch as port
from kanter_core_tpu_torch.convert import planes_from_numpy
from kanter_core_tpu_torch.models import pbr_material_graph
from kanter_core_tpu_torch.ops import blur
from kanter_core_tpu_torch.parallel import make_mesh, shard_planes_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "h,w,sigma", [(256, 256, 0.8), (256, 256, 6.0), (1, 1, 6.0), (5, 300, 6.0), (97, 411, 1.5)]
)
def test_cuda_blur_bit_identical_to_plain(card, h, w, sigma):
    x = torch.from_numpy(np.random.default_rng(h + w).random((h, w), dtype=np.float32)).to(card)
    before = blur.BLUR_KERNEL.launches
    got = blur.blur_plane(x, sigma)
    assert blur.BLUR_KERNEL.launches == before + 1
    want = blur.blur_plane_plain(x, sigma)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _render(device, n=192, mesh=None):
    tp = port.TextureProcessor(10_000_000, device=device, mesh=mesh)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(pbr_material_graph())
            (inp,) = [x for x in g.node_graph.nodes
                      if x.node_type.kind == port.NodeTypeKind.INPUT_GRAY]
            (plane,) = planes_from_numpy(
                [np.random.default_rng(0).random((n, n), dtype=np.float32)], tp.device
            )
            g.add_input_slot_data(port.SlotData(inp.node_id, port.SlotId(0), port.SlotImage.Gray(plane)))
        out = {}
        for oid in lg.node_graph.output_ids():
            u8 = port.TextureProcessor.buffer_rgba(lg, oid, port.SlotId(0))
            planes = [p.host_data().copy() for p in lg.slot_data(oid, port.SlotId(0)).image.planes]
            out[int(oid)] = (u8, planes)
        return out
    finally:
        tp.shutdown_now()


def test_slice_on_card_matches_cpu(card):
    gpu, cpu = _render("cuda"), _render("cpu")
    for oid, (u8, planes) in cpu.items():
        assert np.array_equal(gpu[oid][0], u8)
        for g, c in zip(gpu[oid][1], planes):
            assert np.array_equal(g.view(np.int32), c.view(np.int32))


def _mask(h, w, density, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((h, w)) < density).astype(np.float32))


@pytest.mark.parametrize("h,w,density", [
    (256, 256, 1e-3), (256, 256, 0.2), (256, 256, 0.0), (256, 256, 1.0),
    (1, 1, 1.0), (5, 300, 0.01), (97, 411, 0.01), (300, 1, 0.05), (33, 2049, 0.001),
])
def test_cuda_jfa_bit_identical_to_plain(card, h, w, density):
    from kanter_core_tpu_torch.ops import distance

    state = distance.pack_seeds(_mask(h, w, density, h + w).to(card))
    before = distance.JFA_KERNEL.launches
    got = distance.jfa_propagate(state)
    assert distance.JFA_KERNEL.launches == before + len(distance._jfa_steps(h, w))
    want = distance.jfa_propagate_plain(state)
    assert torch.equal(got, want)


def test_cuda_jfa_tie_storm_bit_identical_to_plain(card):
    from kanter_core_tpu_torch.ops import distance

    mask = torch.zeros(128, 192)
    mask[::2, ::2] = 1.0
    mask[1::2, 1::2] = 1.0
    state = distance.pack_seeds(mask.to(card))
    assert torch.equal(distance.jfa_propagate_cuda(state), distance.jfa_propagate_plain(state))


@pytest.mark.parametrize("h,w", [(256, 256), (1, 1), (97, 411), (300, 1)])
@pytest.mark.parametrize("payload", [(37.0, 5.0), (0.0, 5.0), (90.0, 64.0), (37.0, 1000.0)])
def test_cuda_warp_bit_identical_to_plain(card, h, w, payload):
    from kanter_core_tpu_torch.ops import warp

    rng = np.random.default_rng(h * w)
    planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(card) for _ in range(4)]
    m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::11] = np.nan
    strength = torch.from_numpy(m).to(card)
    k = warp.warp_bindings(payload)["k"]
    before = warp.WARP_KERNEL.launches
    got = warp.warp_planes(planes, strength, k)
    assert warp.WARP_KERNEL.launches == before + 1
    want = warp.warp_planes_plain(planes, strength, k)
    for g, r in zip(got, want):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def _flagship(device, n=128, mesh=None):
    from kanter_core_tpu_torch.graphs import flagship_graph

    tp = port.TextureProcessor(100_000_000, device=device, mesh=mesh)
    try:
        graph, inputs, out = flagship_graph(n)
        lg = tp.new_live_graph()
        rng = np.random.default_rng(0)
        with lg.write() as g:
            g.set_node_graph(graph)
            for node in inputs:
                (plane,) = planes_from_numpy([rng.random((n, n), dtype=np.float32)], tp.device)
                image = port.SlotImage.Gray(plane)
                g.add_input_slot_data(port.SlotData(node, port.SlotId(0), image))
        u8 = port.TextureProcessor.buffer_rgba(lg, out, port.SlotId(0))
        planes = [p.host_data().copy() for p in lg.slot_data(out, port.SlotId(0)).image.planes]
        return u8, planes
    finally:
        tp.shutdown_now()


def test_flagship_on_card_matches_cpu(card):
    (gpu_u8, gpu), (cpu_u8, cpu) = _flagship("cuda"), _flagship("cpu")
    assert np.array_equal(gpu_u8, cpu_u8)
    for g, c in zip(gpu, cpu):
        assert np.array_equal(g.view(np.int32), c.view(np.int32))


@pytest.mark.parametrize("intensity", [float("inf"), float("nan")])
def test_warp_non_finite_intensity_card_vs_cpu(card, intensity):
    """A deliberate divergence, pinned: with a non-finite intensity the
    warp's NaN outputs sit at the same pixels on the card and on the CPU,
    and every other value agrees bit for bit, but a NaN's bit pattern is
    the device's own (x86 makes 0xFFC00000 of inf·0, CUDA 0x7FFFFFFF)."""
    from kanter_core_tpu_torch.ops import warp

    rng = np.random.default_rng(4)
    plane = rng.random((33, 65), dtype=np.float32)
    m = rng.random((33, 65), dtype=np.float32)
    m[0, :4] = 0.5
    k = warp.warp_bindings((37.0, intensity))["k"]
    (cpu,) = warp.warp_planes([torch.from_numpy(plane)], torch.from_numpy(m), k)
    (gpu,) = warp.warp_planes([torch.from_numpy(plane).to(card)], torch.from_numpy(m).to(card), k)
    gpu = gpu.cpu()
    assert torch.equal(torch.isnan(gpu), torch.isnan(cpu)) and torch.isnan(cpu).any()
    finite = ~torch.isnan(cpu)
    assert torch.equal(gpu[finite].view(torch.int32), cpu[finite].view(torch.int32))


@pytest.mark.parametrize("h,w,sigma,n", [
    (256, 256, 0.8, 4), (256, 256, 6.0, 4), (76, 411, 6.0, 4),
    (36, 1, 6.0, 2),  # blocks of exactly the radius, one column
])
def test_cuda_blur_block_bit_identical_to_plain(card, h, w, sigma, n):
    x = torch.from_numpy(np.random.default_rng(h + w).random((h, w), dtype=np.float32)).to(card)
    sp = shard_planes_rows(make_mesh(devices=[card] * n), x)
    r = (len(blur.gaussian_taps(sigma)) - 1) // 2
    for band, (top, bot) in zip(sp.bands, sp.ring_halos(r)):
        before = blur.BLUR_BLOCK_KERNEL.launches
        got = blur.blur_block(band, top, bot, sigma)
        assert blur.BLUR_BLOCK_KERNEL.launches == before + 1
        want = blur.blur_block_plain(band, top, bot, sigma)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    whole = torch.cat(blur.blur_plane(sp, sigma).bands)
    assert torch.equal(whole.view(torch.int32), blur.blur_plane_cuda(x, sigma).view(torch.int32))


@pytest.mark.parametrize("payload,n", [((37.0, 5.0), 4), ((90.0, 64.0), 2), ((213.0, 2.0), 4)])
def test_cuda_warp_block_bit_identical_to_plain(card, payload, n):
    from kanter_core_tpu_torch.ops import warp

    h = w = 256
    rng = np.random.default_rng(int(payload[1]))
    planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(card) for _ in range(4)]
    m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::11] = np.nan
    b = warp.warp_bindings(payload)
    mesh = make_mesh(devices=[card] * n)
    sps = [shard_planes_rows(mesh, p) for p in planes]
    ss = shard_planes_rows(mesh, torch.from_numpy(m).to(card))
    halos = [sp.ring_halos(b["halo"]) for sp in sps]
    bh = h // n
    for j in range(n):
        args = ([sp.bands[j] for sp in sps], ss.bands[j], b["k"],
                [hs[j][0] for hs in halos], [hs[j][1] for hs in halos], j * bh, h)
        before = warp.WARP_BLOCK_KERNEL.launches
        got = warp.warp_block(*args)
        assert warp.WARP_BLOCK_KERNEL.launches == before + 1
        want = warp.warp_block_plain(*args)
        for g, r in zip(got, want):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    whole = warp.warp_planes(sps, ss, b["k"], halo=b["halo"])
    dense = warp.warp_planes_cuda(planes, torch.from_numpy(m).to(card), b["k"])
    for g, r in zip(whole, dense):
        assert torch.equal(torch.cat(g.bands).view(torch.int32), r.view(torch.int32))


def test_mesh_on_card_matches_single_device(card):
    """PBR and flagship at 1024² over four shards on the card."""
    mesh = make_mesh(devices=[card] * 4)
    single, sharded = _render("cuda", 1024), _render("cuda", 1024, mesh=mesh)
    for oid, (u8, planes) in single.items():
        assert np.array_equal(sharded[oid][0], u8)
        for g, c in zip(sharded[oid][1], planes):
            assert np.array_equal(g.view(np.int32), c.view(np.int32))
    (m_u8, m_planes), (s_u8, s_planes) = _flagship("cuda", 1024, mesh), _flagship("cuda", 1024)
    assert np.array_equal(m_u8, s_u8)
    for g, c in zip(m_planes, s_planes):
        assert np.array_equal(g.view(np.int32), c.view(np.int32))


def test_mesh_across_four_cards_matches_single_device(card):
    """The same over four distinct cards (ring exchanges between cards);
    skips on a machine with fewer."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    mesh = make_mesh(4)
    single, sharded = _render("cuda", 1024), _render("cuda", 1024, mesh=mesh)
    for oid, (u8, planes) in single.items():
        assert np.array_equal(sharded[oid][0], u8)
        for g, c in zip(sharded[oid][1], planes):
            assert np.array_equal(g.view(np.int32), c.view(np.int32))
    (m_u8, m_planes), (s_u8, s_planes) = _flagship("cuda", 1024, mesh), _flagship("cuda", 1024)
    assert np.array_equal(m_u8, s_u8)
    for g, c in zip(m_planes, s_planes):
        assert np.array_equal(g.view(np.int32), c.view(np.int32))
