"""Tests of the port that need a CUDA card (marker `cuda`; they skip on a
machine without one). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The CUDA kernels (the tiled blur, the JFA far steps and fused near run, the
warp gather, and the blur and warp block kernels of the mesh route) must be bit-identical to
their plain torch versions, and the PBR slice and the flagship must give
the same f32 planes and u8 exports on the card as on the CPU, and over a
four-shard mesh on the card as on one device. The card's pow (`ds_pow`) and
the sRGB export must match the CPU's, and a template with a Levels of
gamma ≠ 1 must differ from the CPU only within the pow class.
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


@pytest.mark.parametrize("h,w,sigma", [
    (256, 256, 0.8), (256, 256, 6.0), (1, 1, 6.0), (5, 300, 6.0), (97, 411, 1.5),
    # one below, at and one above a tile edge (64 rows, 128 columns)
    (63, 127, 1.2), (64, 128, 1.2), (65, 129, 1.2), (63, 127, 6.0), (64, 128, 6.0), (65, 129, 6.0),
    # widths without 16-byte alignment; 37 taps on 5 rows; a radius above the tile's height
    (200, 1, 6.0), (200, 3, 0.8), (200, 411, 4.0), (5, 4096, 6.0), (8, 300, 6.0), (40, 300, 6.0),
    # the widest tiled radius (63 taps) and the two-pass form above it
    (200, 333, 10.3), (31, 31, 10.3), (200, 333, 10.4), (40, 50, 30.0),
])
def test_cuda_blur_bit_identical_to_plain(card, h, w, sigma):
    x = torch.from_numpy(np.random.default_rng(h + w).random((h, w), dtype=np.float32)).to(card)
    before = blur.BLUR_KERNEL.launches
    got = blur.blur_plane(x, sigma)
    assert blur.BLUR_KERNEL.launches == before + 1
    want = blur.blur_plane_plain(x, sigma)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("sigma", [0.8, 6.0])
def test_cuda_blur_takes_rows_off_the_16_byte_boundary(card, sigma):
    """A width that is a multiple of 4 on storage that starts 4 bytes past a
    16-byte boundary: the kernel must fall back to 4-byte copies, for the
    plane and for a block with such halos."""
    h, w = 96, 128
    flat = torch.from_numpy(np.random.default_rng(7).random(h * w + 1, dtype=np.float32)).to(card)
    x = flat[1:].view(h, w)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = blur.blur_plane_cuda(x, sigma)
    assert torch.equal(got.view(torch.int32), blur.blur_plane_plain(x, sigma).view(torch.int32))
    r = (len(blur.gaussian_taps(sigma)) - 1) // 2
    views = (x[32:64], x[32 - r:32], x[64:64 + r])
    got = blur.blur_block_cuda(*views, sigma)
    assert torch.equal(got.view(torch.int32),
                       blur.blur_block_plain(*views, sigma).view(torch.int32))


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
    # lattices of odd length; planes smaller than the fused halo; k > H; a
    # plane past the f32 metric (the i32 one)
    (96, 160, 0.01), (10, 12, 0.1), (10, 12, 0.0), (3, 7, 1.0), (16, 16, 0.05), (5, 4096, 0.01),
    (70, 6000, 0.001), (6000, 5800, 0.0001),
])
def test_cuda_jfa_bit_identical_to_plain(card, h, w, density):
    from kanter_core_tpu_torch.ops import distance

    state = distance.pack_seeds(_mask(h, w, density, h + w).to(card))
    before = (distance.JFA_KERNEL.launches, distance.JFA_NEAR_KERNEL.launches)
    got = distance.jfa_propagate(state)
    plan = distance.jfa_launch_plan(h, w)
    far = sum(1 for launch in plan if launch.entry == "step")
    assert (distance.JFA_KERNEL.launches, distance.JFA_NEAR_KERNEL.launches) == (
        before[0] + far, before[1] + 1)
    assert [k for launch in plan for k in launch.steps] == distance._jfa_steps(h, w)
    want = distance.jfa_propagate_plain(state)
    assert torch.equal(got, want)


def test_cuda_jfa_tie_storm_bit_identical_to_plain(card):
    from kanter_core_tpu_torch.ops import distance

    mask = torch.zeros(128, 192)
    mask[::2, ::2] = 1.0
    mask[1::2, 1::2] = 1.0
    state = distance.pack_seeds(mask.to(card))
    assert torch.equal(distance.jfa_propagate_cuda(state), distance.jfa_propagate_plain(state))


@pytest.mark.parametrize("th,tw", [(16, 16), (33, 70), (1, 2), (128, 128)])
def test_cuda_jfa_near_run_on_any_tile_equals_separate_steps(card, th, tw):
    """The fused near entry alone, on tiles other than the planned one."""
    from kanter_core_tpu_torch.ops import distance

    state = distance.pack_seeds(_mask(97, 411, 0.02, 5).to(card))
    steps = (8, 4, 2, 1, 1)
    got = distance.jfa_run_launches(state, [distance.JfaLaunch("near", steps, th, tw)])
    want = state
    for k in steps:
        want = distance.jfa_step_plain(want, k)
    assert torch.equal(got, want)


def test_cuda_jfa_never_writes_the_callers_state(card):
    from kanter_core_tpu_torch.ops import distance

    state = distance.pack_seeds(_mask(256, 256, 0.01, 1).to(card))
    keep = state.clone()
    distance.jfa_propagate_cuda(state)
    torch.cuda.synchronize()
    assert torch.equal(state, keep)


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
    (260, 129, 1.2, 4), (256, 128, 6.0, 4), (252, 3, 6.0, 4),  # around a tile edge; 3 columns
    (160, 50, 12.0, 4),  # 73 taps: the two-pass form
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
    # halos that are views into the plane, off every 16-byte boundary when
    # the width is odd
    bh = h // n
    for j in range(1, n - 1):
        views = (x[j * bh:(j + 1) * bh], x[j * bh - r:j * bh], x[(j + 1) * bh:(j + 1) * bh + r])
        got = blur.blur_block_cuda(*views, sigma)
        assert torch.equal(got.view(torch.int32),
                           blur.blur_block_plain(*views, sigma).view(torch.int32))


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
        got = warp.warp_block_cuda(*args)
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


def _warp_block_case(card, h, w, n, j, payload, halo=None):
    """Shard `j` of `n` of an RGBA `h × w` canvas on the card, with ring
    halos of `halo` rows (default `warp_halo`) and a strength map holding
    NaN and values outside [0, 1]: the arguments of `warp_block_cuda`."""
    from kanter_core_tpu_torch.ops import warp

    rng = np.random.default_rng(h * w + j)
    planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(card) for _ in range(4)]
    m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::7] = np.nan
    b = warp.warp_bindings(payload)
    halo = b["halo"] if halo is None else halo
    bh = h // n
    rows = torch.arange(j * bh, (j + 1) * bh, device=card)
    top = (rows[0] - halo + torch.arange(halo, device=card)) % h
    bot = (rows[-1] + 1 + torch.arange(halo, device=card)) % h
    return ([p[rows] for p in planes], torch.from_numpy(m).to(card)[rows], b["k"],
            [p[top] for p in planes], [p[bot] for p in planes], j * bh, h)


def _every_block_launch(warp, args):
    """The planned launch of a block, and others the kernel takes for it:
    the more general index modes, other tiles, strided pixels with scalar
    accesses, and adjacent ones with 8-byte accesses where the rows allow."""
    block_h, w = args[1].shape
    halo = args[3][0].shape[0]
    kx, ky = (float(c) for c in np.asarray(args[2], np.float32))
    aligned = args[1].data_ptr() % 8 == 0
    plan = warp.warp_block_plan(kx, ky, block_h, w, args[6], halo, aligned)
    launches = {plan}
    for mode in range(plan.mode, warp.WARP_GENERAL + 1):
        for th, tw in ((8, 64), (2, 256), (1, 64), (16, 32)):
            launches.add(warp.WarpBlockPlan(mode, False, th, tw))
            if aligned and w % 2 == 0:
                launches.add(warp.WarpBlockPlan(mode, True, th, tw))
    return plan, launches


# (h, w, shards, shard, payload, halo): the first and last shard, a halo of
# exactly ceil(|ky|/2) + 2, blocks as tall as the halo, widths 1, 3, 5 and
# 411, the column gate failing (256×8 at intensity 20, 0°), a window taller
# than the plane (the row gate), and the main path's block
_WARP_BLOCK_CASES = [
    (64, 128, 4, 0, (37.0, 5.0), None), (64, 128, 4, 3, (37.0, 9.0), None),
    (96, 128, 4, 0, (213.0, 5.0), 4), (32, 64, 4, 0, (37.0, 5.0), None),
    (64, 64, 8, 7, (37.0, 5.0), None), (64, 1, 4, 1, (37.0, 5.0), None),
    (64, 3, 4, 3, (90.0, 5.0), None), (64, 5, 4, 0, (37.0, 5.0), None),
    (96, 411, 4, 3, (37.0, 9.0), None), (256, 8, 4, 0, (0.0, 20.0), None),
    (256, 8, 4, 3, (0.0, 20.0), None), (24, 32, 2, 1, (37.0, 5.0), None),
    (4096, 4096, 4, 3, (37.0, 5.0), None), (1024, 1024, 4, 0, (90.0, 64.0), None),
]


@pytest.mark.parametrize("h,w,n,j,payload,halo", _WARP_BLOCK_CASES)
def test_cuda_warp_block_every_launch_bit_identical(card, h, w, n, j, payload, halo):
    """Every launch of the block kernel -- both column paths, the general
    row path, several tiles, scalar and 8-byte accesses -- against the
    plain version, bit for bit."""
    from kanter_core_tpu_torch.ops import warp

    args = _warp_block_case(card, h, w, n, j, payload, halo)
    want = warp.warp_block_plain(*args)
    plan, launches = _every_block_launch(warp, args)
    planned = warp.warp_block_plan
    try:
        for launch in launches:
            warp.warp_block_plan = lambda *a, launch=launch: launch
            got = warp.warp_block_cuda(*args)
            for g, r in zip(got, want):
                assert torch.equal(g.view(torch.int32), r.view(torch.int32)), launch
    finally:
        warp.warp_block_plan = planned


@pytest.mark.parametrize("w", [128, 411])
def test_cuda_warp_block_halo_views_off_the_16_byte_boundary(card, w):
    """Blocks and halos that are views into a plane: rows of 411 floats, or
    of 128 on storage that starts 4 bytes past a 16-byte boundary, with a
    strength block on the same storage: the launch with strided pixels and
    scalar accesses, bit-identical to plain."""
    from kanter_core_tpu_torch.ops import warp

    h, n = 96, 4
    flat = torch.from_numpy(np.random.default_rng(w).random(4 * h * w + 1, dtype=np.float32))
    x = flat.to(card)[1:].view(4, h, w)
    flat_m = np.random.default_rng(1).random(h * w + 1, dtype=np.float32)
    m = torch.from_numpy(flat_m).to(card)[1:].view(h, w)
    b = warp.warp_bindings((37.0, 5.0))
    halo, bh = b["halo"], h // n
    for j in range(1, n - 1):
        args = ([p[j * bh:(j + 1) * bh] for p in x], m[j * bh:(j + 1) * bh], b["k"],
                [p[j * bh - halo:j * bh] for p in x], [p[(j + 1) * bh:(j + 1) * bh + halo] for p in x],
                j * bh, h)
        assert args[1].data_ptr() % 8 != 0 and args[3][0].data_ptr() % 16 != 0
        kx, ky = (float(c) for c in b["k"])
        assert not warp.warp_block_plan(kx, ky, bh, w, h, halo, False).vec
        got = warp.warp_block_cuda(*args)
        for g, r in zip(got, warp.warp_block_plain(*args)):
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def test_cuda_warp_block_refuses_mixed_and_cpu_tensors(card):
    from kanter_core_tpu_torch.ops import warp

    planes, strength, k, tops, bots, row_origin, h = _warp_block_case(
        card, 64, 128, 4, 0, (37.0, 5.0))
    with pytest.raises(port.TexProError):
        warp.warp_block_cuda([*planes[:3], planes[3].cpu()], strength, k, tops, bots,
                             row_origin, h)
    with pytest.raises(port.TexProError):
        warp.warp_block_cuda(planes, strength, k, [tops[0], tops[1].cpu(), *tops[2:]], bots,
                             row_origin, h)


def _kernel_node_graph(kind):
    """Inputs → one kernel node (Blur of RGBA, Distance of a mask, Warp of
    RGBA by a gray strength) → Output."""
    g = port.NodeGraph()
    rgba = g.add_node(port.Node(port.NodeType.InputRgba("image")))
    gray = g.add_node(port.Node(port.NodeType.InputGray("gray")))
    node_type = {
        "blur": lambda: port.NodeType.Blur(6.0),
        "distance": lambda: port.NodeType.Distance(24.0),
        "warp": lambda: port.NodeType.Warp(37.0, 9.0),
    }[kind]()
    node = g.add_node(port.Node(node_type))
    g.connect(gray if kind == "distance" else rgba, node, port.SlotId(0), port.SlotId(0))
    if kind == "warp":
        g.connect(gray, node, port.SlotId(0), port.SlotId(1))
    out = g.add_node(port.Node(port.NodeType.OutputGray("out") if kind == "distance"
                               else port.NodeType.OutputRgba("out")))
    g.connect(node, out, port.SlotId(0), port.SlotId(0))
    return g, rgba, gray, out


def _read_kernel_node(device, kind, route, n=256):
    from kanter_core_tpu_torch.ops import distance, warp

    graph, rgba, gray, out = _kernel_node_graph(kind)
    rng = np.random.default_rng(5)
    planes = planes_from_numpy([rng.random((n, n), dtype=np.float32) for _ in range(4)], device)
    mask = planes_from_numpy([(rng.random((n, n)) < 0.002).astype(np.float32)], device)[0]
    tp = port.TextureProcessor(10_000_000, device=device)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(graph)
            g.auto_update = route == "auto_update"
            g.fuse_subgraphs = route == "fused"
            g.add_input_slot_data(port.SlotData(rgba, port.SlotId(0), port.SlotImage.Rgba(planes)))
            g.add_input_slot_data(port.SlotData(gray, port.SlotId(0), port.SlotImage.Gray(mask)))
        kernels = (blur.BLUR_KERNEL, distance.JFA_KERNEL, distance.JFA_NEAR_KERNEL,
                   warp.WARP_KERNEL)
        before = [k.launches for k in kernels]
        u8 = port.TextureProcessor.buffer_rgba(lg, out, port.SlotId(0))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        image = lg.slot_data(out, port.SlotId(0)).image
        return u8, [p.host_data().copy() for p in image.planes], launched
    finally:
        tp.shutdown_now()


@pytest.mark.parametrize("route", ["auto_update", "no_fuse"])
@pytest.mark.parametrize("kind", ["blur", "distance", "warp"])
def test_per_node_kernel_node_on_card_matches_fused(card, kind, route):
    """One Blur, Distance or Warp node on the per-node route: the same u8
    and f32 planes as the fused route on the card and as the CPU, and the
    kernel launched from the worker thread as often as the fused route
    launches it (one blur per plane, one JFA ladder, one warp)."""
    from kanter_core_tpu_torch.ops import distance

    got_u8, got, launched = _read_kernel_node(card, kind, route)
    want_u8, want, fused_launched = _read_kernel_node(card, kind, "fused")
    cpu_u8, cpu, _ = _read_kernel_node("cpu", kind, route)
    for a, b in ((got, want), (got, cpu)):
        assert all(np.array_equal(x.view(np.int32), y.view(np.int32)) for x, y in zip(a, b))
    assert np.array_equal(got_u8, want_u8) and np.array_equal(got_u8, cpu_u8)
    plan = distance.jfa_launch_plan(256, 256)
    ladder = [sum(1 for x in plan if x.entry == e) for e in ("step", "near")]
    want_launches = {"blur": [4, 0, 0, 0], "distance": [0, *ladder, 0],
                     "warp": [0, 0, 0, 1]}[kind]
    assert launched == fused_launched == want_launches


# --- the pow of the card, and the templates -----------------------------------


def _u8_grid(device):
    i = torch.arange(256, dtype=torch.float32)
    a = (i[:, None] / torch.full((256, 1), 255.0)).expand(256, 256).contiguous()
    b = (4.0 * i[None, :] / torch.full((1, 256), 255.0)).expand(256, 256).contiguous()
    return a.to(device), b.to(device)


def test_ds_pow_card_matches_cpu_on_the_u8_grid(card):
    """The card's pow (`ds_pow` in plain torch) gives the bits of the same
    function on the CPU, over all 65,536 u8-grid pairs and on special
    values (a NaN at the same pixels, in the device's own bits: x86 makes
    0xFFC00000, CUDA 0x7FFFFFFF)."""
    from kanter_core_tpu_torch.ops import exact_math

    a, b = _u8_grid("cpu")
    special = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, 0.5, 3.0, -3.5, float("inf"),
                            float("-inf"), float("nan"), 1e-30, 1e30, 100.5, -100.0])
    sa, sb = torch.meshgrid(special, special, indexing="ij")
    for x, y in ((a, b), (sa.contiguous(), sb.contiguous())):
        got = exact_math.pow_f32(x.to(card), y.to(card)).cpu()
        want = exact_math.ds_pow(x, y)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("planes", [1, 4], ids=["gray", "rgba"])
def test_srgb_export_card_matches_cpu(card, planes):
    """`to_u8_srgb` on the card (ds_pow) and on the CPU (glibc powf) give
    the same u8 over the u8 grid and a random plane: the pow class is
    absorbed by the u8 quantization."""
    grid = (torch.arange(256, dtype=torch.float32) / torch.full((256,), 255.0)).expand(8, 256)
    rng = np.random.default_rng(12)
    noise = torch.from_numpy(rng.random((300, 256), dtype=np.float32) * np.float32(1.2)
                             - np.float32(0.1))
    for x in (grid.contiguous(), noise):
        bufs = lambda d: [port.PlaneBuffer(device=x.to(d))] * planes  # noqa: E731
        assert np.array_equal(port.SlotImage(bufs(card)).to_u8_srgb(),
                              port.SlotImage(bufs("cpu")).to_u8_srgb())


def test_template_card_vs_cpu_under_the_pow_rule(card):
    """The wood template (a Levels of gamma 1.6, then 2.0) at 128² on the
    card and on the CPU: every plane with no pow upstream exact, the Levels
    different only where glibc `powf` and `ds_pow` differ for the CPU's `t`
    (`chip_smoke.pow_class_compare`)."""
    import chip_smoke

    gpu = chip_smoke.drive_template("wood", "cuda", 128, capture=True)
    cpu = chip_smoke.drive_template("wood", "cpu", 128, capture=True)
    last = lambda s: {n: u8 for step, n, _, u8 in s.results if step == s.results[-1][0]}  # noqa: E731
    report = chip_smoke.pow_class_compare("wood", cpu.graph, cpu.nodes, gpu.nodes,
                                          last(cpu), last(gpu))
    assert report["exact_planes"] > 0 and len(report["pow_nodes"]) == 1


def test_transform_gathers_once_per_evaluation_on_a_two_shard_card_mesh(card):
    """Wood over two shards on the card: its Transform gathers its gray
    input once per evaluation (render and rotation edit), and every read is
    bit-identical to one card."""
    import chip_smoke

    one = chip_smoke.drive_template("wood", "cuda", 128)
    mesh = make_mesh(devices=[card] * 2)
    two = chip_smoke.drive_template("wood", "cuda", 128, mesh=mesh)
    chip_smoke.compare_runs("wood", two.results, one.results, "mesh vs single device")
    transforms = [m["gathers"]["transform"] for m in two.mesh_counts]
    assert transforms == [e["transform"] for e in one.expected] == [1, 1, 2]


# --- the batched launches ---------------------------------------------------


def _batch_on(card, b, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((b, h, w), dtype=np.float32)).to(card)


def _int_view(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("b,h,w,sigma", [
    (1, 256, 256, 6.0), (3, 97, 411, 1.5), (3, 5, 300, 6.0), (5, 63, 127, 1.2),
    (2, 200, 3, 0.8), (3, 40, 50, 12.0), (2, 200, 333, 10.4),
])
def test_cuda_blur_batch_is_one_launch_bit_identical_to_plain(card, b, h, w, sigma):
    x = _batch_on(card, b, h, w, b + h + w)
    before = (blur.BLUR_KERNEL.launches, blur.BLUR_KERNEL.batched_launches)
    got = blur.blur_plane(x, sigma)
    assert (blur.BLUR_KERNEL.launches, blur.BLUR_KERNEL.batched_launches) == (
        before[0] + 1, before[1] + (b > 1))
    assert torch.equal(_int_view(got), _int_view(blur.blur_plane_plain(x, sigma)))
    for i in (0, b - 1):  # each canvas as the single-plane entry gives it
        assert torch.equal(_int_view(got[i]), _int_view(blur.blur_plane_cuda(x[i], sigma)))


@pytest.mark.parametrize("b,h,w,density", [
    (1, 256, 256, 1e-3), (3, 97, 411, 0.01), (3, 96, 160, 0.01), (5, 10, 12, 0.1),
    (2, 33, 2049, 0.001),
])
def test_cuda_jfa_batch_is_one_ladder_bit_identical_to_plain(card, b, h, w, density):
    from kanter_core_tpu_torch.ops import distance

    rng = np.random.default_rng(h * w + b)
    mask = torch.from_numpy((rng.random((b, h, w)) < density).astype(np.float32)).to(card)
    state = distance.pack_seeds(mask)
    kernels = (distance.JFA_KERNEL, distance.JFA_NEAR_KERNEL)
    before = [(k.launches, k.batched_launches) for k in kernels]
    got = distance.jfa_propagate(state)
    far = sum(1 for launch in distance.jfa_launch_plan(h, w) if launch.entry == "step")
    assert [(k.launches, k.batched_launches) for k in kernels] == [
        (before[0][0] + far, before[0][1] + far * (b > 1)), (before[1][0] + 1, before[1][1] + (b > 1))]
    assert torch.equal(got, distance.jfa_propagate_plain(state))
    for i in (0, b - 1):
        assert torch.equal(got[i], distance.jfa_propagate_cuda(state[i].contiguous()))


@pytest.mark.parametrize("batched", ["planes", "strength", "both", "one"])
@pytest.mark.parametrize("h,w,payload", [(256, 256, (37.0, 5.0)), (97, 411, (90.0, 64.0)),
                                         (1, 1, (37.0, 5.0)), (300, 1, (0.0, 5.0))])
def test_cuda_warp_batch_is_one_launch_bit_identical_to_plain(card, batched, h, w, payload):
    """Batched planes by a shared strength map (a batch stride of 0 for the
    map), a batched map over shared planes, both batched, and a batch of
    one: one launch, bit-identical to the plain version."""
    from kanter_core_tpu_torch.ops import warp

    b = 1 if batched == "one" else 3
    planes = [_batch_on(card, b, h, w, i) for i in range(4)]
    m = np.random.default_rng(9).random((b, h, w), dtype=np.float32) * np.float32(1.6) - 0.3
    m.flat[::11] = np.nan
    strength = torch.from_numpy(m).to(card)
    if batched == "planes":
        strength = strength[0].contiguous()
    elif batched == "strength":
        planes = [p[0].contiguous() for p in planes]
    k = warp.warp_bindings(payload)["k"]
    before = (warp.WARP_KERNEL.launches, warp.WARP_KERNEL.batched_launches)
    got = warp.warp_planes(planes, strength, k)
    assert (warp.WARP_KERNEL.launches, warp.WARP_KERNEL.batched_launches) == (
        before[0] + 1, before[1] + (b > 1))
    want = warp.warp_planes_plain(planes, strength, k)
    for g, r in zip(got, want):
        assert g.shape == (b, h, w) and torch.equal(_int_view(g), _int_view(r))
    if batched == "one":
        single = warp.warp_planes_cuda([p[0].contiguous() for p in planes],
                                       strength[0].contiguous(), k)
        for g, s in zip(got, single):
            assert torch.equal(_int_view(g[0]), _int_view(s))


def _batched_kernel_graph(device, mesh=None, b=4, h=96, w=80):
    from kanter_core_tpu_torch.parallel import BatchedGraph

    graph = port.NodeGraph()
    height = graph.add_node(port.Node(port.NodeType.InputGray("height")))
    blur_n = graph.add_node(port.Node(port.NodeType.Blur(6.0)))
    dist = graph.add_node(port.Node(port.NodeType.Distance(512.0)))
    warp_n = graph.add_node(port.Node(port.NodeType.Warp(37.0, 5.0)))
    out = graph.add_node(port.Node(port.NodeType.OutputGray("out")))
    graph.connect(height, blur_n, port.SlotId(0), port.SlotId(0))
    graph.connect(height, dist, port.SlotId(0), port.SlotId(0))
    graph.connect(dist, warp_n, port.SlotId(0), port.SlotId(0))
    graph.connect(blur_n, warp_n, port.SlotId(0), port.SlotId(1))
    graph.connect(warp_n, out, port.SlotId(0), port.SlotId(0))
    rng = np.random.default_rng(3)
    x = ((rng.random((b, h, w)) < 0.01) + rng.random((b, h, w)) * 0.4).astype(np.float32)
    key = f"input_{int(height)}"
    bg = BatchedGraph(graph, {key}, include_u8=False, device=device, mesh=mesh)
    arg = bg.shard_batch_arg(x) if mesh is not None else x
    (plane,) = bg(**{key: (arg,)})[(out, port.SlotId(0))]
    return plane.gather("cpu") if mesh is not None else plane.cpu()


def test_batched_graph_on_card_matches_cpu_and_a_batch_mesh(card):
    from kanter_core_tpu_torch.parallel import make_mesh as mk

    on_card = _batched_kernel_graph("cuda")
    assert torch.equal(_int_view(on_card), _int_view(_batched_kernel_graph("cpu")))
    mesh = mk(devices=["cuda:0"] * 2, axes=("batch",))
    assert torch.equal(_int_view(on_card), _int_view(_batched_kernel_graph(None, mesh)))
