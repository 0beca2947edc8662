"""The port's Warp against the JAX package's, on the CPU.

On CPU tensors the port's `warp_planes` runs its plain torch gather
(`warp_planes_plain`); it must be bit-identical (int32 view) to the JAX
package's `warp_planes` through its gather form and, at kernel-viable
shapes, through its Pallas staircase kernel in interpret mode (as
`tests/test_pallas_warp.py` runs it). The CUDA kernel itself is compared
with the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import math

import jax
import numpy as np
import pytest
import torch

from kanter_core_tpu.ops import warp as ref_warp
from kanter_core_tpu_torch import compiler as port_compiler
from kanter_core_tpu_torch.errors import TexProError
from kanter_core_tpu_torch.ops import warp as port_warp

torch.set_num_threads(1)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _inputs(h, w, n_planes, seed, strength_lo=0.0, strength_hi=1.0):
    rng = np.random.default_rng(seed)
    planes = [rng.random((h, w), dtype=np.float32) for _ in range(n_planes)]
    m = (rng.random((h, w), dtype=np.float32) * np.float32(strength_hi - strength_lo)
         + np.float32(strength_lo))
    return planes, m


def _reference(planes, m, payload, interpret=False):
    """The JAX package's warp: the gather, or the Pallas kernel in interpret
    mode (with the binding's staircase table, as its compiler passes it)."""
    h, w = m.shape
    b = ref_warp.warp_bindings(payload)
    rows, cols = np.arange(h, dtype=np.int32), np.arange(w, dtype=np.int32)
    if not interpret:
        outs = jax.jit(ref_warp.warp_planes, static_argnums=(5, 6))(
            tuple(planes), m, rows, cols, b["k"], h, w
        )
        return [np.asarray(o) for o in outs]
    from kanter_core_tpu.ops import pallas_warp

    halo = ref_warp.warp_halo(payload[1])
    assert "pairs" in b and pallas_warp.fits_kernel(h, w, halo)
    ref_warp.FORCE_PALLAS_INTERPRET = True
    try:
        outs = ref_warp.warp_planes(tuple(planes), m, rows, cols, b["k"], h, w,
                                    table=(b["pairs"], b["npairs"]), halo=halo)
    finally:
        ref_warp.FORCE_PALLAS_INTERPRET = False
    return [np.asarray(o) for o in outs]


def _port(planes, m, payload):
    b = port_warp.warp_bindings(payload)
    outs = port_warp.warp_planes([torch.from_numpy(p) for p in planes], torch.from_numpy(m), b["k"])
    return [o.numpy() for o in outs]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        assert int((_bits(g) != _bits(r)).sum()) == 0


@pytest.mark.parametrize("h,w", [(128, 128), (97, 411)])
@pytest.mark.parametrize("payload", [
    (37.0, 5.0), (0.0, 5.0), (90.0, 64.0), (180.0, 3.0), (270.0, 7.5), (-123.0, 12.0),
    (37.0, 0.0), (37.0, 1000.0), (61.0, 1e6),
])
def test_warp_matches_gather(h, w, payload):
    planes, m = _inputs(h, w, 4, seed=h + int(payload[1]))
    _assert_same(_port(planes, m, payload), _reference(planes, m, payload))


@pytest.mark.parametrize("payload", [(37.0, 5.0), (0.0, 5.0), (90.0, 20.0), (200.0, 9.0)])
def test_warp_matches_pallas_interpret(payload):
    planes, m = _inputs(128, 128, 4, seed=int(payload[0]), strength_lo=-0.25, strength_hi=1.25)
    _assert_same(_port(planes, m, payload), _reference(planes, m, payload, interpret=True))


def test_warp_strength_nan_and_out_of_range():
    """NaN strength means no displacement; values outside [0, 1] clamp."""
    planes, m = _inputs(97, 411, 4, seed=5, strength_lo=-2.0, strength_hi=3.0)
    m[::7, ::5] = np.nan
    m[3, :] = np.inf
    m[4, :] = -np.inf
    for payload in ((37.0, 5.0), (90.0, 64.0)):
        _assert_same(_port(planes, m, payload), _reference(planes, m, payload))


@pytest.mark.parametrize("intensity", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.filterwarnings("ignore:invalid value encountered in multiply")
def test_warp_non_finite_intensity_matches_gather(intensity):
    """Non-finite intensity gives non-finite coordinates; the int conversion
    of a NaN coordinate is 0 in XLA and in the CUDA kernel, and the plain
    version maps it to 0 explicitly (torch's CPU cast gives INT_MIN). The
    NaN outputs carry the same bits on the CPU."""
    planes, m = _inputs(33, 65, 1, seed=2)
    m[0, :4] = 0.5  # d == 0: inf * 0 is NaN
    for angle in (37.0, 90.0):
        payload = (angle, intensity)
        want = _reference(planes, m, payload)
        got = _port(planes, m, payload)
        assert not np.isfinite(want[0]).all()
        _assert_same(got, want)


def test_dangling_strength_aliases_the_input():
    """With slot 1 unconnected the Warp node forwards its input image (the
    same plane tensors), like the JAX compiler's branch."""
    from kanter_core_tpu_torch import Node, NodeGraph, NodeType, SlotId

    graph = NodeGraph()
    inp = graph.add_node(Node(NodeType.InputRgba("in")))
    warp = graph.add_node(Node(NodeType.Warp(37.0, 5.0)))
    out = graph.add_node(Node(NodeType.OutputRgba("out")))
    graph.connect(inp, warp, SlotId(0), SlotId(0))
    graph.connect(warp, out, SlotId(0), SlotId(0))
    planes = tuple(torch.rand(6, 5) for _ in range(4))
    prog = port_compiler.CompiledGraph(graph, emit_all=True, device="cpu")
    unique, layout = prog.call_with_layout(input_rgba_first=planes)
    assert layout[(warp, SlotId(0))] == layout[(inp, SlotId(0))]
    assert all(unique[i] is p for i, p in zip(layout[(warp, SlotId(0))], planes))


def test_warp_bindings_match_reference_k():
    for payload in ((37.0, 5.0), (90.0, 64.0), (450.0, -3.0), (-0.0, 2.0), (33.3, float("inf"))):
        got, want = port_warp.warp_bindings(payload)["k"], ref_warp.warp_bindings(payload)["k"]
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_cpu_warp_launches_no_kernel_and_cuda_entry_refuses_cpu():
    before = port_warp.WARP_KERNEL.launches
    planes, m = _inputs(8, 8, 1, seed=0)
    _port(planes, m, (37.0, 5.0))
    assert port_warp.WARP_KERNEL.launches == before
    with pytest.raises(TexProError):
        port_warp.warp_planes_cuda([torch.zeros(8, 8)], torch.zeros(8, 8), np.zeros(2, np.float32))
    assert port_warp.WARP_KERNEL.launches == before


# --- the block kernel's index plan, emulated in plain torch ----------------


def _block_case(h, w, n, j, payload, halo=None, seed=0, nan=True):
    """Shard `j` of `n` of an RGBA `h × w` canvas with a strength map in
    [-0.3, 1.3] (NaN on every 7th pixel when `nan`): the arguments of
    `warp_block_plain`, with `halo` rows of ring halos (default
    `warp_halo`)."""
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)) for _ in range(4)]
    m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    if nan:
        m.flat[::7] = np.nan
    b = port_warp.warp_bindings(payload)
    halo = b["halo"] if halo is None else halo
    bh = h // n
    rows = torch.arange(j * bh, (j + 1) * bh)
    top_rows = (rows[0] - halo + torch.arange(halo)) % h
    bot_rows = (rows[-1] + 1 + torch.arange(halo)) % h
    return ([p[rows] for p in planes], torch.from_numpy(m)[rows], b["k"],
            [p[top_rows] for p in planes], [p[bot_rows] for p in planes], j * bh, h)


def _emulate_block(block_planes, strength, k, tops, bots, row_origin, h, mode):
    """What `kanter_warp_block_f32` computes in index `mode`, step for
    step: the coordinates as `block_sample` rounds them, the column wrapped
    by one conditional add or subtract (`WARP_FAST`) or a remainder, the
    window row unwrapped (`(int)vf − row_origin + halo`) or by remainder
    (`WARP_GENERAL`), and the texels read through the row's segment of
    `[top; mid; bot]`, with the kernel's bounds asserted on every index."""
    block_h, w = strength.shape
    halo = tops[0].shape[0]
    kx, ky = (float(c) for c in np.asarray(k, np.float32))
    cy = math.ceil(abs(ky) * 0.5)
    ly = torch.arange(block_h)[:, None].expand(block_h, w)
    x = torch.arange(w)[None, :].expand(block_h, w)
    ms = torch.where(torch.isnan(strength), 0.5, torch.clamp(strength, 0.0, 1.0))
    d = ms - 0.5
    u = x.to(torch.float32) + d * kx
    v = (ly + row_origin).to(torch.float32) + d * ky
    uf = torch.clamp(torch.floor(u), -1e9, 1e9)
    vf = torch.clamp(torch.floor(v), -1e9, 1e9)
    fu, fv = u - uf, v - vf

    def as_int(f):  # CUDA's and XLA's conversion: NaN is 0
        return torch.where(torch.isnan(f), 0.0, f).to(torch.int64)

    iu, iv = as_int(uf), as_int(vf)
    if mode == port_warp.WARP_FAST:
        assert bool(((iu >= -w) & (iu < 2 * w)).all())
        x0 = torch.where(iu < 0, iu + w, torch.where(iu >= w, iu - w, iu))
    else:
        x0 = torch.remainder(iu, w)
    x1 = torch.where(x0 + 1 == w, 0, x0 + 1)
    if mode == port_warp.WARP_GENERAL:
        y0 = torch.remainder(iv, h)
        y1 = torch.where(y0 + 1 == h, 0, y0 + 1)
        r0 = torch.remainder(y0 - row_origin + halo, h)
        r1 = torch.remainder(y1 - row_origin + halo, h)
    else:
        r0 = iv - row_origin + halo
        r1 = r0 + 1
        # the kernel's inner rows read `mid` only
        inner = (ly >= cy) & (ly + cy + 2 <= block_h)
        assert bool(((r0[inner] >= halo) & (r1[inner] < halo + block_h)).all())
    assert bool(((r0 >= 0) & (r1 < block_h + 2 * halo)).all())

    def segment(r):  # row_ref: (0 top, 1 mid, 2 bot) and the row in it
        seg = (r >= halo).long() + (r >= halo + block_h).long()
        return seg, r - torch.tensor([0, halo, halo + block_h])[seg]

    (s0, o0), (s1, o1) = segment(r0), segment(r1)
    outs = []
    for top, mid, bot in zip(tops, block_planes, bots):
        def texel(seg, off, col):
            out = torch.empty_like(mid)
            for i, part in enumerate((top, mid, bot)):
                hit = seg == i
                out[hit] = part[off[hit], col[hit]]
            return out

        n00, n10 = texel(s0, o0, x0), texel(s0, o0, x1)
        n01, n11 = texel(s1, o1, x0), texel(s1, o1, x1)
        nx0 = n00 + fu * (n10 - n00)
        nx1 = n01 + fu * (n11 - n01)
        outs.append(nx0 + fv * (nx1 - nx0))
    return outs


# (h, w, shards, shard, payload, halo): the first and last shard (the
# window crosses the seam), a halo of exactly ceil(|ky|/2) + 2, blocks of
# exactly the halo, widths 1, 3, 5 and 411, the column gate failing (256×8
# at intensity 20, 0°), and a window taller than the plane (the row gate)
_BLOCK_CASES = [
    (64, 128, 4, 0, (37.0, 5.0), None),
    (64, 128, 4, 3, (37.0, 5.0), None),
    (64, 128, 4, 3, (37.0, 9.0), None),
    (96, 128, 4, 0, (213.0, 5.0), 4),   # |ky| = 2.72: halo = 2 + 2
    (32, 64, 4, 0, (37.0, 5.0), None),  # blocks of 8 rows, as many as the halo
    (64, 64, 8, 7, (37.0, 5.0), None),
    (64, 1, 4, 1, (37.0, 5.0), None),
    (64, 3, 4, 3, (90.0, 5.0), None),
    (64, 5, 4, 0, (37.0, 5.0), None),
    (96, 411, 4, 3, (37.0, 9.0), None),
    (256, 8, 4, 0, (0.0, 20.0), None),
    (256, 8, 4, 3, (0.0, 20.0), None),
    (24, 32, 2, 1, (37.0, 5.0), None),  # block 12 + 2 · 8 > 24 rows
]


@pytest.mark.parametrize("h,w,n,j,payload,halo", _BLOCK_CASES)
def test_block_index_plan_matches_plain(h, w, n, j, payload, halo):
    """The planned index mode, emulated, is bit for bit `warp_block_plain`,
    and so are the more general ones (valid wherever the halo covers ky)."""
    args = _block_case(h, w, n, j, payload, halo, seed=h * w + j)
    want = port_warp.warp_block_plain(*args)
    kx, ky = (float(c) for c in np.asarray(args[2], np.float32))
    mode = port_warp.warp_block_index_mode(kx, ky, h // n, w, h, args[3][0].shape[0])
    assert port_warp.warp_block_plan(kx, ky, h // n, w, h, args[3][0].shape[0], True).mode == mode
    for m in range(mode, port_warp.WARP_GENERAL + 1):
        got = _emulate_block(*args, m)
        assert all(_bits(g).tobytes() == _bits(r).tobytes() for g, r in zip(got, want)), m


def test_block_index_gate():
    """The gate's three modes, and the launch of the main path's block."""
    mode = port_warp.warp_block_index_mode
    assert mode(3.99, 3.0, 1024, 4096, 4096, 8) == port_warp.WARP_FAST
    assert mode(3.99, 3.0, 1024, 4096, 4096, 3) == port_warp.WARP_GENERAL  # halo short of ky
    assert mode(3.99, 4.0, 1024, 4096, 4096, 4) == port_warp.WARP_FAST  # exactly 2 + 2
    assert mode(20.0, 0.0, 64, 8, 256, 16) == port_warp.WARP_COL_GENERAL
    assert mode(16.0, 0.0, 64, 10, 256, 16) == port_warp.WARP_FAST  # 8 + 2 <= 10
    assert mode(17.0, 0.0, 64, 10, 256, 16) == port_warp.WARP_COL_GENERAL
    assert mode(float("inf"), 3.0, 64, 64, 256, 8) == port_warp.WARP_COL_GENERAL
    assert mode(3.0, float("nan"), 64, 64, 256, 8) == port_warp.WARP_GENERAL
    assert mode(3.0, 3.0, 12, 32, 24, 8) == port_warp.WARP_GENERAL  # 12 + 16 > 24
    px = port_warp.WARP_BLOCK_PX
    for ky in (0.0, 3.0, -8.0, 9.0, 64.0, float("nan")):
        th, tw = port_warp.warp_block_tile(ky)
        assert tw % px == 0 and (tw // px) * th <= 256 and (tw // px * th) % 32 == 0
    assert port_warp.warp_block_tile(8.0) != port_warp.warp_block_tile(9.0)
    plan = port_warp.warp_block_plan(3.99, 3.0, 1024, 4096, 4096, 8, True)
    assert plan == port_warp.WarpBlockPlan(port_warp.WARP_FAST, True, 8, 64)
    # unaligned storage, or an odd width: strided pixels, scalar accesses
    assert not port_warp.warp_block_plan(3.99, 3.0, 1024, 4096, 4096, 8, False).vec
    assert not port_warp.warp_block_plan(3.99, 3.0, 96, 411, 384, 8, True).vec


def _refusal(case):
    z = torch.zeros
    planes, tops, bots = [z(16, 8)], [z(8, 8)], [z(8, 8)]
    strength = z(16, 8)
    k = port_warp.warp_bindings((37.0, 5.0))["k"]
    if case == "shape":
        tops = [z(8, 9)]
    elif case == "dtype":
        planes = [z(16, 8, dtype=torch.float64)]
    elif case == "mixed devices":
        bots = [torch.empty(8, 8, device="meta")]
    elif case == "halo":
        k = port_warp.warp_bindings((90.0, 14.0))["k"]  # needs 7 + 2 rows
    elif case == "strided":
        planes = [z(16, 16)[:, ::2]]
    return planes, strength, k, tops, bots, 16, 64


@pytest.mark.parametrize("case", ["cpu", "shape", "dtype", "mixed devices", "halo", "strided"])
def test_warp_block_cuda_refusals(case):
    """Every check that guards a launch raises before any build or launch:
    a CPU tensor, a wrong shape or dtype, a tensor on another device, a
    halo that does not cover ky, a strided plane."""
    before = port_warp.WARP_BLOCK_KERNEL.launches
    with pytest.raises(TexProError):
        port_warp.warp_block_cuda(*_refusal(case))
    assert port_warp.WARP_BLOCK_KERNEL.launches == before
