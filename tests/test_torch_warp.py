"""The port's Warp against the JAX package's, on the CPU.

On CPU tensors the port's `warp_planes` runs its plain torch gather
(`warp_planes_plain`); it must be bit-identical (int32 view) to the JAX
package's `warp_planes` through its gather form and, at kernel-viable
shapes, through its Pallas staircase kernel in interpret mode (as
`tests/test_pallas_warp.py` runs it). The CUDA kernel itself is compared
with the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

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
    prog = port_compiler.CompiledGraph(graph, "cpu")
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
