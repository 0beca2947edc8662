"""Tests of the port that need a CUDA card (marker `cuda`; they skip on a
machine without one). Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The CUDA blur kernel must be bit-identical to its plain torch version, and
the slice must give the same f32 planes and u8 exports on the card as on
the CPU.
"""

import numpy as np
import pytest
import torch

import kanter_core_tpu_torch as port
from kanter_core_tpu_torch.convert import planes_from_numpy
from kanter_core_tpu_torch.models import pbr_material_graph
from kanter_core_tpu_torch.ops import blur

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


def _render(device, n=192):
    tp = port.TextureProcessor(10_000_000, device=device)
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
