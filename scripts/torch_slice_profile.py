#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's slice, on one GPU.

    python3 scripts/torch_slice_profile.py [--size 4096] [--out DIR]

Renders `models.pbr_material_graph()` at size² through
`TextureProcessor(device="cuda")` once to warm up, then profiles, with
`torch.profiler` (CPU and CUDA activities), one full render of all four
maps on a fresh processor, one `ao_strength` Value edit and one AO-blur
sigma edit (re-reading `ao` and `roughness` after each). For each window it
prints the wall time, the summed device-kernel time, the device idle share
(1 − kernel time / wall) and the top kernels by device time; the Chrome
traces go to `--out` (default `out/torch_profile/`, ignored by git). Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--out", default=os.path.join(ROOT, "out", "torch_profile"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_slice_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kanter_core_tpu_torch import (
        NodeType, NodeTypeKind, SlotData, SlotId, SlotImage, TextureProcessor,
    )
    from kanter_core_tpu_torch.convert import planes_from_numpy
    from kanter_core_tpu_torch.models import pbr_material_graph

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; size {args.size}²", flush=True)
    os.makedirs(args.out, exist_ok=True)
    n = args.size
    height = np.random.default_rng(0).random((n, n), dtype=np.float32)

    def session():
        tp = TextureProcessor(memory_threshold=16 << 30, device="cuda")
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(pbr_material_graph())
            nodes = g.node_graph.nodes
            (inp,) = [x for x in nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
            (plane,) = planes_from_numpy([height], tp.device)
            g.add_input_slot_data(SlotData(inp.node_id, SlotId(0), SlotImage.Gray(plane)))
        outputs = {lg.node_graph.node(o).node_type.payload: o for o in lg.node_graph.output_ids()}
        return tp, lg, outputs

    def read(lg, outputs, names):
        for name in names:
            TextureProcessor.buffer_rgba(lg, outputs[name], SlotId(0))
        torch.cuda.synchronize()

    def node_id(lg, kind, payload):
        (nid,) = [x.node_id for x in lg.node_graph.nodes
                  if x.node_type.kind == kind and x.node_type.payload == payload]
        return nid

    tp, lg, outputs = session()  # warm-up: first CUDA use, kernel build
    read(lg, outputs, ["normal", "ao", "roughness", "albedo"])
    tp.shutdown_now()

    tp, lg, outputs = session()
    value = node_id(lg, NodeTypeKind.VALUE, 0.75)
    blur = node_id(lg, NodeTypeKind.BLUR, 6.0)

    def value_edit():
        with lg.write() as g:
            g.node_mut(value).node_type = NodeType.Value(0.6)
        read(lg, outputs, ["ao", "roughness"])

    def sigma_edit():
        lg.set_blur_sigma(blur, 4.0)
        read(lg, outputs, ["ao", "roughness"])

    windows = [
        ("render", lambda: read(lg, outputs, ["normal", "ao", "roughness", "albedo"])),
        ("value-edit", value_edit),
        ("sigma-edit", sigma_edit),
    ]
    try:
        for label, fn in windows:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            # the kernels' own rows (CPU ops also report their kernels' time)
            device_ms = sum(
                e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / 1e3
            print(f"\n== {label}: wall {wall_ms:.3f} ms, device kernels {device_ms:.3f} ms, "
                  f"device idle share {1 - device_ms / wall_ms:.3f}", flush=True)
            print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
            prof.export_chrome_trace(os.path.join(args.out, f"torch_slice_{label}.json"))
    finally:
        tp.shutdown_now()
    return 0


if __name__ == "__main__":
    sys.exit(main())
