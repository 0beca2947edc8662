#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's slice, on one GPU.

    python3 scripts/torch_slice_profile.py [--size 4096] [--graph pbr|flagship|both]
                                           [--mesh N] [--out DIR]

Two sequences, each rendered once on a warm-up processor (first CUDA use,
kernel builds) and then profiled on a fresh one, with `torch.profiler` (CPU
and CUDA activities):

- `pbr`: `models.pbr_material_graph()` at size², one full render of all
  four maps, one `ao_strength` Value edit and one AO-blur sigma edit
  (re-reading `ao` and `roughness` after each);
- `flagship`: `graphs.flagship_graph(size)` with four gray inputs, the
  render of `out`, then the chain's `v` Value edit (0.96 → 0.93), the
  Distance spread edit (size/8 → size/16) and the Warp intensity edit
  (5 → 9), re-reading `out` after each.

`--mesh N` runs both on `TextureProcessor(mesh=...)` with N row shards, on
N cards when N are visible and all on `cuda:0` otherwise.

For each window it prints the wall time, the summed device-kernel time,
the device idle share (1 − kernel time / wall), the top kernels by device
time and the top operators by host (self CPU) time; the Chrome traces go to
`--out` (default `out/torch_profile/`, ignored by git). Needs a CUDA device.
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
    parser.add_argument("--graph", choices=["pbr", "flagship", "both"], default="both")
    parser.add_argument("--mesh", type=int, default=0, help="row shards (0: one device)")
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
    from kanter_core_tpu_torch.graphs import flagship_graph
    from kanter_core_tpu_torch.models import pbr_material_graph
    from kanter_core_tpu_torch.parallel import make_mesh

    mesh = None
    if args.mesh:
        if torch.cuda.device_count() >= args.mesh:
            mesh = make_mesh(args.mesh)
        else:
            mesh = make_mesh(devices=["cuda:0"] * args.mesh)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; size {args.size}²; mesh {mesh}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    n = args.size
    height = np.random.default_rng(0).random((n, n), dtype=np.float32)

    def session(build):
        """(processor, live graph, {output name: id}) holding `build`'s graph."""
        tp = TextureProcessor(memory_threshold=16 << 30, device="cuda", mesh=mesh)
        lg = tp.new_live_graph()
        with lg.write() as g:
            # the flagship session keeps every node's data, as chip_smoke.py's does
            g.use_cache = build is flagship
            graph, bound = build()
            g.set_node_graph(graph)
            for node_id, plane in bound:
                (plane,) = planes_from_numpy([plane], tp.device)
                g.add_input_slot_data(SlotData(node_id, SlotId(0), SlotImage.Gray(plane)))
        outputs = {lg.node_graph.node(o).node_type.payload: o for o in lg.node_graph.output_ids()}
        return tp, lg, outputs

    def pbr():
        graph = pbr_material_graph()
        (inp,) = [x.node_id for x in graph.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
        return graph, [(inp, height)]

    def flagship():
        rng = np.random.default_rng(0)
        graph, inputs, _ = flagship_graph(n)
        return graph, [(i, rng.random((n, n), dtype=np.float32)) for i in inputs]

    def read(lg, outputs, names):
        for name in names:
            TextureProcessor.buffer_rgba(lg, outputs[name], SlotId(0))
        torch.cuda.synchronize()

    def node_id(lg, kind, pred=lambda p: True):
        return next(x.node_id for x in lg.node_graph.nodes
                    if x.node_type.kind == kind and pred(x.node_type.payload))

    def pbr_windows(lg, outputs):
        value = node_id(lg, NodeTypeKind.VALUE, lambda p: p == 0.75)
        blur = node_id(lg, NodeTypeKind.BLUR, lambda p: p == 6.0)

        def value_edit():
            with lg.write() as g:
                g.node_mut(value).node_type = NodeType.Value(0.6)
            read(lg, outputs, ["ao", "roughness"])

        def sigma_edit():
            lg.set_blur_sigma(blur, 4.0)
            read(lg, outputs, ["ao", "roughness"])

        return [
            ("render", lambda: read(lg, outputs, ["normal", "ao", "roughness", "albedo"])),
            ("value-edit", value_edit),
            ("sigma-edit", sigma_edit),
        ]

    def flagship_windows(lg, outputs):
        value = node_id(lg, NodeTypeKind.VALUE, lambda p: p != 1.0)
        distance = node_id(lg, NodeTypeKind.DISTANCE)
        warp = node_id(lg, NodeTypeKind.WARP)

        def value_edit():
            with lg.write() as g:
                g.node_mut(value).node_type = NodeType.Value(0.93)
            read(lg, outputs, ["out"])

        def distance_edit():
            lg.set_distance(distance, n / 16.0)
            read(lg, outputs, ["out"])

        def warp_edit():
            lg.set_warp(warp, 37.0, 9.0)
            read(lg, outputs, ["out"])

        return [
            ("render", lambda: read(lg, outputs, ["out"])),
            ("value-edit", value_edit),
            ("distance-edit", distance_edit),
            ("warp-edit", warp_edit),
        ]

    sequences = {"pbr": (pbr, pbr_windows), "flagship": (flagship, flagship_windows)}
    chosen = list(sequences) if args.graph == "both" else [args.graph]
    for name in chosen:
        build, make_windows = sequences[name]
        tp, lg, outputs = session(build)  # warm-up
        make_windows(lg, outputs)[0][1]()
        tp.shutdown_now()

        tp, lg, outputs = session(build)
        try:
            for label, fn in make_windows(lg, outputs):
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
                tag = f"{name} {label}" + ("" if mesh is None else f" mesh {mesh.n}")
                print(f"\n== {tag}: wall {wall_ms:.3f} ms, device kernels "
                      f"{device_ms:.3f} ms, device idle share {1 - device_ms / wall_ms:.3f}",
                      flush=True)
                print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)
                print(events.table(sort_by="self_cpu_time_total", row_limit=8), flush=True)
                suffix = "" if mesh is None else f"_mesh{mesh.n}"
                prof.export_chrome_trace(
                    os.path.join(args.out, f"torch_{name}_{label}{suffix}.json")
                )
        finally:
            tp.shutdown_now()
    return 0


if __name__ == "__main__":
    sys.exit(main())
