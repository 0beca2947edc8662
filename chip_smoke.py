#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kanter_core_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) on failure:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   no CUDA device → exit before printing any result;
2. build: compiles `kanter_core_tpu_torch/csrc/blur.cu` with nvcc from the
   checkout's sources and prints the build time and ptxas report;
3. kernel: the CUDA blur against its plain torch version on the card, at the
   main path's shapes (4096² at σ=0.8 and σ=6.0) and at edge shapes (1×1,
   5×4096 with 37 taps, 97×411, 4096×1); every output must be bit-identical
   (0 mismatches on the int32 view); CUDA-event timings (median of 20 runs
   after warm-up) of both at 4096²;
4. slice: `models.pbr_material_graph()` at 4096² through
   `TextureProcessor(device="cuda")` → `LiveGraph` → `buffer_rgba`, a 4096²
   height plane from `numpy.random.default_rng(0)`: all four maps, then an
   `ao_strength` Value edit (0.75→0.6) and an AO blur sigma edit (6.0→4.0),
   re-reading `ao` and `roughness` after each; the blur launch counter is
   reset before this phase and must rise exactly on the renders that re-ran
   a Blur node;
5. card vs CPU: the same graph, edits and seed at 1024² on `device="cuda"`
   and on `device="cpu"` (the port's plain path); u8 exports must be
   identical, and the f32 mismatch count of every output is printed.

The second-to-last line is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mismatches(a, b) -> int:
    """Count of elements whose f32 bit patterns differ."""
    import torch

    a = a.contiguous().view(torch.int32)
    b = b.contiguous().view(torch.int32)
    return int((a != b).sum().item())


def time_cuda(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` over `runs` CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(kp_blur) -> dict:
    import torch

    rng = np.random.default_rng(1)
    shapes = [
        (4096, 4096, 0.8), (4096, 4096, 6.0),
        (1, 1, 0.8), (1, 1, 6.0), (5, 4096, 6.0),
        (97, 411, 0.8), (97, 411, 6.0), (4096, 1, 0.8), (4096, 1, 6.0),
    ]
    max_err = 0.0
    timings = []
    for h, w, sigma in shapes:
        x = torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda()
        got = kp_blur.blur_plane_cuda(x, sigma)
        want = kp_blur.blur_plane_plain(x, sigma)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        err = float((got - want).abs().max().item())
        max_err = max(max_err, err)
        taps = len(kp_blur.gaussian_taps(round(sigma, 6)))
        log(f"kernel blur {h}x{w} sigma={sigma} taps={taps}: "
            f"{bad} bit mismatches, max_abs_err={err}")
        if bad:
            raise AssertionError(f"blur kernel differs from plain at {h}x{w} σ={sigma}")
        if (h, w) == (4096, 4096):
            ms = time_cuda(lambda: kp_blur.blur_plane_cuda(x, sigma))
            plain_ms = time_cuda(lambda: kp_blur.blur_plane_plain(x, sigma))
            gbs = 8.0 * h * w / (ms * 1e-3) / 1e9  # one read + one write per pixel
            plain_gbs = 8.0 * h * w / (plain_ms * 1e-3) / 1e9
            log(f"  time: kernel {ms:.4f} ms ({gbs:.1f} GB/s effective), "
                f"plain {plain_ms:.4f} ms ({plain_gbs:.1f} GB/s effective)")
            timings.append({"shape": f"{h}x{w}", "sigma": sigma, "taps": taps,
                            "ms": ms, "plain_ms": plain_ms,
                            "gbs": gbs, "plain_gbs": plain_gbs})
    return {"max_abs_err": max_err, "timings": timings}


def drive_slice(device: str, n: int, seed: int = 0, timed: bool = False):
    """Render pbr_material_graph at n² on `device`, then the Value edit and
    the sigma edit. Returns [(label, output name, [f32 planes], u8 bytes)]
    and the launch counts seen after each render."""
    import torch
    from kanter_core_tpu_torch import (
        NodeType, NodeTypeKind, SlotData, SlotId, SlotImage, TextureProcessor,
    )
    from kanter_core_tpu_torch.convert import planes_from_numpy
    from kanter_core_tpu_torch.models import pbr_material_graph
    from kanter_core_tpu_torch.ops.blur import BLUR_KERNEL

    height = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    results = []
    launches = []
    tp = TextureProcessor(memory_threshold=16 << 30, device=device)
    try:
        lg = tp.new_live_graph()
        with lg.write() as g:
            g.set_node_graph(pbr_material_graph())
            nodes = g.node_graph.nodes
            (inp,) = [x for x in nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
            (ao_strength,) = [
                x.node_id for x in nodes
                if x.node_type.kind == NodeTypeKind.VALUE and x.node_type.payload == 0.75
            ]
            (ao_blur,) = [
                x.node_id for x in nodes
                if x.node_type.kind == NodeTypeKind.BLUR and x.node_type.payload == 6.0
            ]
            outputs = {g.node_graph.node(o).node_type.payload: o for o in g.node_graph.output_ids()}
            (plane,) = planes_from_numpy([height], tp.device)
            g.add_input_slot_data(SlotData(inp.node_id, SlotId(0), SlotImage.Gray(plane)))

        def read(label, names):
            for name in names:
                oid = outputs[name]
                t0 = time.perf_counter()
                px = TextureProcessor.buffer_rgba(lg, oid, SlotId(0))
                if tp.device.type == "cuda":
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if px.shape != (n * n * 4,):
                    raise AssertionError(f"{name}: {px.shape} bytes, want {n * n * 4}")
                planes = [p.host_data().copy() for p in lg.slot_data(oid, SlotId(0)).image.planes]
                if not all(np.isfinite(p).all() for p in planes):
                    raise AssertionError(f"{name}: non-finite values")
                results.append((label, name, planes, px))
                if timed:
                    log(f"slice {n}x{n} {label} read {name}: {ms:.3f} ms wall")
            launches.append(BLUR_KERNEL.launches)

        if timed:
            BLUR_KERNEL.launches = 0
        read("render", ["normal", "ao", "roughness", "albedo"])
        with lg.write() as g:
            g.node_mut(ao_strength).node_type = NodeType.Value(0.6)
        read("value-edit", ["ao", "roughness"])
        lg.set_blur_sigma(ao_blur, 4.0)
        read("sigma-edit", ["ao", "roughness"])
        if lg.fatal_error is not None:
            raise lg.fatal_error
        if timed:
            log(f"slice metrics: {json.dumps(tp.metrics()['recipe_cache'])}, "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    finally:
        tp.shutdown_now()
    return results, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device")
        return 1
    sys.path.insert(0, ROOT)
    from kanter_core_tpu_torch.ops import blur as kp_blur

    if any(m == "jax" or m.startswith("jax.") or m.startswith("kanter_core_tpu.")
           or m == "kanter_core_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")

    # 1. the card
    log(card_line())  # name, power limit — exactly as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    kp_blur.BLUR_KERNEL.library()
    log(f"build: csrc/blur.cu in {time.perf_counter() - t0:.2f} s")
    with open(kp_blur.BLUR_KERNEL.path + ".log") as f:
        for line in f.read().strip().splitlines():
            log(f"  nvcc: {line}")

    # 3. kernel vs plain
    kernel = kernel_phase(kp_blur)

    # 4. the slice at full size, through the entry points
    _, launches = drive_slice("cuda", 4096, timed=True)
    log(f"blur launches after each render (render, value edit, sigma edit): {launches}")
    render, value_edit, sigma_edit = launches
    if render < 2:
        raise AssertionError("the first render did not launch the blur kernel for both Blur nodes")
    if value_edit != render:
        raise AssertionError("the Value edit re-ran a Blur node")
    if sigma_edit <= value_edit:
        raise AssertionError("the sigma edit did not launch the blur kernel")

    # 5. card vs CPU at 1024²
    gpu, _ = drive_slice("cuda", 1024)
    cpu, _ = drive_slice("cpu", 1024)
    u8_equal = True
    for (label, name, gp, gu8), (_, _, cp, cu8) in zip(gpu, cpu):
        counts = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(gp, cp)]
        same = np.array_equal(gu8, cu8)
        u8_equal &= same
        log(f"card vs cpu 1024x1024 {label} {name}: f32 mismatches per plane {counts}, "
            f"u8 identical {same}")
    if not u8_equal:
        raise AssertionError("u8 exports differ between the card and the CPU")

    main_timing = kernel["timings"][-1]  # 4096² at σ=6.0
    log(json.dumps({"kernels": [{
        "name": "kanter_blur_wrap_f32",
        "route": "cuda",
        "source": "kanter_core_tpu_torch/csrc/blur.cu",
        "replaces": "kanter_core_tpu/ops/pallas_blur.py:77",
        "launches": sigma_edit,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_timing["ms"],
        "plain_ms": main_timing["plain_ms"],
        "timings": kernel["timings"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
