#!/usr/bin/env python3
"""Sweep of the host-side tile choices of the blur and the jump-flood near
kernels, on one GPU.

    python3 scripts/kernel_tile_sweep.py [--size 4096] [--probe] [--lattice]

`ops/blur.blur_tile_plan` and `ops/distance.jfa_launch_plan` pick one tile
per radius and shape. This script times the alternatives, so that the
choice written there rests on a measurement:

- the blur of a size² plane at every sigma the PBR and flagship graphs
  launch, on every tile of th in (16, 24, 32, 48, 64, 96, 128) by tw in
  (64, 128, 192) that the kernel takes;
- the fused near run (8, 4, 2, 1, 1) of a size² jump-flood state, on
  square and wide tiles from 32 to 128.

`--probe` also builds a copy of `csrc/blur.cu` whose staging stores a
constant instead of copying from device memory (its results are wrong by
design) and times it beside the real kernel on the planned tiles: what is
left is the time of the two passes and the output's stores alone.

`--lattice` rebuilds `csrc/jfa.cu` with other lattice patches per thread
(rows x columns) and other occupancy targets (`KANTER_JFA_LATTICE_*`) and
times the far steps of the size² ladder with each, compared bit for bit
with the built-in choice.

Each reading is the median of 20 CUDA-event timings of 10 calls back to
back; every result is compared bit for bit with the planned tile's. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_cuda(fn, runs: int = 20, calls: int = 10) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def blur_without_loads(blur):
    """The blur entry of a copy of the kernel that reads no input."""
    import ctypes

    from kanter_core_tpu_torch import build

    with open(blur.BLUR_KERNEL.source) as f:
        text = f.read()
    copies = {
        "__pipeline_memcpy_async(dst + 32 * c, src + gx[c], sizeof(float));":
            "dst[32 * c] = 1.0f;",
        "__pipeline_memcpy_async(tile + i * pitch + 4 * m, src, 4 * sizeof(float));":
            "*reinterpret_cast<float4*>(tile + i * pitch + 4 * m) = "
            "make_float4(1.0f, 1.0f, 1.0f, 1.0f + (src == nullptr));",
    }
    for copy, store in copies.items():
        if text.count(copy) != 1:
            raise AssertionError("a staging copy of csrc/blur.cu is not where the probe expects it")
        text = text.replace(copy, store)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "blur_no_load.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = build.build_library("blur_no_load", [path], [build.nvcc(), *build.NVCC_FLAGS])
    fn = getattr(ctypes.CDLL(lib), blur.BLUR_KERNEL.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = blur.BLUR_KERNEL.argtypes
    return fn


def lattice_variant(distance, rows: int, cols: int, blocks: int):
    """The far-step entry of `csrc/jfa.cu` built with another lattice patch."""
    import ctypes

    from kanter_core_tpu_torch import build

    flags = [f"-DKANTER_JFA_LATTICE_ROWS={rows}", f"-DKANTER_JFA_LATTICE_COLS={cols}",
             f"-DKANTER_JFA_LATTICE_BLOCKS={blocks}"]
    lib = build.build_library("jfa_lattice", [distance.JFA_KERNEL.source],
                              [build.nvcc(), *build.NVCC_FLAGS, *flags])
    with open(lib + ".log") as f:
        report = [line.strip() for line in f if "registers" in line or "spill" in line]
    fn = getattr(ctypes.CDLL(lib), distance.JFA_KERNEL.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = distance.JFA_KERNEL.argtypes
    return fn, report


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--lattice", action="store_true",
                        help="also time the far steps with other lattice patches")
    parser.add_argument("--probe", action="store_true",
                        help="also time the blur without its loads from device memory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kanter_core_tpu_torch.ops import blur, distance

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    n = args.size
    print(f"card: {card}; torch {torch.__version__}; size {n}²", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    planned = blur.blur_tile_plan
    if args.probe:
        real = blur.BLUR_KERNEL.entry()
        probe = blur_without_loads(blur)
        for sigma in (0.8, 1.2, 2.0, 4.0, 6.0):
            ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
            blur.BLUR_KERNEL._fn = probe
            try:
                probe_ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
            finally:
                blur.BLUR_KERNEL._fn = real
            print(f"blur {n}x{n} sigma={sigma}: {ms:.4f} ms, without its loads {probe_ms:.4f} ms",
                  flush=True)
    for sigma in (0.8, 1.2, 2.0, 4.0, 6.0):
        r = (len(blur.gaussian_taps(round(sigma, 6))) - 1) // 2
        plan = planned(r, n, n)
        want = blur.blur_plane_cuda(x, sigma)
        rows = []
        for th in (16, 24, 32, 48, 64, 96, 128):
            for tw in (64, 128, 192):
                smem = blur.blur_tile_smem(r, th, tw)
                if tw + 2 * (-(-r // 4) * 4) > 256 or smem > blur.BLUR_SMEM_MAX:
                    continue
                blur.blur_tile_plan = lambda radius, h, w: blur.BlurTilePlan(
                    th, tw, -(-h // th), -(-w // tw), smem, False)
                try:
                    same = torch.equal(blur.blur_plane_cuda(x, sigma), want)
                    ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
                finally:
                    blur.blur_tile_plan = planned
                rows.append((ms, th, tw, smem, same))
        print(f"blur {n}x{n} sigma={sigma} radius={r}, planned {plan.th}x{plan.tw}:", flush=True)
        for ms, th, tw, smem, same in sorted(rows):
            mark = " (planned)" if (th, tw) == (plan.th, plan.tw) else ""
            print(f"  {th:3d}x{tw:3d} {smem:6d} B  {ms:.4f} ms  identical {same}{mark}", flush=True)
        if not all(row[4] for row in rows):
            raise AssertionError(f"a tile changed the blur's result at sigma {sigma}")

    mask = torch.from_numpy((rng.random((n, n)) < 1e-2).astype(np.float32)).cuda()
    state = distance.pack_seeds(mask)
    plan = distance.jfa_launch_plan(n, n)
    far, (near,) = plan[:-1], plan[-1:]
    before_near = distance.jfa_run_launches(state, far)
    want = distance.jfa_run_launches(before_near, [near])
    print(f"jfa near run {near.steps} on {n}x{n}, planned {near.th}x{near.tw}:", flush=True)
    rows = []
    for th, tw in ((32, 32), (32, 64), (48, 48), (64, 64), (32, 128), (64, 96), (64, 128),
                   (96, 96), (80, 80), (128, 128), (48, 160), (40, 96)):
        launch = distance.JfaLaunch("near", near.steps, th, tw)
        same = torch.equal(distance.jfa_run_launches(before_near, [launch]), want)
        ms = time_cuda(lambda: distance.jfa_run_launches(before_near, [launch]))
        rows.append((ms, th, tw, same))
    for ms, th, tw, same in sorted(rows):
        mark = " (planned)" if (th, tw) == (near.th, near.tw) else ""
        print(f"  {th:3d}x{tw:3d}  {ms:.4f} ms  identical {same}{mark}", flush=True)
    if not all(row[3] for row in rows):
        raise AssertionError("a tile changed the near run's result")
    for launch in far:
        ms = time_cuda(lambda: distance.jfa_run_launches(state, [launch]))
        print(f"jfa far step {launch.steps[0]}: {ms:.4f} ms", flush=True)
    if args.lattice:
        real = distance.JFA_KERNEL.entry()
        ms = time_cuda(lambda: distance.jfa_run_launches(state, far))
        print(f"jfa far steps, built-in patch: {ms:.4f} ms", flush=True)
        variants = ((2, 4, 1), (2, 4, 2), (2, 4, 3), (2, 2, 1), (2, 2, 3), (2, 2, 4), (1, 4, 3),
                    (1, 8, 2), (4, 4, 1), (4, 2, 2), (2, 8, 1), (1, 2, 4))
        for rows, cols, blocks in variants:
            fn, report = lattice_variant(distance, rows, cols, blocks)
            distance.JFA_KERNEL._fn = fn
            try:
                same = torch.equal(distance.jfa_run_launches(state, far), before_near)
                ms = time_cuda(lambda: distance.jfa_run_launches(state, far))
            finally:
                distance.JFA_KERNEL._fn = real
            print(f"  patch {rows}x{cols}, {blocks} blocks/SM: {ms:.4f} ms  identical {same}  "
                  f"[{'; '.join(report[-4:])}]", flush=True)
            if not same:
                raise AssertionError("a lattice patch changed the far steps' result")
    return 0


if __name__ == "__main__":
    sys.exit(main())
