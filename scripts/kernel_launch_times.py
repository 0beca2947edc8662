#!/usr/bin/env python3
"""Device time of every launch inside the port's blur and jump-flood
wrappers, on one GPU.

    python3 scripts/kernel_launch_times.py [--root DIR] [--size 4096] [--runs 5]

The CUDA-event timings of `chip_smoke.py` see a wrapper as a whole. This
script runs each wrapper under `torch.profiler` and prints the device time
of every kernel it launched, in launch order, so that a blur shows its
passes and a jump-flood ladder its steps:

- `blur_plane_cuda` on a size² plane at every sigma the PBR and flagship
  graphs launch (0.8, 1.0, 1.2, 2.0, 4.0, 6.0);
- `blur_block_cuda` on the first of four row blocks of that plane at
  sigma 0.8, 1.2 and 6.0;
- `jfa_propagate_cuda` on a size² state at seed density 1e-2.

Each is warmed up, then profiled `--runs` times; per launch the median over
the runs is printed with the kernel's name. `--root` names the checkout
whose `kanter_core_tpu_torch` is measured (default: this script's), so two
trees can be read in turns inside one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launches(fn, runs: int):
    """[(kernel name, median device µs)] of the kernels `fn()` launches, in
    launch order, over `runs` profiled calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    per_run = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("Memcpy") and not e.name.startswith("Memset")]
        events.sort(key=lambda e: e.time_range.start)
        per_run.append([(e.name, e.time_range.elapsed_us()) for e in events])
    names = [name for name, _ in per_run[0]]
    if any([name for name, _ in run] != names for run in per_run):
        raise AssertionError("the runs launched different kernels")
    return [(name, float(np.median([run[i][1] for run in per_run])))
            for i, name in enumerate(names)]


def report(label: str, rows) -> None:
    total = sum(us for _, us in rows)
    print(f"{label}: {len(rows)} launches, {total / 1e3:.4f} ms device in all", flush=True)
    for i, (name, us) in enumerate(rows):
        short = name.replace("(anonymous namespace)::", "").split("(")[0][-60:]
        print(f"  [{i:2d}] {us / 1e3:.4f} ms  {short}", flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_launch_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from kanter_core_tpu_torch.ops import blur, distance

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    n = args.size
    print(f"card: {card}; torch {torch.__version__}; root {os.path.abspath(args.root)}; "
          f"size {n}²", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    for sigma in (0.8, 1.0, 1.2, 2.0, 4.0, 6.0):
        taps = len(blur.gaussian_taps(round(sigma, 6)))
        report(f"blur {n}x{n} sigma={sigma} taps={taps}",
               launches(lambda: blur.blur_plane_cuda(x, sigma), args.runs))
    bh = n // 4
    for sigma in (0.8, 1.2, 6.0):
        r = (len(blur.gaussian_taps(round(sigma, 6))) - 1) // 2
        band = x[:bh].contiguous()
        top, bot = x[n - r:].contiguous(), x[bh:bh + r].contiguous()
        report(f"blur block {bh}x{n} sigma={sigma} radius={r}",
               launches(lambda: blur.blur_block_cuda(band, top, bot, sigma), args.runs))
    mask = torch.from_numpy((rng.random((n, n)) < 1e-2).astype(np.float32)).cuda()
    state = distance.pack_seeds(mask)
    steps = distance._jfa_steps(n, n)
    report(f"jfa {n}x{n} density 1e-2, ladder {steps}",
           launches(lambda: distance.jfa_propagate_cuda(state), args.runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
