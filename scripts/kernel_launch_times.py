#!/usr/bin/env python3
"""Device time of every launch inside the port's blur, jump-flood and
warp wrappers, on one GPU.

    python3 scripts/kernel_launch_times.py [--root DIR] [--size 4096] [--runs 5]
                                           [--only blur,jfa,warp]

The CUDA-event timings of `chip_smoke.py` see a wrapper as a whole. This
script runs each wrapper under `torch.profiler` and prints the device time
of every kernel it launched, in launch order, so that a blur shows its
passes and a jump-flood ladder its steps:

- `blur_plane_cuda` on a size² plane at every sigma the PBR and flagship
  graphs launch (0.8, 1.0, 1.2, 2.0, 4.0, 6.0);
- `blur_block_cuda` on the first of four row blocks of that plane at
  sigma 0.8, 1.2 and 6.0;
- `jfa_propagate_cuda` on a size² state at seed density 1e-2;
- `warp_planes_cuda` on size² RGBA at (37°, 5), `warp_block_cuda` on the
  first of four row blocks of it (with its ring halos) and
  `warp_planes_mesh` over four shards on `cuda:0`, each also timed with
  CUDA events as one call and as ten calls back to back (median of 20):
  the single call holds the wrapper's host time, the difference between
  the two is that host time.

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
    # the profiler now and then loses a launch: keep the runs that saw the
    # launch list most runs saw, and raise unless they are most of the runs
    lists = [[name for name, _ in run] for run in per_run]
    names = max(lists, key=lists.count)
    per_run = [run for run, seen in zip(per_run, lists) if seen == names]
    if 2 * len(per_run) <= len(lists):
        raise AssertionError("the runs launched different kernels")
    return [(name, float(np.median([run[i][1] for run in per_run])))
            for i, name in enumerate(names)]


def event_ms(fn, calls: int, runs: int = 20) -> float:
    """Median CUDA-event milliseconds per call of `calls` calls of `fn` back
    to back, after a warm-up."""
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
    parser.add_argument("--only", default="blur,jfa,warp",
                        help="comma-separated subset of blur, jfa, warp")
    args = parser.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("kernel_launch_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from kanter_core_tpu_torch.ops import blur, distance, warp
    from kanter_core_tpu_torch.parallel import make_mesh, shard_planes_rows

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    n = args.size
    print(f"card: {card}; torch {torch.__version__}; root {os.path.abspath(args.root)}; "
          f"size {n}²", flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    for sigma in (0.8, 1.0, 1.2, 2.0, 4.0, 6.0) if "blur" in only else ():
        taps = len(blur.gaussian_taps(round(sigma, 6)))
        report(f"blur {n}x{n} sigma={sigma} taps={taps}",
               launches(lambda: blur.blur_plane_cuda(x, sigma), args.runs))
    bh = n // 4
    for sigma in (0.8, 1.2, 6.0) if "blur" in only else ():
        r = (len(blur.gaussian_taps(round(sigma, 6))) - 1) // 2
        band = x[:bh].contiguous()
        top, bot = x[n - r:].contiguous(), x[bh:bh + r].contiguous()
        report(f"blur block {bh}x{n} sigma={sigma} radius={r}",
               launches(lambda: blur.blur_block_cuda(band, top, bot, sigma), args.runs))
    if "jfa" in only:
        mask = torch.from_numpy((rng.random((n, n)) < 1e-2).astype(np.float32)).cuda()
        state = distance.pack_seeds(mask)
        steps = distance._jfa_steps(n, n)
        report(f"jfa {n}x{n} density 1e-2, ladder {steps}",
               launches(lambda: distance.jfa_propagate_cuda(state), args.runs))
    if "warp" in only:
        warp_rows(warp, make_mesh, shard_planes_rows, n, args.runs)
    return 0


def warp_rows(warp, make_mesh, shard_planes_rows, n: int, runs: int) -> None:
    """The dense, block and sharded warp of size² RGBA at (37°, 5) with a
    strength map in [-0.3, 1.3] holding NaN (as `chip_smoke.py` times it):
    device time per launch, and CUDA-event ms of one call and of ten calls
    back to back."""
    import torch

    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda() for _ in range(4)]
    m = rng.random((n, n), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::97] = np.nan
    strength = torch.from_numpy(m).cuda()
    b = warp.warp_bindings((37.0, 5.0))
    k, halo = b["k"], b["halo"]
    mesh = make_mesh(devices=["cuda:0"] * 4)
    sps = [shard_planes_rows(mesh, p) for p in planes]
    ss = shard_planes_rows(mesh, strength)
    halos = [sp.ring_halos(halo) for sp in sps]
    block = ([sp.bands[0] for sp in sps], ss.bands[0], k, [hs[0][0] for hs in halos],
             [hs[0][1] for hs in halos], 0, n)
    calls = {
        f"warp {n}x{n} RGBA (37, 5)": lambda: warp.warp_planes_cuda(planes, strength, k),
        f"warp block {n // 4}x{n} RGBA (37, 5) halo {halo}": lambda: warp.warp_block_cuda(*block),
        f"warp sharded {n}x{n} RGBA (37, 5) over 4 shards on cuda:0":
            lambda: warp.warp_planes_mesh(sps, ss, k, halo),
    }
    for label, fn in calls.items():
        report(label, launches(fn, runs))
        single, back = event_ms(fn, 1), event_ms(fn, 10)
        print(f"  events: {single:.4f} ms single call, {back:.4f} ms back to back, "
              f"host {single - back:.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
