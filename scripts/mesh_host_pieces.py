#!/usr/bin/env python3
"""What passing the ring halos by device address buys the mesh route's
kernel drivers, on one GPU.

    python3 scripts/mesh_host_pieces.py [--size 4096] [--rounds 10]

The sharded warp (`ops/warp.warp_planes_mesh`, RGBA at (37°, 5)) and the
sharded blur (`ops/blur.blur_plane_sharded`, sigma 0.8 and 6.0) of a size²
plane over four shards on `cuda:0` are timed in one process as they run
(`full`: `ShardedPlane.ring_halo_addresses` passes the halos by device
address) and with the halos as `ring_halos`' views (`views`: the addresses
are the views', which stay alive through the call).

Each round times both variants, in an order alternated by the round:
CUDA events around one call and around ten calls back to back (median of
20 each). Printed per variant and call: the median over the rounds and its
quartiles, in ms. The views variant's outputs are checked bit for bit
against the full route's first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))


def view_addresses(self, r):
    """`ring_halo_addresses` through `ring_halos`' views."""
    halos = self.ring_halos(r)
    return [t.data_ptr() for t, _ in halos], [b.data_ptr() for _, b in halos], halos


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--rounds", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mesh_host_pieces: no CUDA device", file=sys.stderr)
        return 1
    from kernel_launch_times import event_ms

    from kanter_core_tpu_torch.ops import blur, warp
    from kanter_core_tpu_torch.parallel import ShardedPlane, make_mesh, shard_planes_rows

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    n = args.size
    print(f"card: {card}; torch {torch.__version__}; size {n}²", flush=True)
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda() for _ in range(4)]
    m = rng.random((n, n), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::97] = np.nan
    mesh = make_mesh(devices=["cuda:0"] * 4)
    sps = [shard_planes_rows(mesh, p) for p in planes]
    ss = shard_planes_rows(mesh, torch.from_numpy(m).cuda())
    b = warp.warp_bindings((37.0, 5.0))
    calls = {
        "warp sharded RGBA (37, 5)": lambda: warp.warp_planes_mesh(sps, ss, b["k"], b["halo"]),
        "blur sharded sigma=0.8": lambda: (blur.blur_plane_sharded(sps[0], 0.8),),
        "blur sharded sigma=6.0": lambda: (blur.blur_plane_sharded(sps[0], 6.0),),
    }
    by_address = ShardedPlane.ring_halo_addresses
    variants = ["full", "views"]

    def use(variant):
        ShardedPlane.ring_halo_addresses = view_addresses if variant == "views" else by_address

    want = {label: [torch.cat(o.bands) for o in fn()] for label, fn in calls.items()}
    for variant in variants:
        use(variant)
        for label, fn in calls.items():
            got = [torch.cat(o.bands) for o in fn()]
            if not all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                       for g, r in zip(got, want[label])):
                raise AssertionError(f"{variant} changed {label}")
    readings = {(v, label): ([], []) for v in variants for label in calls}
    try:
        for rnd in range(args.rounds):
            shift = rnd % len(variants)
            for variant in variants[shift:] + variants[:shift]:
                use(variant)
                for label, fn in calls.items():
                    single, back = readings[variant, label]
                    single.append(event_ms(fn, 1))
                    back.append(event_ms(fn, 10))
    finally:
        use("full")
    for label in calls:
        print(label, flush=True)
        for variant in variants:
            parts = []
            for what, values in zip(("single call", "back to back"), readings[variant, label]):
                q1, med, q3 = np.percentile(values, [25, 50, 75])
                parts.append(f"{what} {med:.4f} [{q1:.4f}–{q3:.4f}]")
            print(f"  {variant:<11} " + ", ".join(parts) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
