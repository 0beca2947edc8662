#!/usr/bin/env python3
"""Wall time of every read of the PBR and flagship sequences of
`chip_smoke.py`, for one checkout, in a fresh process.

    python3 scripts/slice_read_times.py [--root DIR] [--size 4096] [--mesh N]

Imports `chip_smoke` and the port from `--root` (default: this checkout)
and runs that checkout's own `drive_pbr` and `drive_flagship` on `cuda`,
timed, so that two commits are compared with their own smoke's sequences:
run it alternately for both roots in one session on the card (parent,
change, change, parent, ...). `--mesh N` runs them over N row shards of
`cuda:0` instead (the mesh route, as `chip_smoke.py` drives it on one
card). It prints the card, then the smoke's own `slice ... read ...: <ms>
ms wall` lines. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--mesh", type=int, default=0, help="shards on cuda:0 (0: no mesh)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slice_read_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; root {os.path.abspath(args.root)}", flush=True)
    mesh = None
    if args.mesh:
        from kanter_core_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=["cuda:0"] * args.mesh)
    chip_smoke.drive_pbr("cuda", args.size, timed=True, mesh=mesh)
    chip_smoke.drive_flagship("cuda", args.size, timed=True, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
