#!/usr/bin/env python3
"""Single-plane cost of the dense kernels' batched instances, per kernel,
on one GPU.

    python3 scripts/batch_instance_ab.py [--order ABBA] [--runs 5]

The dense entries of csrc/jfa.cu and csrc/warp.cu are built twice: a
batched instance (the canvas from `blockIdx.z` at 64-bit batch strides) and
an instance for one plane without that arithmetic, which a batch of 1
launches. (The blur has one instance, which walks the tiles of every
canvas: its one-plane instance saved about 1.5% at sigma 1.2 and nothing
at larger sigmas, and went.) This script copies the package into
`out/batch_instance_ab/` (listed in `.gitignore`) with that dispatch
changed so that a batch of 1 launches the batched instance too (A: this
checkout, B: the copy), then runs `scripts/kernel_launch_times.py --only
blur,jfa,warp` on A and B in the order given, one process each, and prints
per kernel the device ms of the single-plane dense launches of every run
(the blur's rows are the same code on both sides). Each kernel's time is
its own profiler reading, so the table tells for each kernel apart whether
its one-plane instance is worth keeping. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(HERE, "out", "batch_instance_ab")

# (source, the one-plane dispatch, the same dispatch sending batch 1 to the
# batched instance, how often it occurs)
DISPATCH = (
    ("jfa.cu", "if (batch > 1) {", "if (batch >= 1) {", 2),
    ("warp.cu", "if (batch > 1) {", "if (batch >= 1) {", 1),
)

# the dense single-plane launches of kernel_launch_times.py's report
DENSE = re.compile(r"^((?:blur \d+x\d+ sigma=[\d.]+)|(?:jfa \d+x\d+)|(?:warp \d+x\d+ RGBA))"
                   r"\b.*?: (\d+) launches, ([\d.]+) ms device in all")


def make_copy() -> str:
    """The package copied to `COPY`, every batch-1 dispatch sent to the
    batched instance; returns the copy's root."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "kanter_core_tpu_torch"),
                    os.path.join(COPY, "kanter_core_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, old, new, count in DISPATCH:
        path = os.path.join(COPY, "kanter_core_tpu_torch", "csrc", name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != count:
            raise AssertionError(f"{name}: {text.count(old)} dispatches {old!r}, want {count}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return COPY


def run(root: str, runs: int) -> dict:
    """{kernel label: device ms} of one kernel_launch_times.py process on
    `root`; its output is echoed. A process that fails (the profiler losing
    a launch) is tried once more."""
    cmd = [sys.executable, os.path.join(HERE, "scripts", "kernel_launch_times.py"),
           "--root", root, "--only", "blur,jfa,warp", "--runs", str(runs)]
    for attempt in range(2):
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
        print(proc.stdout, end="", flush=True)
        if proc.returncode == 0:
            break
        print(proc.stderr[-2000:], end="", file=sys.stderr, flush=True)
    else:
        raise RuntimeError(f"kernel_launch_times.py failed twice on {root}")
    out = {}
    for line in proc.stdout.splitlines():
        m = DENSE.match(line)
        if m and int(m.group(2)) > 0:  # 0: the profiler saw none of its launches
            out[m.group(1)] = float(m.group(3))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--order", default="ABBA")
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    roots = {"A": HERE, "B": make_copy()}
    readings = [(side, run(roots[side], args.runs)) for side in args.order]
    print("\nsingle-plane device ms, A = one-plane instance, B = batched instance at batch 1")
    labels = list(dict.fromkeys(label for _, r in readings for label in r))
    print("kernel".ljust(28) + "".join(f"{side:>10}" for side, _ in readings))
    for label in labels:
        print(label.ljust(28) + "".join(f"{r.get(label, float('nan')):>10.4f}"
                                         for _, r in readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
