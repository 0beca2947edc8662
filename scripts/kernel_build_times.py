#!/usr/bin/env python3
"""Time the build of a checkout's three kernel sources, as `chip_smoke.py`
builds them: one nvcc per source, all started together, into an emptied
build directory; each source's own time is printed beside the total.

    python3 scripts/kernel_build_times.py DIR [DIR ...]

Each DIR is the root of a checkout holding `kanter_core_tpu_torch`; name two
checkouts in turns (parent, change, change, parent) to compare them inside
one call. A fresh process per DIR, since a library loads once. Needs nvcc.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import threading
import time


def build(root: str) -> tuple:
    """(seconds for the three sources together, {source: its own seconds})."""
    sys.path.insert(0, os.path.abspath(root))
    from kanter_core_tpu_torch import build as port_build
    from kanter_core_tpu_torch.ops import blur, distance, warp

    shutil.rmtree(port_build.BUILD_DIR, ignore_errors=True)
    kernels = [blur.BLUR_KERNEL, distance.JFA_KERNEL, warp.WARP_KERNEL]
    each = {}

    def timed(kernel):
        start = time.perf_counter()
        kernel.entry()
        each[f"csrc/{kernel.name}.cu"] = time.perf_counter() - start

    t0 = time.perf_counter()
    threads = [threading.Thread(target=timed, args=(k,)) for k in kernels]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, each


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if len(sys.argv) == 2:
        seconds, each = build(sys.argv[1])
        print(f"{sys.argv[1]}: the three sources together in {seconds:.2f} s ("
              + ", ".join(f"{name} {t:.2f} s" for name, t in sorted(each.items())) + ")",
              flush=True)
        return 0
    for root in sys.argv[1:]:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), root]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
