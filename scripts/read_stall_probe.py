#!/usr/bin/env python3
"""Run a script of the PyTorch/CUDA port (by default `chip_smoke.py`) and
explain its slow reads.

    python3 scripts/read_stall_probe.py [--slow-ms 150] [--sample-ms 5] [script.py [args...]]

Every `TextureProcessor.buffer_rgba` call that takes at least `--slow-ms`
of wall time gets a line of its own, printed just before the script's own
line for that read: its wall ms, the garbage collector's pauses inside it,
the CUDA caching allocator's new segments (`cudaMalloc` calls) and retries
inside it, and the code locations most often on top of the stacks of the
process's busy threads while it ran (every thread is sampled each
`--sample-ms`; idle waits are left out). The package is imported from the
directory of the script, so one copy of this probe can drive another
checkout's `chip_smoke.py`:

    cd <checkout> && python3 <this repo>/scripts/read_stall_probe.py chip_smoke.py
"""

from __future__ import annotations

import argparse
import collections
import gc
import linecache
import os
import runpy
import sys
import threading
import time

# innermost frames of a thread that waits rather than works
_IDLE = {("threading.py", "wait"), ("threading.py", "_wait_for_tstate_lock"),
         ("queue.py", "get"), ("selectors.py", "select"), ("threading.py", "join")}


class _Sampler(threading.Thread):
    """Counts the innermost frame of every busy thread each `interval`
    seconds while `active` is set."""

    def __init__(self, interval: float):
        super().__init__(name="read-stall-probe", daemon=True)
        self.interval = interval
        self.active = threading.Event()
        self.counts = collections.Counter()
        self.samples = 0

    def run(self) -> None:
        me = threading.get_ident()
        while True:
            self.active.wait()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                code = frame.f_code
                where = (os.path.basename(code.co_filename), code.co_name)
                line = linecache.getline(code.co_filename, frame.f_lineno).strip()
                if where in _IDLE or line.startswith("time.sleep("):
                    continue
                self.counts[f"{where[0]}:{frame.f_lineno} {where[1]}"] += 1
            self.samples += 1
            time.sleep(self.interval)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--slow-ms", type=float, default=150.0)
    parser.add_argument("--sample-ms", type=float, default=5.0)
    parser.add_argument("script", nargs="?", default="chip_smoke.py")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    opts = parser.parse_args()
    script = os.path.abspath(opts.script)
    sys.path.insert(0, os.path.dirname(script))

    import torch
    from kanter_core_tpu_torch.texture_processor import TextureProcessor

    pauses = []  # (start, generation, ms) of every collection

    def on_gc(phase, info, _start=[0.0]):
        now = time.perf_counter()
        if phase == "start":
            _start[0] = now
        else:
            pauses.append((_start[0], info["generation"], (now - _start[0]) * 1e3))

    gc.callbacks.append(on_gc)
    sampler = _Sampler(opts.sample_ms / 1e3)
    sampler.start()

    def allocator() -> tuple:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return 0, 0
        stats = torch.cuda.memory_stats()
        return stats.get("segment.all.allocated", 0), stats.get("num_alloc_retries", 0)

    original = TextureProcessor.buffer_rgba

    def buffer_rgba(*args, **kwargs):
        segments, retries = allocator()
        sampler.counts.clear()
        sampler.samples = 0
        t0 = time.perf_counter()
        sampler.active.set()
        try:
            return original(*args, **kwargs)
        finally:
            sampler.active.clear()
            ms = (time.perf_counter() - t0) * 1e3
            if ms >= opts.slow_ms:
                inside = [f"gen{g} {p:.1f} ms" for s, g, p in pauses if s >= t0 and p >= 1.0]
                segments2, retries2 = allocator()
                top = "; ".join(f"{where} ×{n}" for where, n in sampler.counts.most_common(6))
                print(f"probe: slow buffer_rgba {ms:.3f} ms: gc pauses ≥1 ms {inside or 'none'}; "
                      f"cudaMalloc +{segments2 - segments}, alloc retries +{retries2 - retries}; "
                      f"{sampler.samples} samples, busy frames: {top or 'none'}", flush=True)

    TextureProcessor.buffer_rgba = staticmethod(buffer_rgba)
    sys.argv = [script, *opts.args]
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
