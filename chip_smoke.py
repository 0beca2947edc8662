#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kanter_core_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) on failure:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   no CUDA device → exit before printing any result;
2. build: compiles `csrc/blur.cu`, `csrc/jfa.cu` and `csrc/warp.cu` with
   nvcc from the checkout's sources, one compiler per source, all started
   together, and prints the build times and ptxas reports;
3. kernels against their plain torch versions on the card; every output
   must be bit-identical (0 mismatches on the int32 view). CUDA-event
   timings (median of 20 runs after warm-up) at 4096² of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed only, never used by the port):
   - blur at 4096² σ=0.8, 1.2, 6.0 and edge shapes (1×1, 5×4096 with 37
     taps, 97×411, 4096×1); library call: `F.conv2d` on `F.pad(circular)`
     input, the separable pair;
   - JFA, the full ladder on the packed i32 state: 4096² masks at seed
     density 1e-4 and 1e-2, seedless, all-seed and a tie storm (seeds on
     every other pixel); edge shapes 1×1, 5×4096, 97×411, 4096×1, 33×2049;
     no library call computes it;
   - Warp of 4096² RGBA at (37°, 5), (0°, 5), (90°, 64), (37°, 1000) with a
     strength map holding NaN and out-of-range values; edge shapes 1×1,
     97×411, 4096×1; library call: `F.grid_sample` on a circularly padded
     input;
4. PBR slice: `models.pbr_material_graph()` at 4096² through
   `TextureProcessor(device="cuda")` → `LiveGraph` → `buffer_rgba`, a 4096²
   height plane from `numpy.random.default_rng(0)`: all four maps, then an
   `ao_strength` Value edit (0.75→0.6) and an AO blur sigma edit (6.0→4.0),
   re-reading `ao` and `roughness` after each; the launch counters are set
   to 0 just before and the blur count must rise exactly on the renders
   that re-ran a Blur node;
5. flagship slice: `graphs.flagship_graph(4096)` through the same entry
   points with four 4096² gray inputs from `numpy.random.default_rng(0)`,
   on a live graph that keeps every node's data (`use_cache`, as an
   editing session does):
   read `out`, then the chain's `v` Value edit (0.96→0.93), the Distance
   spread edit (512→256) and the Warp intensity edit (5→9), re-reading `out`
   after each; counters set to 0 just before; the JFA kernel must launch 13
   times on the render, 0 on the Value edit, 13 on the Distance edit and 0
   on the Warp edit, the warp kernel once per read;
6. card vs CPU: the PBR sequence and the flagship sequence at 1024² on
   `device="cuda"` and on `device="cpu"` (the port's plain path); u8 exports
   must be identical and every f32 plane must have 0 mismatches;
7. the mesh route's block kernels against their plain versions on the card,
   0 mismatches: the blur block (`kanter_blur_block_f32`) on the four row
   blocks of a 4096² plane at σ=0.8, 1.2, 6.0 with ring halos taken from
   the plane, and on edge blocks (block_h == radius, widths 1 and 411); the
   warp block (`kanter_warp_block_f32`) on the four blocks of 4096² RGBA at
   (37°, 5) and (90°, 64) with NaN and out-of-range strength. Then the
   sharded calls (`blur_plane_sharded`, `warp_planes_mesh`, four shards)
   against the dense kernels on the whole 4096² plane, 0 mismatches. Timed:
   the block kernel on one 1024×4096 block, its plain version, one library
   call on the halo-extended block (`conv2d` pair, `grid_sample`), and the
   sharded call with its exchange, its plain form and the dense library
   call, each beside its bound;
8. the mesh slice: the PBR and flagship sequences of phases 4 and 5 at 4096²
   through `TextureProcessor(mesh=...)`, four shards (on `cuda:0..3` when
   four cards are visible, else all on `cuda:0`); every read's u8 export
   and every f32 plane must be bit-identical to the single-device card run
   of phases 4 and 5; counters set to 0 just before each sequence: the
   block kernels must launch exactly four times the dense kernels' counts
   of the single-device run, the dense blur and warp kernels 0 times, the
   JFA ladder as often as on one device; gathers exactly one per Distance
   evaluation and per export, one per plane read back by this script, and
   0 for every other cause;
9. mesh on the card vs mesh on the CPU: both sequences at 1024² over four
   shards; u8 identical, 0 f32 mismatches.

The second-to-last line is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CANVAS = 4096  # the main path's canvas, rows and columns

# Published peaks of one H100 SXM (NVIDIA data sheet and Hopper white paper)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
# 32-bit integer instructions per second: each of the 132 SMs executes them on
# its 64 INT32 lanes and (IMAD) its 128 FP32 lanes, at the 1.98 GHz boost
# clock (Hopper white paper); the data sheet lists no INT32 rate
INT32_OPS = 132 * (64 + 128) * 1.98e9
# integer operations per pixel and JFA step, counted from csrc/jfa.cu: per
# candidate 2 to unpack, 2 deltas, 2 abs, 4 for the two toroidal wraps, 2
# for d², 2 for the sentinel test and select, 3 to fold (the centre
# candidate does not fold); address arithmetic not counted
JFA_OPS_PER_PX_STEP = 9 * 17 - 3
# f32 operations per pixel of an RGBA warp, counted from csrc/warp.cu:
# 12 for the coordinates, 9 per plane for the lerp
WARP_FLOPS_PER_PX = 12 + 4 * 9


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mismatches(a, b) -> int:
    """Count of elements whose 32-bit patterns differ."""
    import torch

    a = a.contiguous().view(torch.int32)
    b = b.contiguous().view(torch.int32)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a != b).sum().item())


def time_cuda(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` over `runs` CUDA-event-timed calls. The
    events are on the current device; where `fn` also works on other cards,
    its end event waits for their streams first."""
    import torch

    here = torch.cuda.current_device()
    others = [d for d in range(torch.cuda.device_count()) if d != here]
    for _ in range(warmup):
        fn()
    for d in [here, *others]:
        torch.cuda.synchronize(d)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        for d in others:
            torch.cuda.current_stream(here).wait_stream(torch.cuda.current_stream(d))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least time the card could take in ms, which of the two bounds it)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def build_phase(kernels) -> None:
    """Build every kernel library at once, one nvcc per source."""
    times, errors = {}, {}

    def build(kernel):
        t0 = time.perf_counter()
        try:
            kernel.entry()
        except Exception as e:  # noqa: BLE001 — re-raised below, after every build ends
            errors[kernel.name] = e
        times[kernel.name] = time.perf_counter() - t0

    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for kernel in kernels:
        if kernel.name in errors:
            raise RuntimeError(f"building csrc/{kernel.name}.cu failed") from errors[kernel.name]
        log(f"build: csrc/{kernel.name}.cu in {times[kernel.name]:.2f} s")
        with open(kernel.path + ".log") as f:
            for line in f.read().strip().splitlines():
                log(f"  nvcc: {line}")


def blur_library(x, taps):
    """The separable wrap blur as PyTorch's convolution on circularly padded
    input (timed as a yardstick only)."""
    import torch
    import torch.nn.functional as F

    r = (len(taps) - 1) // 2
    t = torch.from_numpy(np.ascontiguousarray(taps)).to(x.device)
    v = F.conv2d(F.pad(x[None, None], (0, 0, r, r), mode="circular"), t.view(1, 1, -1, 1))
    return F.conv2d(F.pad(v, (r, r, 0, 0), mode="circular"), t.view(1, 1, 1, -1))[0, 0]


def blur_phase(kp_blur) -> dict:
    import torch

    rng = np.random.default_rng(1)
    shapes = [
        (4096, 4096, 0.8), (4096, 4096, 1.2), (4096, 4096, 6.0),
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
        taps = kp_blur.gaussian_taps(round(sigma, 6))
        log(f"kernel blur {h}x{w} sigma={sigma} taps={len(taps)}: "
            f"{bad} bit mismatches, max_abs_err={err}")
        if bad:
            raise AssertionError(f"blur kernel differs from plain at {h}x{w} σ={sigma}")
        if (h, w) == (4096, 4096):
            ms = time_cuda(lambda: kp_blur.blur_plane_cuda(x, sigma))
            plain_ms = time_cuda(lambda: kp_blur.blur_plane_plain(x, sigma))
            library_ms = time_cuda(lambda: blur_library(x, taps))
            lib_err = float((blur_library(x, taps) - want).abs().max().item())
            n = h * w
            bound, by = bound_ms(8.0 * n, 2 * 2 * len(taps) * n, FP32_FLOPS)
            log(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms:.4f} ms (max |library − plain| {lib_err:.3g}), "
                f"bound {bound:.4f} ms ({by})")
            timings.append({"shape": f"{h}x{w}", "sigma": sigma, "taps": len(taps),
                            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": bound, "bound_by": by})
    return {"max_abs_err": max_err, "timings": timings}


def jfa_mask(h, w, kind, rng):
    import torch

    if kind == "ties":
        m = np.zeros((h, w), np.float32)
        m[::2, ::2] = 1.0
        m[1::2, 1::2] = 1.0
    elif kind == "seedless":
        m = np.zeros((h, w), np.float32)
    elif kind == "all":
        m = np.ones((h, w), np.float32)
    else:
        m = (rng.random((h, w)) < float(kind)).astype(np.float32)
    return torch.from_numpy(m).cuda()


def jfa_phase(kp_dist) -> dict:
    import torch

    rng = np.random.default_rng(2)
    cases = [(4096, 4096, k) for k in ("1e-4", "1e-2", "seedless", "all", "ties")]
    cases += [(1, 1, "all"), (5, 4096, "1e-2"), (97, 411, "1e-2"), (4096, 1, "1e-2"),
              (33, 2049, "1e-3")]
    timings = []
    for h, w, kind in cases:
        state = kp_dist.pack_seeds(jfa_mask(h, w, kind, rng))
        got = kp_dist.jfa_propagate_cuda(state)
        want = kp_dist.jfa_propagate_plain(state)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        steps = kp_dist._jfa_steps(h, w)
        log(f"kernel jfa {h}x{w} mask={kind} steps={len(steps)}: {bad} bit mismatches")
        if bad:
            raise AssertionError(f"JFA kernel differs from plain at {h}x{w} mask={kind}")
        if (h, w) == (4096, 4096) and kind in ("1e-4", "1e-2"):
            ms = time_cuda(lambda: kp_dist.jfa_propagate_cuda(state))
            plain_ms = time_cuda(lambda: kp_dist.jfa_propagate_plain(state))
            n = h * w
            bound, by = bound_ms(8.0 * n * len(steps), JFA_OPS_PER_PX_STEP * n * len(steps),
                                 INT32_OPS)
            log(f"  time: kernel {ms:.4f} ms ({len(steps)} launches), plain {plain_ms:.4f} ms, "
                f"library none, bound {bound:.4f} ms ({by})")
            timings.append({"shape": f"{h}x{w}", "density": kind, "steps": len(steps),
                            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                            "bound_ms": bound, "bound_by": by})
    return {"max_abs_err": 0, "timings": timings}


def warp_library(planes, strength, k):
    """The warp as PyTorch's `grid_sample` (bilinear) on a circularly padded
    stack (timed as a yardstick only); returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    h, w = strength.shape
    kx, ky = (float(c) for c in k)
    pad = min(int(math.ceil(max(abs(kx), abs(ky)) / 2.0)) + 2, h, w)
    ms = torch.where(torch.isnan(strength), 0.5, torch.clamp(strength, 0.0, 1.0)) - 0.5
    u = torch.arange(w, device=strength.device, dtype=torch.float32)[None, :] + ms * kx
    v = torch.arange(h, device=strength.device, dtype=torch.float32)[:, None] + ms * ky
    gx = (u + pad) * (2.0 / (w + 2 * pad - 1)) - 1.0
    gy = (v + pad) * (2.0 / (h + 2 * pad - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None]
    stack = torch.stack(list(planes))[None]

    def run():
        padded = F.pad(stack, (pad, pad, pad, pad), mode="circular")
        return F.grid_sample(padded, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)[0]

    return run


def warp_phase(kp_warp) -> dict:
    import torch

    rng = np.random.default_rng(3)
    cases = [(4096, 4096, p) for p in ((37.0, 5.0), (0.0, 5.0), (90.0, 64.0), (37.0, 1000.0))]
    cases += [(1, 1, (37.0, 5.0)), (97, 411, (37.0, 5.0)), (97, 411, (90.0, 64.0)),
              (4096, 1, (37.0, 5.0))]
    max_err = 0.0
    timings = []
    for h, w, payload in cases:
        planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda() for _ in range(4)]
        m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
        m.flat[::97] = np.nan
        strength = torch.from_numpy(m).cuda()
        k = kp_warp.warp_bindings(payload)["k"]
        got = kp_warp.warp_planes_cuda(planes, strength, k)
        want = kp_warp.warp_planes_plain(planes, strength, k)
        torch.cuda.synchronize()
        bad = sum(mismatches(g, r) for g, r in zip(got, want))
        err = max(float((g - r).abs().max().item()) for g, r in zip(got, want))
        max_err = max(max_err, err)
        log(f"kernel warp {h}x{w} RGBA angle={payload[0]} intensity={payload[1]}: "
            f"{bad} bit mismatches, max_abs_err={err}")
        if bad:
            raise AssertionError(f"warp kernel differs from plain at {h}x{w} {payload}")
        if (h, w) == (4096, 4096) and payload == (37.0, 5.0):
            ms = time_cuda(lambda: kp_warp.warp_planes_cuda(planes, strength, k))
            plain_ms = time_cuda(lambda: kp_warp.warp_planes_plain(planes, strength, k))
            library = warp_library(planes, strength, k)
            library_ms = time_cuda(library)
            lib_err = float((library() - torch.stack(list(want))).abs().max().item())
            n = h * w
            bound, by = bound_ms(36.0 * n, WARP_FLOPS_PER_PX * n, FP32_FLOPS)
            log(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms:.4f} ms (max |library − plain| {lib_err:.3g}), "
                f"bound {bound:.4f} ms ({by})")
            timings.append({"shape": f"{h}x{w}", "payload": list(payload), "ms": ms,
                            "plain_ms": plain_ms, "library_ms": library_ms,
                            "bound_ms": bound, "bound_by": by})
    return {"max_abs_err": max_err, "timings": timings}


def kernels():
    """(blur, distance, warp) op modules of the port."""
    from kanter_core_tpu_torch.ops import blur, distance, warp

    return blur, distance, warp


def launch_counts() -> dict:
    blur, distance, warp = kernels()
    return {"blur": blur.BLUR_KERNEL.launches, "jfa": distance.JFA_KERNEL.launches,
            "warp": warp.WARP_KERNEL.launches, "blur_block": blur.BLUR_BLOCK_KERNEL.launches,
            "warp_block": warp.WARP_BLOCK_KERNEL.launches}


def reset_counts() -> None:
    from kanter_core_tpu_torch.parallel import MESH_COUNTERS

    blur, distance, warp = kernels()
    blur.BLUR_KERNEL.launches = 0
    blur.BLUR_BLOCK_KERNEL.launches = 0
    distance.JFA_KERNEL.launches = 0
    warp.WARP_KERNEL.launches = 0
    warp.WARP_BLOCK_KERNEL.launches = 0
    MESH_COUNTERS.reset()


class Session:
    """A processor and live graph on `device`, read through `buffer_rgba`;
    `results` collects (label, output name, [f32 planes], u8 bytes),
    `counts` the launch counters after each read group and `mesh_counts`
    the mesh counters; `mesh` shards the processor."""

    def __init__(self, device, n, graph, bound, timed, keep=False, mesh=None):
        import torch
        from kanter_core_tpu_torch import SlotData, SlotId, SlotImage, TextureProcessor
        from kanter_core_tpu_torch.convert import planes_from_numpy

        self.torch, self.SlotId, self.TP = torch, SlotId, TextureProcessor
        self.n, self.timed, self.mesh = n, timed, mesh
        self.results, self.counts, self.mesh_counts = [], [], []
        self.planes_read = 0
        self.tp = TextureProcessor(memory_threshold=16 << 30, device=device, mesh=mesh)
        if timed:
            for d in self.devices():
                torch.cuda.reset_peak_memory_stats(d)
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
            g.use_cache = keep
            g.set_node_graph(graph)
            for node_id, plane in bound:
                (plane,) = planes_from_numpy([plane], self.tp.device)
                g.add_input_slot_data(SlotData(node_id, SlotId(0), SlotImage.Gray(plane)))
        self.outputs = {
            graph.node(o).node_type.payload: o for o in graph.output_ids()
        }

    def read(self, label, names):
        n = self.n
        for name in names:
            oid = self.outputs[name]
            t0 = time.perf_counter()
            px = self.TP.buffer_rgba(self.lg, oid, self.SlotId(0))
            if self.tp.device.type == "cuda":
                self.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if px.shape != (n * n * 4,):
                raise AssertionError(f"{name}: {px.shape} bytes, want {n * n * 4}")
            image = self.lg.slot_data(oid, self.SlotId(0)).image
            planes = [p.host_data().copy() for p in image.planes]
            self.planes_read += len(planes)
            if not all(p.shape == (n, n) and np.isfinite(p).all() for p in planes):
                raise AssertionError(f"{name}: non-finite values or a wrong shape")
            self.results.append((label, name, planes, px))
            if self.timed:
                where = "" if self.tp.mesh is None else " mesh"
                log(f"slice{where} {n}x{n} {label} read {name}: {ms:.3f} ms wall")
        self.counts.append(launch_counts())
        if self.tp.mesh is not None:
            from kanter_core_tpu_torch.parallel import MESH_COUNTERS

            self.mesh_counts.append(dict(MESH_COUNTERS.snapshot(), planes_read=self.planes_read,
                                         reads=len(self.results)))

    def node(self, kind, pred=lambda p: True):
        return next(x.node_id for x in self.lg.node_graph.nodes
                    if x.node_type.kind == kind and pred(x.node_type.payload))

    def finish(self):
        if self.lg.fatal_error is not None:
            raise self.lg.fatal_error
        if self.timed:
            torch = self.torch
            peaks = ", ".join(
                f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.3f} GiB "
                f"(reserved {torch.cuda.memory_reserved(d) / 2**30:.3f} GiB)"
                for d in self.devices()
            )
            log(f"slice metrics: {json.dumps(self.tp.metrics()['recipe_cache'])}, "
                f"peak device memory of this sequence {peaks}")

    def devices(self) -> list:
        mesh = self.tp.mesh
        return sorted({str(d) for d in (mesh.devices if mesh is not None else [self.tp.device])})

    def close(self):
        """Shut the processor down and drop it and its live graph, so that a
        session kept for its results holds no device memory. The planes and
        their buffer queue refer to each other, so only the cyclic collector
        frees them: collect now, or the next sequence's peak would count
        them."""
        self.tp.shutdown_now()
        self.tp = self.lg = None
        gc.collect()


def drive_pbr(device: str, n: int, seed: int = 0, timed: bool = False, mesh=None):
    """Render pbr_material_graph at n² on `device` (sharded over `mesh`),
    then the Value edit and the sigma edit. Returns the session."""
    from kanter_core_tpu_torch import NodeType, NodeTypeKind
    from kanter_core_tpu_torch.models import pbr_material_graph

    graph = pbr_material_graph()
    (inp,) = [x.node_id for x in graph.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
    height = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    s = Session(device, n, graph, [(inp, height)], timed, mesh=mesh)
    try:
        ao_strength = s.node(NodeTypeKind.VALUE, lambda p: p == 0.75)
        ao_blur = s.node(NodeTypeKind.BLUR, lambda p: p == 6.0)
        if timed:
            reset_counts()
        s.read("render", ["normal", "ao", "roughness", "albedo"])
        with s.lg.write() as g:
            g.node_mut(ao_strength).node_type = NodeType.Value(0.6)
        s.read("value-edit", ["ao", "roughness"])
        s.lg.set_blur_sigma(ao_blur, 4.0)
        s.read("sigma-edit", ["ao", "roughness"])
        s.finish()
    finally:
        s.close()
    return s


def drive_flagship(device: str, n: int, timed: bool = False, mesh=None):
    """Render the flagship's `out` at n² on `device` (sharded over `mesh`),
    then the chain Value edit, the Distance edit and the Warp edit,
    re-reading after each. Returns the session."""
    from kanter_core_tpu_torch import NodeType, NodeTypeKind
    from kanter_core_tpu_torch.graphs import flagship_graph

    graph, inputs, _ = flagship_graph(n)
    rng = np.random.default_rng(0)
    bound = [(i, rng.random((n, n), dtype=np.float32)) for i in inputs]
    # an editing session keeps every node's data (`use_cache`): with the
    # default, a clean parent's planes are dropped once its children are done
    # and come back from the recipe cache, whose 1 GiB budget holds only 16
    # planes of 4096², so an edit would re-run Distance and AO
    s = Session(device, n, graph, bound, timed, keep=True, mesh=mesh)
    try:
        v = s.node(NodeTypeKind.VALUE, lambda p: p != 1.0)
        dist = s.node(NodeTypeKind.DISTANCE)
        warp = s.node(NodeTypeKind.WARP)
        if timed:
            reset_counts()
        s.read("render", ["out"])
        with s.lg.write() as g:
            g.node_mut(v).node_type = NodeType.Value(0.93)
        s.read("value-edit", ["out"])
        s.lg.set_distance(dist, n / 16.0)
        s.read("distance-edit", ["out"])
        s.lg.set_warp(warp, 37.0, 9.0)
        s.read("warp-edit", ["out"])
        s.finish()
    finally:
        s.close()
    return s


def compare_runs(label, a, b, what="card vs cpu") -> None:
    """Every read of run `a` against the same read of run `b`: u8 equal and
    0 f32 mismatches on every plane."""
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} reads against {len(b)}")
    ok = True
    for (step, name, ap, au8), (_, _, bp, bu8) in zip(a, b):
        counts = [int((x.view(np.int32) != y.view(np.int32)).sum()) for x, y in zip(ap, bp)]
        same = np.array_equal(au8, bu8) and len(ap) == len(bp)
        ok &= same and not any(counts)
        log(f"{what} {label} {ap[0].shape[0]}x{ap[0].shape[1]} {step} {name}: "
            f"f32 mismatches per plane {counts}, u8 identical {same}")
    if not ok:
        raise AssertionError(f"{what} {label}: the runs disagree")


def blur_block_library(block, top, bot, taps):
    """The block blur as PyTorch's convolution pair on the halo-extended
    block (timed as a yardstick only)."""
    import torch
    import torch.nn.functional as F

    r = (len(taps) - 1) // 2
    t = torch.from_numpy(np.ascontiguousarray(taps)).to(block.device)
    ext = torch.cat([top, block, bot])[None, None]
    v = F.conv2d(ext, t.view(1, 1, -1, 1))
    return F.conv2d(F.pad(v, (r, r, 0, 0), mode="circular"), t.view(1, 1, 1, -1))[0, 0]


def blur_sharded_plain(kp_blur, sp, sigma):
    """The plain form of the sharded blur: the same exchange, then the plain
    block version on every shard."""
    r = (len(kp_blur.gaussian_taps(round(sigma, 6))) - 1) // 2
    return [kp_blur.blur_block_plain(b, t, o, sigma) for b, (t, o) in zip(sp.bands, sp.ring_halos(r))]


def blur_block_phase(kp_blur, mesh) -> dict:
    """Phase 7, blur: block kernel vs plain on every block, sharded vs
    dense, and the timings."""
    import torch
    from kanter_core_tpu_torch.parallel import shard_planes_rows

    rng = np.random.default_rng(4)
    n = mesh.n
    cases = [(CANVAS, CANVAS, 0.8), (CANVAS, CANVAS, 1.2), (CANVAS, CANVAS, 6.0),
             (4 * 19, 411, 6.0), (4 * 18, 411, 6.0), (4 * 18, 1, 6.0), (4 * 3, 411, 0.8)]
    max_err = 0.0
    timings = []
    for h, w, sigma in cases:
        x = torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda()
        taps = kp_blur.gaussian_taps(round(sigma, 6))
        r = (len(taps) - 1) // 2
        sp = shard_planes_rows(mesh, x.to(mesh.devices[0]))
        bad = 0
        for band, (top, bot) in zip(sp.bands, sp.ring_halos(r)):
            got = kp_blur.blur_block_cuda(band, top, bot, sigma)
            want = kp_blur.blur_block_plain(band, top, bot, sigma)
            torch.cuda.synchronize()
            bad += mismatches(got, want)
            max_err = max(max_err, float((got - want).abs().max().item()))
        sharded = torch.cat([b.to(x.device) for b in kp_blur.blur_plane_sharded(sp, sigma).bands])
        dense = kp_blur.blur_plane_cuda(x, sigma)
        torch.cuda.synchronize()
        bad_sharded = mismatches(sharded, dense)
        log(f"kernel blur block {h}x{w} in {n} blocks of {h // n} rows sigma={sigma} radius={r}: "
            f"{bad} bit mismatches vs plain; sharded vs dense kernel {bad_sharded} mismatches")
        if bad or bad_sharded:
            raise AssertionError(f"blur block kernel differs at {h}x{w} σ={sigma}")
        if (h, w) != (CANVAS, CANVAS):
            continue
        band, (top, bot) = sp.bands[0], sp.ring_halos(r)[0]  # on the first device
        bh = band.shape[0]
        ms = time_cuda(lambda: kp_blur.blur_block_cuda(band, top, bot, sigma))
        plain_ms = time_cuda(lambda: kp_blur.blur_block_plain(band, top, bot, sigma))
        library_ms = time_cuda(lambda: blur_block_library(band, top, bot, taps))
        lib_err = float((blur_block_library(band, top, bot, taps)
                         - kp_blur.blur_block_plain(band, top, bot, sigma)).abs().max().item())
        bound, by = bound_ms(8.0 * bh * w + 2 * r * w * 4, 2 * 2 * len(taps) * bh * w, FP32_FLOPS)
        s_ms = time_cuda(lambda: kp_blur.blur_plane_sharded(sp, sigma))
        s_plain_ms = time_cuda(lambda: blur_sharded_plain(kp_blur, sp, sigma))
        s_library_ms = time_cuda(lambda: blur_library(x, taps))
        s_bound, s_by = bound_ms(8.0 * h * w + n * 2 * r * w * 4, 2 * 2 * len(taps) * h * w,
                                 FP32_FLOPS)
        log(f"  time: block {bh}x{w} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms (max |library − plain| {lib_err:.3g}), bound {bound:.4f} ms "
            f"({by}); sharded {h}x{w} over {n}: {s_ms:.4f} ms with its exchange, plain "
            f"{s_plain_ms:.4f} ms, library {s_library_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by})")
        timings.append({"shape": f"{bh}x{w}", "sigma": sigma, "taps": len(taps), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                        "bound_by": by,
                        "sharded": {"shape": f"{h}x{w}", "shards": n, "ms": s_ms,
                                    "plain_ms": s_plain_ms, "library_ms": s_library_ms,
                                    "bound_ms": s_bound, "bound_by": s_by}})
    return {"max_abs_err": max_err, "timings": timings}


def warp_block_library(blocks, strength, k, tops, bots, row_origin, h):
    """The block warp as PyTorch's `grid_sample` (bilinear) on the
    halo-extended block, circularly padded across its width (timed as a
    yardstick only); returns a function of no arguments."""
    import torch
    import torch.nn.functional as F

    bh, w = strength.shape
    halo = tops[0].shape[0]
    kx, ky = (float(c) for c in k)
    pad = min(int(math.ceil(abs(kx) / 2.0)) + 2, w)
    ms = torch.where(torch.isnan(strength), 0.5, torch.clamp(strength, 0.0, 1.0)) - 0.5
    u = torch.arange(w, device=strength.device, dtype=torch.float32)[None, :] + ms * kx
    v = torch.arange(bh, device=strength.device, dtype=torch.float32)[:, None] + ms * ky + halo
    gx = (u + pad) * (2.0 / (w + 2 * pad - 1)) - 1.0
    gy = v * (2.0 / (bh + 2 * halo - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None]
    ext = torch.stack([torch.cat([t, b, o]) for t, b, o in zip(tops, blocks, bots)])[None]

    def run():
        padded = F.pad(ext, (pad, pad, 0, 0), mode="circular")
        return F.grid_sample(padded, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)[0]

    return run


def warp_block_phase(kp_warp, mesh) -> dict:
    """Phase 7, warp: block kernel vs plain on every block, sharded vs
    dense, and the timings."""
    import torch
    from kanter_core_tpu_torch.parallel import shard_planes_rows

    rng = np.random.default_rng(5)
    n = mesh.n
    h = w = CANVAS
    max_err = 0.0
    timings = []
    for payload in ((37.0, 5.0), (90.0, 64.0)):
        planes = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda() for _ in range(4)]
        m = rng.random((h, w), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
        m.flat[::97] = np.nan
        strength = torch.from_numpy(m).cuda()
        b = kp_warp.warp_bindings(payload)
        k, halo = b["k"], b["halo"]
        sps = [shard_planes_rows(mesh, p.to(mesh.devices[0])) for p in planes]
        ss = shard_planes_rows(mesh, strength.to(mesh.devices[0]))
        halos = [sp.ring_halos(halo) for sp in sps]
        bh = h // n

        def block_args(j):
            return ([sp.bands[j] for sp in sps], ss.bands[j], k,
                    [hs[j][0] for hs in halos], [hs[j][1] for hs in halos], j * bh, h)

        bad = 0
        for j in range(n):
            got = kp_warp.warp_block_cuda(*block_args(j))
            want = kp_warp.warp_block_plain(*block_args(j))
            torch.cuda.synchronize()
            bad += sum(mismatches(g, r) for g, r in zip(got, want))
            max_err = max([max_err] + [float((g - r).abs().max().item()) for g, r in zip(got, want)])
        sharded = kp_warp.warp_planes_mesh(sps, ss, k, halo)
        dense = kp_warp.warp_planes_cuda(planes, strength, k)
        torch.cuda.synchronize()
        bad_sharded = sum(mismatches(torch.cat([b.to(d.device) for b in s.bands]), d)
                          for s, d in zip(sharded, dense))
        log(f"kernel warp block {h}x{w} RGBA in {n} blocks angle={payload[0]} "
            f"intensity={payload[1]} halo={halo}: {bad} bit mismatches vs plain; sharded vs "
            f"dense kernel {bad_sharded} mismatches")
        if bad or bad_sharded:
            raise AssertionError(f"warp block kernel differs at {payload}")
        if payload != (37.0, 5.0):
            continue
        args = block_args(0)  # on the first device
        ms = time_cuda(lambda: kp_warp.warp_block_cuda(*args))
        plain_ms = time_cuda(lambda: kp_warp.warp_block_plain(*args))
        library = warp_block_library(*args)
        library_ms = time_cuda(library)
        lib_err = float((library() - torch.stack(list(kp_warp.warp_block_plain(*args))))
                        .abs().max().item())
        halo_bytes = 4 * 2 * halo * w * 4
        bound, by = bound_ms(36.0 * bh * w + halo_bytes, WARP_FLOPS_PER_PX * bh * w, FP32_FLOPS)

        def sharded_plain():
            hs = [sp.ring_halos(halo) for sp in sps]
            return [kp_warp.warp_block_plain([sp.bands[j] for sp in sps], ss.bands[j], k,
                                             [x[j][0] for x in hs], [x[j][1] for x in hs],
                                             j * bh, h) for j in range(n)]

        s_ms = time_cuda(lambda: kp_warp.warp_planes_mesh(sps, ss, k, halo))
        s_plain_ms = time_cuda(sharded_plain)
        s_library_ms = time_cuda(warp_library(planes, strength, k))
        s_bound, s_by = bound_ms(36.0 * h * w + n * halo_bytes, WARP_FLOPS_PER_PX * h * w,
                                 FP32_FLOPS)
        log(f"  time: block {bh}x{w} RGBA kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms (max |library − plain| {lib_err:.3g}), bound {bound:.4f} ms "
            f"({by}); sharded {h}x{w} over {n}: {s_ms:.4f} ms with its exchange, plain "
            f"{s_plain_ms:.4f} ms, library {s_library_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by})")
        timings.append({"shape": f"{bh}x{w}", "payload": list(payload), "ms": ms,
                        "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
                        "bound_by": by,
                        "sharded": {"shape": f"{h}x{w}", "shards": n, "ms": s_ms,
                                    "plain_ms": s_plain_ms, "library_ms": s_library_ms,
                                    "bound_ms": s_bound, "bound_by": s_by}})
    return {"max_abs_err": max_err, "timings": timings}


def check_mesh_run(label, single, sharded, steps) -> None:
    """The mesh run's launch and gather counts against the single-device
    run of the same sequence: per read group, the block kernels 4× (one
    launch per shard) the dense kernels' counts, the dense blur and warp
    kernels 0, the JFA ladder the same; gathers one per Distance
    evaluation, per export and per plane read back, else 0."""
    n = sharded.mesh.n
    log(f"mesh {label} launches after each read group: {sharded.counts}")
    log(f"mesh {label} mesh counters after each read group: {sharded.mesh_counts}")
    if len(single.counts) != len(sharded.counts):
        raise AssertionError(f"mesh {label}: {len(sharded.counts)} read groups, want "
                             f"{len(single.counts)}")
    for one, many, mc in zip(single.counts, sharded.counts, sharded.mesh_counts):
        want = {"blur": 0, "warp": 0, "jfa": one["jfa"], "blur_block": n * one["blur"],
                "warp_block": n * one["warp"]}
        if many != want:
            raise AssertionError(f"mesh {label}: launches {many}, want {want}")
        want_g = {"distance": many["jfa"] // steps, "blur_gate": 0, "warp_gate": 0,
                  "resize": 0, "export": mc["reads"], "host": mc["planes_read"]}
        if mc["gathers"] != want_g:
            raise AssertionError(f"mesh {label}: gathers {mc['gathers']}, want {want_g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device")
        return 1
    sys.path.insert(0, ROOT)
    kp_blur, kp_dist, kp_warp = kernels()

    if any(m == "jax" or m.startswith("jax.") or m.startswith("kanter_core_tpu.")
           or m == "kanter_core_tpu" for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    # the library yardsticks compute in full f32 (cuDNN would take TF32)
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    log(card_line())  # name, power limit — exactly as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}"
        f" device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build, one nvcc per source, together; the block entries live in the
    # same libraries
    t_phase = time.perf_counter()
    build_phase([kp_blur.BLUR_KERNEL, kp_dist.JFA_KERNEL, kp_warp.WARP_KERNEL])
    kp_blur.BLUR_BLOCK_KERNEL.entry()
    kp_warp.WARP_BLOCK_KERNEL.entry()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase:.1f} s")
        t_phase = now

    phase_done("build")

    # 3. kernels vs plain
    blur = blur_phase(kp_blur)
    jfa = jfa_phase(kp_dist)
    warp = warp_phase(kp_warp)
    phase_done("kernels")

    # 4. the PBR slice at full size, counters from 0
    pbr = drive_pbr("cuda", 4096, timed=True)
    pbr_counts = pbr.counts
    blur_runs = [c["blur"] for c in pbr_counts]
    log(f"PBR launches after each read group (render, value edit, sigma edit): {pbr_counts}")
    render, value_edit, sigma_edit = blur_runs
    if render < 2:
        raise AssertionError("the first render did not launch the blur kernel for both Blur nodes")
    if value_edit != render:
        raise AssertionError("the Value edit re-ran a Blur node")
    if sigma_edit <= value_edit:
        raise AssertionError("the sigma edit did not launch the blur kernel")
    pbr_path = pbr_counts[-1]

    # 5. the flagship at full size, counters from 0
    flag = drive_flagship("cuda", 4096, timed=True)
    flag_counts = flag.counts
    log(f"flagship launches after each read (render, value, distance, warp edit): {flag_counts}")
    steps = len(kp_dist._jfa_steps(4096, 4096))
    want_jfa = [steps, steps, 2 * steps, 2 * steps]
    if [c["jfa"] for c in flag_counts] != want_jfa:
        raise AssertionError(f"JFA launches {[c['jfa'] for c in flag_counts]}, want {want_jfa}")
    if [c["warp"] for c in flag_counts] != [1, 2, 3, 4]:
        raise AssertionError(f"warp launches {[c['warp'] for c in flag_counts]}, want [1, 2, 3, 4]")
    b = [c["blur"] for c in flag_counts]
    if not (b[0] == 7 and b[1] == 14 and b[2] == 21 and b[3] == 21):
        raise AssertionError(f"blur launches {b}, want [7, 14, 21, 21] (3 AO + 4 RGBA planes)")
    flag_path = flag_counts[-1]
    phase_done("single-device slices")

    # 6. card vs CPU at 1024²
    compare_runs("pbr", drive_pbr("cuda", 1024).results, drive_pbr("cpu", 1024).results)
    compare_runs("flagship", drive_flagship("cuda", 1024).results,
                 drive_flagship("cpu", 1024).results)
    phase_done("card vs cpu")

    # 7. the mesh route's block kernels and sharded calls
    from kanter_core_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() >= 4:
        mesh = make_mesh(4)
        log(f"mesh: four shards on four cards {[str(d) for d in mesh.devices]}")
    else:
        mesh = make_mesh(devices=["cuda:0"] * 4)
        log("mesh: four shards, all on cuda:0 (fewer than four cards visible); the "
            "transfers between distinct cards are not exercised")
    blur_block = blur_block_phase(kp_blur, mesh)
    warp_block = warp_block_phase(kp_warp, mesh)
    phase_done("block kernels")

    # 8. the mesh slice at full size against the single-device run, counters
    # from 0 before each sequence
    mesh_pbr = drive_pbr("cuda", 4096, timed=True, mesh=mesh)
    check_mesh_run("pbr", pbr, mesh_pbr, steps)
    mesh_pbr_path = mesh_pbr.counts[-1]
    compare_runs("pbr", mesh_pbr.results, pbr.results, "mesh vs single device")
    mesh_flag = drive_flagship("cuda", 4096, timed=True, mesh=mesh)
    check_mesh_run("flagship", flag, mesh_flag, steps)
    mesh_flag_path = mesh_flag.counts[-1]
    compare_runs("flagship", mesh_flag.results, flag.results, "mesh vs single device")
    del pbr, flag, mesh_pbr, mesh_flag
    phase_done("mesh slices")

    # 9. mesh on the card against mesh on the CPU at 1024²
    cpu_mesh = make_mesh(devices=["cpu"] * 4)
    compare_runs("pbr", drive_pbr("cuda", 1024, mesh=mesh).results,
                 drive_pbr("cpu", 1024, mesh=cpu_mesh).results, "mesh card vs mesh cpu")
    compare_runs("flagship", drive_flagship("cuda", 1024, mesh=mesh).results,
                 drive_flagship("cpu", 1024, mesh=cpu_mesh).results, "mesh card vs mesh cpu")
    phase_done("mesh card vs cpu")

    def entry(name, source, replaces, launches, phase, main, by_path):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": phase["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "timings": phase["timings"],
        }

    def by_path(key):
        return {"pbr": pbr_path[key], "flagship": flag_path[key],
                "mesh_pbr": mesh_pbr_path[key], "mesh_flagship": mesh_flag_path[key]}

    log(json.dumps({"kernels": [
        entry("kanter_blur_wrap_f32", "kanter_core_tpu_torch/csrc/blur.cu",
              "kanter_core_tpu/ops/pallas_blur.py:77",
              pbr_path["blur"] + flag_path["blur"], blur,
              next(t for t in blur["timings"] if t["sigma"] == 6.0), by_path("blur")),
        entry("kanter_jfa_step_i32", "kanter_core_tpu_torch/csrc/jfa.cu",
              "kanter_core_tpu/ops/pallas_distance.py:90",
              flag_path["jfa"], jfa, jfa["timings"][-1], by_path("jfa")),
        entry("kanter_warp_bilinear_f32", "kanter_core_tpu_torch/csrc/warp.cu",
              "kanter_core_tpu/ops/pallas_warp.py:147",
              flag_path["warp"], warp, warp["timings"][0], by_path("warp")),
        entry("kanter_blur_block_f32", "kanter_core_tpu_torch/csrc/blur.cu",
              "kanter_core_tpu/ops/pallas_blur.py:419",
              mesh_pbr_path["blur_block"] + mesh_flag_path["blur_block"], blur_block,
              next(t for t in blur_block["timings"] if t["sigma"] == 6.0),
              by_path("blur_block")),
        entry("kanter_warp_block_f32", "kanter_core_tpu_torch/csrc/warp.cu",
              "kanter_core_tpu/ops/pallas_warp.py:306",
              mesh_flag_path["warp_block"], warp_block, warp_block["timings"][0],
              by_path("warp_block")),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
