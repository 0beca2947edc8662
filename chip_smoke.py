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
   must be identical and every f32 plane must have 0 mismatches.

The second-to-last line is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

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
            "warp": warp.WARP_KERNEL.launches}


def reset_counts() -> None:
    blur, distance, warp = kernels()
    blur.BLUR_KERNEL.launches = 0
    distance.JFA_KERNEL.launches = 0
    warp.WARP_KERNEL.launches = 0


class Session:
    """A processor and live graph on `device`, read through `buffer_rgba`;
    `results` collects (label, output name, [f32 planes], u8 bytes) and
    `counts` the launch counters after each read."""

    def __init__(self, device, n, graph, bound, timed, keep=False):
        import torch
        from kanter_core_tpu_torch import SlotData, SlotId, SlotImage, TextureProcessor
        from kanter_core_tpu_torch.convert import planes_from_numpy

        self.torch, self.SlotId, self.TP = torch, SlotId, TextureProcessor
        self.n, self.timed = n, timed
        self.results, self.counts = [], []
        self.tp = TextureProcessor(memory_threshold=16 << 30, device=device)
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
            if not all(p.shape == (n, n) and np.isfinite(p).all() for p in planes):
                raise AssertionError(f"{name}: non-finite values or a wrong shape")
            self.results.append((label, name, planes, px))
            if self.timed:
                log(f"slice {n}x{n} {label} read {name}: {ms:.3f} ms wall")
        self.counts.append(launch_counts())

    def node(self, kind, pred=lambda p: True):
        return next(x.node_id for x in self.lg.node_graph.nodes
                    if x.node_type.kind == kind and pred(x.node_type.payload))

    def finish(self):
        if self.lg.fatal_error is not None:
            raise self.lg.fatal_error
        if self.timed:
            log(f"slice metrics: {json.dumps(self.tp.metrics()['recipe_cache'])}, "
                f"peak device memory {self.torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    def close(self):
        self.tp.shutdown_now()


def drive_pbr(device: str, n: int, seed: int = 0, timed: bool = False):
    """Render pbr_material_graph at n² on `device`, then the Value edit and
    the sigma edit. Returns the session's results and launch counts."""
    from kanter_core_tpu_torch import NodeType, NodeTypeKind
    from kanter_core_tpu_torch.models import pbr_material_graph

    graph = pbr_material_graph()
    (inp,) = [x.node_id for x in graph.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
    height = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    s = Session(device, n, graph, [(inp, height)], timed)
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
    return s.results, s.counts


def drive_flagship(device: str, n: int, timed: bool = False):
    """Render the flagship's `out` at n² on `device`, then the chain Value
    edit, the Distance edit and the Warp edit, re-reading after each."""
    from kanter_core_tpu_torch import NodeType, NodeTypeKind
    from kanter_core_tpu_torch.graphs import flagship_graph

    graph, inputs, _ = flagship_graph(n)
    rng = np.random.default_rng(0)
    bound = [(i, rng.random((n, n), dtype=np.float32)) for i in inputs]
    # an editing session keeps every node's data (`use_cache`): with the
    # default, a clean parent's planes are dropped once its children are done
    # and come back from the recipe cache, whose 1 GiB budget holds only 16
    # planes of 4096², so an edit would re-run Distance and AO
    s = Session(device, n, graph, bound, timed, keep=True)
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
    return s.results, s.counts


def compare_card_cpu(label, gpu, cpu) -> None:
    if len(gpu) != len(cpu):
        raise AssertionError(f"{label}: {len(gpu)} reads on the card, {len(cpu)} on the CPU")
    ok = True
    for (step, name, gp, gu8), (_, _, cp, cu8) in zip(gpu, cpu):
        counts = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(gp, cp)]
        same = np.array_equal(gu8, cu8)
        ok &= same and not any(counts)
        log(f"card vs cpu {label} 1024x1024 {step} {name}: f32 mismatches per plane {counts}, "
            f"u8 identical {same}")
    if not ok:
        raise AssertionError(f"{label}: the card and the CPU disagree")


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

    # 2. build, one nvcc per source, together
    build_phase([kp_blur.BLUR_KERNEL, kp_dist.JFA_KERNEL, kp_warp.WARP_KERNEL])

    # 3. kernels vs plain
    blur = blur_phase(kp_blur)
    jfa = jfa_phase(kp_dist)
    warp = warp_phase(kp_warp)

    # 4. the PBR slice at full size, counters from 0
    _, pbr_counts = drive_pbr("cuda", 4096, timed=True)
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
    _, flag_counts = drive_flagship("cuda", 4096, timed=True)
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

    # 6. card vs CPU at 1024²
    compare_card_cpu("pbr", drive_pbr("cuda", 1024)[0], drive_pbr("cpu", 1024)[0])
    compare_card_cpu("flagship", drive_flagship("cuda", 1024)[0],
                     drive_flagship("cpu", 1024)[0])

    def entry(name, source, replaces, launches, phase, main, by_path):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": phase["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "timings": phase["timings"],
        }

    log(json.dumps({"kernels": [
        entry("kanter_blur_wrap_f32", "kanter_core_tpu_torch/csrc/blur.cu",
              "kanter_core_tpu/ops/pallas_blur.py:77",
              pbr_path["blur"] + flag_path["blur"], blur,
              next(t for t in blur["timings"] if t["sigma"] == 6.0),
              {"pbr": pbr_path["blur"], "flagship": flag_path["blur"]}),
        entry("kanter_jfa_step_i32", "kanter_core_tpu_torch/csrc/jfa.cu",
              "kanter_core_tpu/ops/pallas_distance.py:90",
              flag_path["jfa"], jfa, jfa["timings"][-1],
              {"pbr": pbr_path["jfa"], "flagship": flag_path["jfa"]}),
        entry("kanter_warp_bilinear_f32", "kanter_core_tpu_torch/csrc/warp.cu",
              "kanter_core_tpu/ops/pallas_warp.py:147",
              flag_path["warp"], warp, warp["timings"][0],
              {"pbr": pbr_path["warp"], "flagship": flag_path["warp"]}),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
