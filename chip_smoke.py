#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kanter_core_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) on failure:

1. the card: name and power limit from nvidia-smi, torch and CUDA versions;
   no CUDA device → exit before printing any result;
2. build: compiles `csrc/blur.cu`, `csrc/jfa.cu` and `csrc/warp.cu` with
   nvcc from the checkout's sources, one compiler per source, and the host
   loops of `csrc/host.c` (glibc `powf` over arrays, the PNG unfilter) with
   the host's C compiler, all started together, and prints the build times
   and ptxas reports;
3. kernels against their plain torch versions on the card; every output
   must be bit-identical (0 mismatches on the int32 view). CUDA-event
   timings (median of 20 runs after warm-up) at 4096² of the kernel, the
   plain version and one PyTorch library call computing the same function
   (timed only, never used by the port):
   - blur at 4096² at every σ the main path launches (the PBR graph's 0.8,
     6.0 and 4.0, the flagship's 1.2 and its AO node's three sigmas) and
     edge shapes: 1×1, 5×4096 with 37 taps, 97×411, 4096×1, widths and
     heights one below, at and one above a tile edge, widths 1, 3 and 411
     (no 16-byte alignment), a radius above the tile's height, the widest
     tiled radius (31) and the two-pass form above it; library call:
     `F.conv2d` on `F.pad(circular)` input, the separable pair;
   - JFA, the full ladder on the packed i32 state: 4096² masks at seed
     density 1e-4 and 1e-2, seedless, all-seed and a tie storm (seeds on
     every other pixel); edge shapes 1×1, 5×4096, 97×411, 4096×1, 33×2049
     (steps that do not divide the extents or reach past them), 16², 10×12
     (smaller than the fused halo), 96×160 (lattices of odd length) and
     6000² (past the f32 metric, so the i32 one); each launch of the
     4096² ladder timed alone besides the ladder; no library call computes
     it;
   - Warp of 4096² RGBA at (37°, 5), (0°, 5), (90°, 64), (37°, 1000) with a
     strength map holding NaN and out-of-range values; edge shapes 1×1,
     97×411, 4096×1; timed as one call and ten back to back; library call:
     `F.grid_sample` on a circularly padded input;
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
   after each; counters set to 0 just before; the JFA kernels must launch
   one ladder of `distance.jfa_launch_plan(4096, 4096)` (its far steps
   through `kanter_jfa_step_i32`, its near run through
   `kanter_jfa_near_i32`) on the render, none on the Value edit, one on the
   Distance edit and none on the Warp edit, the warp kernel once per read;
6. card vs CPU: the PBR sequence and the flagship sequence at 1024² on
   `device="cuda"` and on `device="cpu"` (the port's plain path); u8 exports
   must be identical and every f32 plane must have 0 mismatches;
7. the mesh route's block kernels against their plain versions on the card,
   0 mismatches: the blur block (`kanter_blur_block_f32`) on the four row
   blocks of a 4096² plane at every σ of the main path with ring halos taken
   from the plane, and on edge blocks (block_h == radius, widths 1 and 411,
   halos that are unaligned views into a plane, the two-pass form); the
   warp block (`kanter_warp_block_f32`) on the four blocks of 4096² RGBA at
   (37°, 5), (37°, 9) and (90°, 64), of 256×8 at (0°, 20) (the general
   column path) and of 100×411 (no 16-byte access), with NaN and
   out-of-range strength. Then the sharded calls (`blur_plane_sharded`,
   `warp_planes_mesh`, four shards) against the dense kernels on the whole
   plane, 0 mismatches. Timed: the block kernel on one 1024×4096 block
   (one call, and ten back to back), its plain version, one library call on
   the halo-extended block (`conv2d` pair, `grid_sample`), and the sharded
   call with its exchange (one call, and ten back to back), its plain form
   and the dense library call, each beside its bound;
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
   shards; u8 identical, 0 f32 mismatches;
10. the per-node route (`ops.process_node`, node by node from the engine's
   worker threads): the PBR sequence of phase 4 at 4096² under
   `auto_update=True` (every dirty node re-renders; each read group waits
   until the whole graph is Clean) and the flagship sequence of phase 5 at
   4096² with `fuse_subgraphs=False`, both keeping every node's data;
   every read's u8 export and f32 planes bit-identical to the fused
   route's same read of phases 4 and 5; counters set to 0 just before each
   sequence, and the blur, JFA (step and near, from `jfa_launch_plan`)
   and warp launches after each read group exactly those derived from the
   graph (`Session.expect_launches`: the nodes each read group evaluates,
   the plane counts of their committed inputs); then the per-node flagship
   over four shards against the per-node single-device run (block
   launches 4× the dense ones, gathers as in phase 8), and card vs CPU
   at 1024² for the per-node flagship and for the per-node PBR sequence on
   the default `use_cache=False`. The per-node read times are printed
   beside the fused route's;
11. the templates (`models.emboss_graph`, `wood_`, `stone_`, `metal_`,
   `brick_` and `cobblestone_material_graph`) at 4096² (emboss on a 4096²
   height from `numpy.random.default_rng(0)`), every node's data kept:
   every output read, then phase 11's edits (a Levels gamma: wood 1.6→2.0,
   stone 2.4→1.8, metal 3.2→2.5; a GradientMap stop colour: brick,
   cobblestone; a Transform rotation: wood, metal; a Blur sigma: emboss
   1.0→2.0), every output re-read after each; counters set to 0 just before
   each sequence, the blur, JFA and warp launches after each read group
   those derived from the graph (`Session.expect_launches`). The same six
   sequences with `fuse_subgraphs=False`, bit-identical to the fused ones;
   wood and brick over four shards, bit-identical to one device, block
   launches 4× the dense ones and gathers exact (`transform` one per plane
   a Transform takes, `distance` one per Distance evaluation, `export` one
   per read). A Graph node wrapping emboss, fused and per node,
   bit-identical to the flat emboss. A Write node saving the 4096² wood
   albedo and an Image node decoding it: its planes are `u8 / 255` of the
   export (encode and decode ms printed). `ds_pow` on the card equal to
   `ds_pow` on the CPU over the u8 grid and a 4096² plane, the sRGB export
   on the card equal to the CPU's on the u8 grid and a 4096² plane, the
   Levels node at 4096² timed at gamma 1.6 and 1. Card vs CPU at 1024² for
   each template after its last edit: every plane with no pow upstream
   exact, each Levels of gamma ≠ 1 different only where glibc `powf` and
   `ds_pow` differ for the CPU's `t`, the planes downstream of it counted.

12. the batched path (`parallel.BatchedGraph`, `parallel.BatchedLiveSession`,
   the kernels taking a whole `[B, H, W]` batch in one launch): the dense
   blur, JFA (far and near) and warp entries on batches of 4×1024² and
   3×97×411 against their plain versions, 0 mismatches, one launch per
   call (the warp with batched planes and strength, a shared strength, and
   shared planes); each timed at 16×4096² as one batched call beside 16
   single calls back to back, with its plain version, its library call
   (`conv2d` pair with batch 16, `grid_sample` with N = 16; none for the
   JFA) and its bound, and there too against the plain version's output
   (blur σ=6.0, JFA far and near, warp), 0 mismatches. Then at 16×4096²,
   counters from 0 before each:
   BASELINE config 5 (`graphs.bounded_chain_graph(depth=16)`, four gray
   input batches from `numpy.random.default_rng`) through
   `BatchedLiveSession` (render, then its `v` Value 0.96 → 0.93 → 0.96:
   one program, checksums that change with `v`, wall and CUDA-event ms per
   render), and PBR, the flagship and a kernel graph (height → Blur 6.0,
   → Distance 512, Warp(37°, 5) of the Distance by the blurred height)
   through `BatchedGraph`: per render the launches of the single-canvas
   render, canvases 0 and 15 bit-identical to the single-canvas
   `CompiledGraph`, peak device memory printed (under 80 GB). The kernel
   graph over a batch mesh of two shards on cuda:0 (and over four cards
   when visible) bit-identical to one device, one `batch` gather and no
   other. Card vs CPU at 4×256² for the four graphs (the chain with a
   batched `v`), f32 and u8.

The third-to-last line ranks the kernels by launches × (ms − bound) over
the 4096² sequences, the second-to-last is a JSON object describing the
kernels (`launches` summed over the fused, mesh, per-node, template and
batched sequences; the dense entries' `batched` key holds the batched
timings and launches), the last line is `{"ok": true, "device": {...}}`. Run alone, in
a directory holding no `kanter_core_tpu_torch` package, it exits 1 without
a result.
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
# The data sheet's rate counts a fused multiply-add as two operations. A
# kernel whose products and sums may not fuse (the blur: its bit-exactness
# rests on separately rounded products) spends one instruction slot per
# operation, and the card has half as many of those a second.
FP32_UNFUSED_OPS = FP32_FLOPS / 2
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


def time_cuda(fn, runs: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median milliseconds of `fn()` over `runs` CUDA-event-timed readings.
    A reading holds `calls` calls back to back and is divided by them: with
    one call it includes the wrapper's host time before the launch, with
    ten the card is kept busy and it is the device's time per call. The
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
        for _ in range(calls):
            fn()
        for d in others:
            torch.cuda.current_stream(here).wait_stream(torch.cuda.current_stream(d))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    """(least time the card could take in ms, which of the two bounds it)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def build_phase(kernels) -> None:
    """Build every kernel library at once, one nvcc per source, and the host
    loops (`csrc/host.c`) beside them."""
    from kanter_core_tpu_torch.build import host_library

    times, errors = {}, {}

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — re-raised below, after every build ends
            errors[name] = e
        times[name] = time.perf_counter() - t0

    jobs = [(k.name, k.entry) for k in kernels] + [("host", host_library)]
    threads = [threading.Thread(target=build, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if "host" in errors:
        raise RuntimeError("building csrc/host.c failed") from errors["host"]
    log(f"build: csrc/host.c in {times['host']:.2f} s")
    for kernel in kernels:
        if kernel.name in errors:
            raise RuntimeError(f"building csrc/{kernel.name}.cu failed") from errors[kernel.name]
        log(f"build: csrc/{kernel.name}.cu in {times[kernel.name]:.2f} s")
        with open(kernel.path + ".log") as f:
            for line in f.read().strip().splitlines():
                log(f"  nvcc: {line}")


def blur_library(x, taps):
    """The separable wrap blur as PyTorch's convolution on circularly padded
    input (timed as a yardstick only); a `[B, H, W]` batch is one `conv2d`
    pair with batch B."""
    import torch
    import torch.nn.functional as F

    r = (len(taps) - 1) // 2
    t = torch.from_numpy(np.ascontiguousarray(taps)).to(x.device)
    n = x.reshape(-1, 1, *x.shape[-2:])
    v = F.conv2d(F.pad(n, (0, 0, r, r), mode="circular"), t.view(1, 1, -1, 1))
    return F.conv2d(F.pad(v, (r, r, 0, 0), mode="circular"), t.view(1, 1, 1, -1)).reshape(x.shape)


def main_path_sigmas() -> list:
    """Every sigma the graphs of the main path hand to the blur kernel: the
    PBR graph's Blur nodes and its sigma edit, the flagship's Blur node and
    the three sigmas of its AmbientOcclusion node, the six templates' Blur
    and AmbientOcclusion nodes and emboss's sigma edit."""
    from kanter_core_tpu_torch import NodeTypeKind
    from kanter_core_tpu_torch.graphs import flagship_graph
    from kanter_core_tpu_torch.models import pbr_material_graph
    from kanter_core_tpu_torch.ops.ambient_occlusion import ao_sigmas

    sigmas = {4.0, EMBOSS_SIGMA_EDIT}  # the PBR and emboss sequences' sigma edits
    graphs = [pbr_material_graph(), flagship_graph(CANVAS)[0]]
    graphs += [template_graph(name, CANVAS) for name in TEMPLATES]
    for graph in graphs:
        for node in graph.nodes:
            if node.node_type.kind == NodeTypeKind.BLUR:
                sigmas.add(round(float(node.node_type.payload), 6))
            elif node.node_type.kind == NodeTypeKind.AMBIENT_OCCLUSION:
                sigmas.update(ao_sigmas(node.node_type.payload[1]))
    return sorted(sigmas)


def blur_bound(n_px: int, halo_bytes: int, taps: int):
    """The blur's bound: the plane read and written once (plus a block's
    halos) against two unfused operations per tap and pass."""
    return bound_ms(8.0 * n_px + halo_bytes, 2 * 2 * taps * n_px, FP32_UNFUSED_OPS)


def blur_phase(kp_blur) -> dict:
    import torch

    rng = np.random.default_rng(1)
    shapes = [(CANVAS, CANVAS, sigma) for sigma in main_path_sigmas()]
    shapes += [
        (1, 1, 0.8), (1, 1, 6.0), (5, 4096, 6.0),
        (97, 411, 0.8), (97, 411, 6.0), (4096, 1, 0.8), (4096, 1, 6.0),
        # one below, at and one above a tile edge (64 rows, 128 columns)
        (63, 127, 1.2), (64, 128, 1.2), (65, 129, 1.2), (63, 127, 6.0), (64, 128, 6.0),
        (65, 129, 6.0), (128, 256, 4.0), (129, 257, 4.0),
        # no 16-byte alignment of rows; a radius above the tile's height
        (200, 3, 0.8), (200, 3, 6.0), (37, 411, 1.2), (8, 300, 6.0), (16, 300, 6.0),
        (40, 300, 6.0), (100, 300, 6.0),
        # the widest tiled radius, and the two-pass form above it
        (200, 333, 10.3), (31, 31, 10.3), (200, 333, 10.4), (40, 50, 30.0), (300, 1, 12.0),
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
        if (h, w) == (CANVAS, CANVAS):
            ms = time_cuda(lambda: kp_blur.blur_plane_cuda(x, sigma))
            device_ms = time_cuda(lambda: kp_blur.blur_plane_cuda(x, sigma), calls=10)
            plain_ms = time_cuda(lambda: kp_blur.blur_plane_plain(x, sigma))
            library_ms = time_cuda(lambda: blur_library(x, taps))
            lib_err = float((blur_library(x, taps) - want).abs().max().item())
            bound, by = blur_bound(h * w, 0, len(taps))
            log(f"  time: kernel {ms:.4f} ms ({device_ms:.4f} ms back to back), plain "
                f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (max |library − plain| "
                f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
            timings.append({"shape": f"{h}x{w}", "sigma": sigma, "taps": len(taps),
                            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound, "bound_by": by})
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


def jfa_bound(n_px: int, n_steps: int):
    """The bound of `n_steps` jump-flood steps: the state read and written
    once per step (the least with the steps as separate passes) against the
    fold's integer operations."""
    return bound_ms(8.0 * n_px * n_steps, JFA_OPS_PER_PX_STEP * n_px * n_steps, INT32_OPS)


def jfa_phase(kp_dist) -> dict:
    """Phase 3, JFA. Returns the far-step entry's and the near entry's
    results, each `{"max_abs_err", "timings"}`."""
    import torch

    rng = np.random.default_rng(2)
    cases = [(CANVAS, CANVAS, k) for k in ("1e-4", "1e-2", "seedless", "all", "ties")]
    cases += [(1, 1, "all"), (5, 4096, "1e-2"), (97, 411, "1e-2"), (4096, 1, "1e-2"),
              (33, 2049, "1e-3"), (16, 16, "1e-1"), (10, 12, "1e-1"), (10, 12, "seedless"),
              (96, 160, "1e-2"), (96, 160, "ties"), (6000, 6000, "1e-4"), (3, 7, "all")]
    step_timings, near_timings = [], []
    for h, w, kind in cases:
        state = kp_dist.pack_seeds(jfa_mask(h, w, kind, rng))
        before = (kp_dist.JFA_KERNEL.launches, kp_dist.JFA_NEAR_KERNEL.launches)
        got = kp_dist.jfa_propagate_cuda(state)
        plan = kp_dist.jfa_launch_plan(h, w)
        far = [launch for launch in plan if launch.entry == "step"]
        near = [launch for launch in plan if launch.entry == "near"]
        launched = (kp_dist.JFA_KERNEL.launches - before[0],
                    kp_dist.JFA_NEAR_KERNEL.launches - before[1])
        if launched != (len(far), len(near)):
            raise AssertionError(f"JFA launches {launched}, the plan has {len(far)} + {len(near)}")
        want = kp_dist.jfa_propagate_plain(state)
        torch.cuda.synchronize()
        bad = mismatches(got, want)
        steps = kp_dist._jfa_steps(h, w)
        forms = sorted({kp_dist.jfa_step_form(k, h, w) for launch in far for k in launch.steps})
        log(f"kernel jfa {h}x{w} mask={kind} steps={len(steps)} in {len(far)} far launches "
            f"{forms} + {len(near)} near launch of {near[0].steps}: {bad} bit mismatches")
        if bad:
            raise AssertionError(f"JFA kernel differs from plain at {h}x{w} mask={kind}")
        if (h, w) == (CANVAS, CANVAS) and kind in ("1e-4", "1e-2"):
            n = h * w
            ms = time_cuda(lambda: kp_dist.jfa_propagate_cuda(state))
            plain_ms = time_cuda(lambda: kp_dist.jfa_propagate_plain(state))
            bound, by = jfa_bound(n, len(steps))
            # each launch alone, from the state the ladder hands it
            per_launch = []
            at = state
            for launch in plan:
                here = at
                per_launch.append(time_cuda(lambda: kp_dist.jfa_run_launches(here, [launch]),
                                            calls=10))
                at = kp_dist.jfa_run_launches(at, [launch])
            before_near = kp_dist.jfa_run_launches(state, far)
            far_ms = time_cuda(lambda: kp_dist.jfa_run_launches(state, far))
            near_ms = time_cuda(lambda: kp_dist.jfa_run_launches(before_near, near))

            def plain_steps(start, ks):
                for k in ks:
                    start = kp_dist.jfa_step_plain(start, k)
                return start

            far_ks = [k for launch in far for k in launch.steps]
            far_plain_ms = time_cuda(lambda: plain_steps(state, far_ks), runs=5)
            near_plain_ms = time_cuda(lambda: plain_steps(before_near, near[0].steps), runs=5)
            far_bound, far_by = jfa_bound(n, len(far_ks))
            near_bound, near_by = jfa_bound(n, len(near[0].steps))
            log(f"  time: ladder {ms:.4f} ms in {len(plan)} launches, plain {plain_ms:.4f} ms, "
                f"library none, bound {bound:.4f} ms ({by}); far steps {far_ms:.4f} ms (plain "
                f"{far_plain_ms:.4f}, bound {far_bound:.4f}), near run {near_ms:.4f} ms (plain "
                f"{near_plain_ms:.4f}, bound {near_bound:.4f})")
            log("  each launch alone, back to back: " + ", ".join(
                f"{'+'.join(str(k) for k in launch.steps)}: {t:.4f}"
                for launch, t in zip(plan, per_launch)) + " ms")
            ladder = {"shape": f"{h}x{w}", "density": kind, "steps": len(steps),
                      "launches": len(plan), "ladder_ms": ms, "ladder_plain_ms": plain_ms,
                      "ladder_bound_ms": bound, "ladder_bound_by": by,
                      "per_launch_ms": per_launch}
            step_timings.append(dict(ladder, steps_covered=far_ks, ms=far_ms,
                                     plain_ms=far_plain_ms, library_ms=None,
                                     bound_ms=far_bound, bound_by=far_by))
            near_timings.append(dict(ladder, steps_covered=list(near[0].steps), ms=near_ms,
                                     plain_ms=near_plain_ms, library_ms=None,
                                     bound_ms=near_bound, bound_by=near_by))
    return ({"max_abs_err": 0, "timings": step_timings},
            {"max_abs_err": 0, "timings": near_timings})


def warp_grid(strength, k):
    """`(grid, pad)`: the warp's sample coordinates as `grid_sample`'s grid
    on a stack padded circularly by `pad`, for an `[H, W]` strength map."""
    import torch

    h, w = strength.shape
    kx, ky = (float(c) for c in k)
    pad = min(int(math.ceil(max(abs(kx), abs(ky)) / 2.0)) + 2, h, w)
    ms = torch.where(torch.isnan(strength), 0.5, torch.clamp(strength, 0.0, 1.0)) - 0.5
    u = torch.arange(w, device=strength.device, dtype=torch.float32)[None, :] + ms * kx
    v = torch.arange(h, device=strength.device, dtype=torch.float32)[:, None] + ms * ky
    gx = (u + pad) * (2.0 / (w + 2 * pad - 1)) - 1.0
    gy = (v + pad) * (2.0 / (h + 2 * pad - 1)) - 1.0
    return torch.stack([gx, gy], dim=-1), pad


def warp_library(planes, strength, k):
    """The warp as PyTorch's `grid_sample` (bilinear) on a circularly padded
    stack (timed as a yardstick only); returns a function of no arguments.
    `[B, H, W]` planes by a shared `[H, W]` strength map are one call with
    N = B."""
    import torch
    import torch.nn.functional as F

    grid, pad = warp_grid(strength, k)
    if planes[0].dim() == 3:
        stack = torch.stack(list(planes), dim=1)
        grid = grid[None].expand(stack.shape[0], *grid.shape)
    else:
        stack, grid = torch.stack(list(planes))[None], grid[None]

    def run():
        padded = F.pad(stack, (pad, pad, pad, pad), mode="circular")
        out = F.grid_sample(padded, grid, mode="bilinear", padding_mode="border",
                            align_corners=True)
        return out if planes[0].dim() == 3 else out[0]

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
            device_ms = time_cuda(lambda: kp_warp.warp_planes_cuda(planes, strength, k), calls=10)
            plain_ms = time_cuda(lambda: kp_warp.warp_planes_plain(planes, strength, k))
            library = warp_library(planes, strength, k)
            library_ms = time_cuda(library)
            lib_err = float((library() - torch.stack(list(want))).abs().max().item())
            n = h * w
            bound, by = bound_ms(36.0 * n, WARP_FLOPS_PER_PX * n, FP32_FLOPS)
            log(f"  time: kernel {ms:.4f} ms ({device_ms:.4f} ms back to back), plain "
                f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (max |library − plain| "
                f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
            timings.append({"shape": f"{h}x{w}", "payload": list(payload), "ms": ms,
                            "device_ms": device_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound, "bound_by": by})
    return {"max_abs_err": max_err, "timings": timings}


def kernels():
    """(blur, distance, warp) op modules of the port."""
    from kanter_core_tpu_torch.ops import blur, distance, warp

    return blur, distance, warp


def launch_counts() -> dict:
    blur, distance, warp = kernels()
    return {"blur": blur.BLUR_KERNEL.launches, "jfa": distance.JFA_KERNEL.launches,
            "jfa_near": distance.JFA_NEAR_KERNEL.launches,
            "warp": warp.WARP_KERNEL.launches, "blur_block": blur.BLUR_BLOCK_KERNEL.launches,
            "warp_block": warp.WARP_BLOCK_KERNEL.launches}


def batched_launch_counts() -> dict:
    """The dense entries' launches over a batch of more than one canvas
    since the last reset."""
    blur, distance, warp = kernels()
    return {"blur": blur.BLUR_KERNEL.batched_launches, "jfa": distance.JFA_KERNEL.batched_launches,
            "jfa_near": distance.JFA_NEAR_KERNEL.batched_launches,
            "warp": warp.WARP_KERNEL.batched_launches}


def blur_launches_by_sigma() -> dict:
    """The blur entries' launches since the last reset, split by sigma."""
    blur = kernels()[0]
    return {"blur": dict(blur.BLUR_KERNEL.launches_by_key),
            "blur_block": dict(blur.BLUR_BLOCK_KERNEL.launches_by_key)}


def reset_counts() -> None:
    from kanter_core_tpu_torch.parallel import MESH_COUNTERS

    blur, distance, warp = kernels()
    for kernel in (blur.BLUR_KERNEL, blur.BLUR_BLOCK_KERNEL, distance.JFA_KERNEL,
                   distance.JFA_NEAR_KERNEL, warp.WARP_KERNEL, warp.WARP_BLOCK_KERNEL):
        kernel.reset_launches()
    MESH_COUNTERS.reset()


class Session:
    """A processor and live graph on `device`, read through `buffer_rgba`;
    `results` collects (label, output name, [f32 planes], u8 bytes),
    `counts` the launch counters after each read group and `mesh_counts`
    the mesh counters; `mesh` shards the processor."""

    def __init__(self, device, n, graph, bound, timed, keep=False, mesh=None, route="fused"):
        import torch
        from kanter_core_tpu_torch import SlotData, SlotId, SlotImage, TextureProcessor
        from kanter_core_tpu_torch.convert import planes_from_numpy

        self.torch, self.SlotId, self.TP = torch, SlotId, TextureProcessor
        self.n, self.timed, self.mesh, self.route = n, timed, mesh, route
        self.results, self.counts, self.mesh_counts, self.times = [], [], [], []
        self.planes_read = 0
        self.tp = TextureProcessor(memory_threshold=16 << 30, device=device, mesh=mesh)
        if timed:
            for d in self.devices():
                torch.cuda.reset_peak_memory_stats(d)
        self.lg = self.tp.new_live_graph()
        with self.lg.write() as g:
            g.use_cache = keep
            # the per-node route: "auto_update" (every dirty node re-renders)
            # or "no_fuse" (`fuse_subgraphs=False`); "fused" is the default
            g.auto_update = route == "auto_update"
            g.fuse_subgraphs = route == "fused"
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
            self.times.append((label, name, ms))
            if self.timed:
                where = "" if self.tp.mesh is None else " mesh"
                route = "" if self.route == "fused" else f" {self.route}"
                log(f"slice{where}{route} {n}x{n} {label} read {name}: {ms:.3f} ms wall")
        if self.route == "auto_update":
            self.settle()
        self.counts.append(launch_counts())
        self.by_sigma = blur_launches_by_sigma()
        if self.tp.mesh is not None:
            from kanter_core_tpu_torch.parallel import MESH_COUNTERS

            self.mesh_counts.append(dict(MESH_COUNTERS.snapshot(), planes_read=self.planes_read,
                                         reads=len(self.results)))

    def settle(self, timeout: float = 600.0) -> None:
        """Wait until every node is Clean: under `auto_update` the nodes no
        read asked for render on their own, and their launches belong to
        this read group."""
        from kanter_core_tpu_torch import NodeState

        deadline = time.monotonic() + timeout
        while True:
            with self.lg.read() as g:
                if g.fatal_error is not None:
                    raise g.fatal_error
                if all(st == NodeState.CLEAN for st in g.node_states().values()):
                    break
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.route}: the graph did not settle in {timeout} s")
            time.sleep(0.001)
        if self.tp.device.type == "cuda":
            self.torch.cuda.synchronize()

    def expect_launches(self, groups) -> list:
        """The kernel launches the route must make, cumulative per read
        group, derived from the graph and the committed planes (the session
        keeps every node's data): `groups` holds, per read group, the ids of
        the nodes the route evaluates. A Blur node launches the blur kernel
        once per plane of its input, an AmbientOcclusion node three times, a
        Distance node one ladder of `jfa_launch_plan` for its input's size,
        a Warp node with a strength input once per group of up to four
        planes of its image; `transform` counts the planes Transform nodes
        take (under a mesh, one `transform` gather each)."""
        from kanter_core_tpu_torch import NodeTypeKind as K

        distance = kernels()[1]
        g = self.lg.node_graph
        total = dict.fromkeys(("blur", "jfa", "jfa_near", "warp", "transform"), 0)
        out = []
        for group in groups:
            for node_id in sorted(group):
                kind = g.node(node_id).node_type.kind
                edges = {int(e.input_slot): e for e in g.edges if e.input_id == node_id}
                if (kind not in (K.BLUR, K.AMBIENT_OCCLUSION, K.DISTANCE, K.WARP, K.TRANSFORM)
                        or 0 not in edges):
                    continue
                image = self.lg.slot_data(edges[0].output_id, edges[0].output_slot).image
                if kind == K.TRANSFORM:
                    total["transform"] += len(image.planes)
                elif kind == K.BLUR:
                    total["blur"] += len(image.planes)
                elif kind == K.AMBIENT_OCCLUSION:
                    total["blur"] += 3
                elif kind == K.DISTANCE:
                    h, w = image.planes[0].shape
                    for launch in distance.jfa_launch_plan(h, w):
                        total["jfa" if launch.entry == "step" else "jfa_near"] += 1
                elif 1 in edges:
                    total["warp"] += -(-len(image.planes) // 4)
            out.append(dict(total))
        return out

    def node(self, kind, pred=lambda p: True):
        return next(x.node_id for x in self.lg.node_graph.nodes
                    if x.node_type.kind == kind and pred(x.node_type.payload))

    def capture(self) -> dict:
        """`{(node id, slot id): [f32 planes]}` of every node's committed
        output (the session keeps every node's data)."""
        out = {}
        with self.lg.read() as g:
            for sd in g.slot_datas:
                out[(sd.node_id, sd.slot_id)] = [p.host_data().copy() for p in sd.image.planes]
        return out

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


def closure(graph, start, up: bool) -> set:
    """`start` and all its ancestors (`up`) or descendants."""
    seen, stack = set(), list(start)
    while stack:
        node_id = stack.pop()
        if node_id in seen:
            continue
        seen.add(node_id)
        stack.extend(graph.get_parents(node_id) if up else graph.get_children(node_id))
    return seen


def evaluated_groups(s, edits) -> list:
    """Per read group, the nodes the session's route evaluates: the render
    evaluates every node (`auto_update`) or the outputs read and their
    ancestors (the fused route and `no_fuse`); an edit evaluates the edited
    node and its descendants, outside `auto_update` only those the reads
    reach. `edits` holds the edited node of each later group."""
    graph = s.lg.node_graph
    reached = {n.node_id for n in graph.nodes}
    if s.route != "auto_update":
        reached = closure(graph, [s.outputs[name] for _, name, _ in s.times], up=True)
    return [reached] + [closure(graph, [x], up=False) & reached for x in edits]


KERNEL_KEYS = ("blur", "jfa", "jfa_near", "warp")


def check_launches(label, s) -> None:
    """The session's launch counts, per read group, against those derived
    from its graph (`Session.expect_launches`); the block kernels 0."""
    want = [{k: e[k] for k in KERNEL_KEYS} for e in s.expected]
    got = [{k: c[k] for k in KERNEL_KEYS} for c in s.counts]
    log(f"{s.route} {label} launches after each read group: {got}, derived from the graph: {want}")
    if got != want or any(c["blur_block"] or c["warp_block"] for c in s.counts):
        raise AssertionError(f"{s.route} {label}: launches {s.counts}, want {want}")


def log_read_times(label, fused, pernode) -> None:
    """Each read's wall time on the fused and the per-node route, side by
    side."""
    rows = [f"{step} {name} {a:.3f}/{b:.3f}"
            for (step, name, a), (_, _, b) in zip(fused.times, pernode.times)]
    log(f"read ms fused/{pernode.route} {label} {fused.n}x{fused.n}: " + ", ".join(rows))


def drive_pbr(device: str, n: int, seed: int = 0, timed: bool = False, mesh=None,
              route: str = "fused", keep: bool = False):
    """Render pbr_material_graph at n² on `device` (sharded over `mesh`),
    then the Value edit and the sigma edit. Returns the session."""
    from kanter_core_tpu_torch import NodeType, NodeTypeKind
    from kanter_core_tpu_torch.models import pbr_material_graph

    graph = pbr_material_graph()
    (inp,) = [x.node_id for x in graph.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
    height = np.random.default_rng(seed).random((n, n), dtype=np.float32)
    s = Session(device, n, graph, [(inp, height)], timed, keep=keep, mesh=mesh, route=route)
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
        if route != "fused" and keep:
            s.expected = s.expect_launches(evaluated_groups(s, [ao_strength, ao_blur]))
    finally:
        s.close()
    return s


def drive_flagship(device: str, n: int, timed: bool = False, mesh=None, route: str = "fused"):
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
    s = Session(device, n, graph, bound, timed, keep=True, mesh=mesh, route=route)
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
        if route != "fused":
            s.expected = s.expect_launches(evaluated_groups(s, [v, dist, warp]))
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
    cases = [(CANVAS, CANVAS, sigma) for sigma in main_path_sigmas()]
    cases += [(4 * 19, 411, 6.0), (4 * 18, 411, 6.0), (4 * 18, 1, 6.0), (4 * 3, 411, 0.8),
              (4 * 65, 129, 1.2), (4 * 64, 128, 6.0), (4 * 63, 3, 6.0), (4 * 40, 50, 12.0)]
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
        # the same blocks with halos that are views into the plane: rows of
        # 411 or 3 floats put them off every 16-byte boundary
        bh = h // n
        for j in range(1, n - 1):
            views = (x[j * bh:(j + 1) * bh], x[j * bh - r:j * bh], x[(j + 1) * bh:(j + 1) * bh + r])
            got = kp_blur.blur_block_cuda(*views, sigma)
            want = kp_blur.blur_block_plain(*views, sigma)
            torch.cuda.synchronize()
            bad += mismatches(got, want)
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
        device_ms = time_cuda(lambda: kp_blur.blur_block_cuda(band, top, bot, sigma), calls=10)
        plain_ms = time_cuda(lambda: kp_blur.blur_block_plain(band, top, bot, sigma))
        library_ms = time_cuda(lambda: blur_block_library(band, top, bot, taps))
        lib_err = float((blur_block_library(band, top, bot, taps)
                         - kp_blur.blur_block_plain(band, top, bot, sigma)).abs().max().item())
        bound, by = blur_bound(bh * w, 2 * r * w * 4, len(taps))
        s_ms = time_cuda(lambda: kp_blur.blur_plane_sharded(sp, sigma))
        s_plain_ms = time_cuda(lambda: blur_sharded_plain(kp_blur, sp, sigma))
        s_library_ms = time_cuda(lambda: blur_library(x, taps))
        s_bound, s_by = blur_bound(h * w, n * 2 * r * w * 4, len(taps))
        log(f"  time: block {bh}x{w} kernel {ms:.4f} ms ({device_ms:.4f} ms back to back), "
            f"plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms (max |library − plain| {lib_err:.3g}), bound {bound:.4f} ms "
            f"({by}); sharded {h}x{w} over {n}: {s_ms:.4f} ms with its exchange, plain "
            f"{s_plain_ms:.4f} ms, library {s_library_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by})")
        timings.append({"shape": f"{bh}x{w}", "sigma": sigma, "taps": len(taps), "ms": ms,
                        "device_ms": device_ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
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
    max_err = 0.0
    timings = []
    # the main path's two payloads (render and Warp edit) and a large one at
    # 4096²; 256x8 at (0°, 20) takes the general column path (ceil(20/2) + 2
    # > 8 columns) and 100x411 (an odd width) the launch without vector accesses
    cases = [(CANVAS, CANVAS, p) for p in ((37.0, 5.0), (37.0, 9.0), (90.0, 64.0))]
    cases += [(256, 8, (0.0, 20.0)), (100, 411, (37.0, 5.0))]
    for h, w, payload in cases:
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
        kx, ky = (float(c) for c in k)
        plan = kp_warp.warp_block_plan(kx, ky, bh, w, h, halo, ss.bands[0].data_ptr() % 8 == 0)
        log(f"kernel warp block {h}x{w} RGBA in {n} blocks angle={payload[0]} "
            f"intensity={payload[1]} halo={halo} ({plan}): {bad} bit mismatches vs plain; "
            f"sharded vs dense kernel {bad_sharded} mismatches")
        if bad or bad_sharded:
            raise AssertionError(f"warp block kernel differs at {h}x{w} {payload}")
        if (h, w, payload) == (256, 8, (0.0, 20.0)) and plan.mode != kp_warp.WARP_COL_GENERAL:
            raise AssertionError(f"256x8 at {payload} did not take the general column path")
        if (h, w, payload) != (CANVAS, CANVAS, (37.0, 5.0)):
            continue
        args = block_args(0)  # on the first device
        ms = time_cuda(lambda: kp_warp.warp_block_cuda(*args))
        device_ms = time_cuda(lambda: kp_warp.warp_block_cuda(*args), calls=10)
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
        s_device_ms = time_cuda(lambda: kp_warp.warp_planes_mesh(sps, ss, k, halo), calls=10)
        s_plain_ms = time_cuda(sharded_plain)
        s_library_ms = time_cuda(warp_library(planes, strength, k))
        s_bound, s_by = bound_ms(36.0 * h * w + n * halo_bytes, WARP_FLOPS_PER_PX * h * w,
                                 FP32_FLOPS)
        log(f"  time: block {bh}x{w} RGBA kernel {ms:.4f} ms ({device_ms:.4f} ms back to back), "
            f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms (max |library − plain| "
            f"{lib_err:.3g}), bound {bound:.4f} ms ({by}); sharded {h}x{w} over {n}: {s_ms:.4f} "
            f"ms with its exchange ({s_device_ms:.4f} ms back to back), plain {s_plain_ms:.4f} "
            f"ms, library {s_library_ms:.4f} ms, bound {s_bound:.4f} ms ({s_by})")
        timings.append({"shape": f"{bh}x{w}", "payload": list(payload), "ms": ms,
                        "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bound, "bound_by": by,
                        "sharded": {"shape": f"{h}x{w}", "shards": n, "ms": s_ms,
                                    "device_ms": s_device_ms, "plain_ms": s_plain_ms,
                                    "library_ms": s_library_ms, "bound_ms": s_bound,
                                    "bound_by": s_by}})
    return {"max_abs_err": max_err, "timings": timings}


def check_mesh_run(label, single, sharded, transforms=None) -> None:
    """The mesh run's launch and gather counts against the single-device
    run of the same sequence: per read group, the block kernels 4× (one
    launch per shard) the dense kernels' counts, the dense blur and warp
    kernels 0, the JFA ladder the same; gathers one per Distance
    evaluation, per export, per plane read back and per plane a Transform
    takes (`transforms`, cumulative per read group), else 0."""
    n = sharded.mesh.n
    transforms = transforms or [0] * len(sharded.counts)
    log(f"mesh {label} launches after each read group: {sharded.counts}")
    log(f"mesh {label} mesh counters after each read group: {sharded.mesh_counts}")
    if len(single.counts) != len(sharded.counts):
        raise AssertionError(f"mesh {label}: {len(sharded.counts)} read groups, want "
                             f"{len(single.counts)}")
    for one, many, mc, tf in zip(single.counts, sharded.counts, sharded.mesh_counts, transforms):
        want = {"blur": 0, "warp": 0, "jfa": one["jfa"], "jfa_near": one["jfa_near"],
                "blur_block": n * one["blur"], "warp_block": n * one["warp"]}
        if many != want:
            raise AssertionError(f"mesh {label}: launches {many}, want {want}")
        # a ladder ends in exactly one near launch
        want_g = {"distance": many["jfa_near"], "transform": tf, "blur_gate": 0,
                  "warp_gate": 0, "resize": 0, "export": mc["reads"],
                  "host": mc["planes_read"], "batch": 0}
        if mc["gathers"] != want_g:
            raise AssertionError(f"mesh {label}: gathers {mc['gathers']}, want {want_g}")


TEMPLATES = ("emboss", "wood", "stone", "metal", "brick", "cobblestone")
EMBOSS_SIGMA_EDIT = 2.0


def template_graph(name: str, n: int):
    """A material template of the port at its defaults, its procedural
    canvas n² (emboss takes an n² height input)."""
    from kanter_core_tpu_torch import models

    if name == "emboss":
        return models.emboss_graph()
    return getattr(models, f"{name}_material_graph")(size=n)


def template_edits(name: str, s) -> list:
    """`[(label, edited node id, apply(lg))]`: phase 11's edits of a template
    session — a Levels gamma (wood ring contrast 1.6→2.0, stone crack gamma
    2.4→1.8, metal scratch gamma 3.2→2.5), a GradientMap stop colour (brick,
    cobblestone), a Transform rotation (wood 0→30°, metal 0→15°), a Blur
    sigma (emboss 1.0→2.0)."""
    from kanter_core_tpu_torch import NodeTypeKind as K

    def gamma(old, new):
        node = s.node(K.LEVELS, lambda p: np.float32(p[2]) == np.float32(old))
        p = s.lg.node(node).node_type.payload
        return (f"gamma-{new}", node,
                lambda lg: lg.set_levels(node, p[0], p[1], new, p[3], p[4]))

    def rotation(degrees):
        node = s.node(K.TRANSFORM)
        p = s.lg.node(node).node_type.payload
        return (f"rotation-{degrees}", node,
                lambda lg: lg.set_transform(node, p[0], p[1], degrees, p[3], p[4]))

    def stop_colour(stop, rgba):
        node = s.node(K.GRADIENT_MAP)
        stops = [list(x) for x in s.lg.node(node).node_type.payload]
        stops[stop][1:] = rgba
        return ("stop-colour", node,
                lambda lg: lg.set_gradient_map(node, [tuple(x) for x in stops]))

    if name == "emboss":
        node = s.node(K.BLUR)
        return [("sigma-edit", node, lambda lg: lg.set_blur_sigma(node, EMBOSS_SIGMA_EDIT))]
    return {
        "wood": lambda: [gamma(1.6, 2.0), rotation(30.0)],
        "stone": lambda: [gamma(2.4, 1.8)],
        "metal": lambda: [gamma(3.2, 2.5), rotation(15.0)],
        "brick": lambda: [stop_colour(3, (0.75, 0.25, 0.2, 1.0))],
        "cobblestone": lambda: [stop_colour(2, (0.5, 0.52, 0.4, 1.0))],
    }[name]()


def nested_emboss_graph():
    """The emboss graph wrapped in a Graph node: outer InputGray → Graph
    (slot 0 feeds the inner Input node 0) → OutputGray `emboss`."""
    from kanter_core_tpu_torch import Node, NodeGraph, NodeType, SlotId
    from kanter_core_tpu_torch.models import emboss_graph

    inner = emboss_graph()
    (inner_out,) = inner.output_ids()
    g = NodeGraph()
    inp = g.add_node(Node(NodeType.InputGray("height")))
    node = g.add_node(Node(NodeType.Graph(inner)))
    g.connect(inp, node, SlotId(0), SlotId(0))
    out = g.add_node(Node(NodeType.OutputGray("emboss")))
    g.connect(node, out, inner_out, SlotId(0))
    return g


def drive_template(name: str, device: str, n: int, timed: bool = False, mesh=None,
                   route: str = "fused", capture: bool = False):
    """Render template `name` at n² on `device` (sharded over `mesh`) on
    `route`, reading every output, then each of its edits, re-reading every
    output after each, on a live graph that keeps every node's data; the
    counters set to 0 just before. `name` "nested_emboss" is the emboss
    graph inside a Graph node. Returns the session, with `expected` (the
    launches derived from the graph) and, with `capture`, `nodes` (every
    node's planes after the last read) and `graph` (the edited graph)."""
    from kanter_core_tpu_torch import NodeTypeKind

    nested = name == "nested_emboss"
    graph = nested_emboss_graph() if nested else template_graph(name, n)
    bound = []
    if nested or name == "emboss":
        (inp,) = [x.node_id for x in graph.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
        bound = [(inp, np.random.default_rng(0).random((n, n), dtype=np.float32))]
    s = Session(device, n, graph, bound, timed, keep=True, mesh=mesh, route=route)
    try:
        edits = [] if nested else template_edits(name, s)
        names = sorted(s.outputs)
        reset_counts()
        s.read("render", names)
        for label, _, apply in edits:
            apply(s.lg)
            s.read(label, names)
        s.finish()
        s.expected = s.expect_launches(evaluated_groups(s, [node for _, node, _ in edits]))
        if capture:
            s.nodes, s.graph = s.capture(), s.lg.node_graph.clone()
    finally:
        s.close()
    return s


def pow_class_compare(name, graph, cpu_nodes, card_nodes, cpu_u8, card_u8) -> dict:
    """Card against CPU under the reference's pow allowance. A plane with no
    pow upstream (no Levels of gamma ≠ 1, no Mix POW among the node and its
    ancestors) must have 0 f32 mismatches. A Levels of gamma ≠ 1 whose
    input is exact may differ only where `powf_glibc(t, γ) ≠ ds_pow(t, γ)`
    for the CPU's `t` (both recomputed here). Planes further downstream are
    counted, f32 and (outputs) u8, not held. Returns the counts."""
    import torch
    from kanter_core_tpu_torch import MixType, NodeTypeKind as K
    from kanter_core_tpu_torch.compiler import _topo_order
    from kanter_core_tpu_torch.ops.exact_math import ds_pow, powf_glibc
    from kanter_core_tpu_torch.ops.levels import levels_t

    def pow_node(node):
        kind, p = node.node_type.kind, node.node_type.payload
        return ((kind == K.LEVELS and np.float32(p[2]) != np.float32(1.0))
                or (kind == K.MIX and p == MixType.POW))

    tainted, report = set(), {"exact_planes": 0, "pow_nodes": [], "downstream": {}}
    for node_id in _topo_order(graph):
        node = graph.node(node_id)
        parents = graph.get_parents(node_id)
        upstream = any(p in tainted for p in parents)
        keys = sorted(k for k in card_nodes if k[0] == node_id)
        counts = [sum(int((a.view(np.int32) != b.view(np.int32)).sum())
                      for a, b in zip(cpu_nodes[k], card_nodes[k])) for k in keys]
        if not pow_node(node) and not upstream:
            if any(counts):
                raise AssertionError(f"{name}: node {int(node_id)} ({node.node_type.kind.value}) "
                                     f"has no pow upstream but {counts} f32 mismatches")
            report["exact_planes"] += sum(len(card_nodes[k]) for k in keys)
            continue
        tainted.add(node_id)
        if pow_node(node) and not upstream and node.node_type.kind == K.LEVELS:
            (edge,) = [e for e in graph.edges if e.input_id == node_id]
            params = np.asarray(node.node_type.payload, np.float32)
            gamma = float(params[2])
            allowed = 0
            for plane, got_cpu, got_card in zip(cpu_nodes[(edge.output_id, edge.output_slot)],
                                                cpu_nodes[keys[0]], card_nodes[keys[0]]):
                t = levels_t(torch.from_numpy(plane), params)
                g = torch.full_like(t, gamma)
                differ = (powf_glibc(t, g).view(torch.int32) != ds_pow(t, g).view(torch.int32))
                bad = got_cpu.view(np.int32) != got_card.view(np.int32)
                if (bad & ~differ.numpy()).any():
                    raise AssertionError(f"{name}: Levels node {int(node_id)} differs outside "
                                         "the pixels where glibc and ds_pow differ")
                allowed += int(differ.sum())
            report["pow_nodes"].append({"node": int(node_id), "gamma": gamma,
                                        "f32_mismatches": sum(counts),
                                        "pow_class_pixels": allowed})
            continue
        entry = {"kind": node.node_type.kind.value, "f32_mismatches": sum(counts)}
        if node.node_type.kind in (K.OUTPUT_GRAY, K.OUTPUT_RGBA):
            out_name = node.node_type.payload
            entry["u8_mismatches"] = int((cpu_u8[out_name] != card_u8[out_name]).sum())
            entry["output"] = out_name
        report["downstream"][int(node_id)] = entry
    return report


def template_phase(mesh) -> dict:
    """Phase 11: the six templates. Returns `{path name: (counts, blur
    launches by sigma)}` of every 4096² sequence."""
    import tempfile

    import torch
    from kanter_core_tpu_torch import (
        Node, NodeGraph, NodeType, SlotData, SlotId, SlotImage, TextureProcessor, LiveGraph,
    )
    from kanter_core_tpu_torch.ops import exact_math, image_io
    from kanter_core_tpu_torch.ops.levels import levels_plane
    from kanter_core_tpu_torch.slot_image import gray_to_u8_srgb, rgba_to_u8_srgb

    paths = {}
    t0 = time.perf_counter()
    kept = {}
    for name in TEMPLATES:
        fused = drive_template(name, "cuda", CANVAS, timed=True)
        check_launches(name, fused)
        pn = drive_template(name, "cuda", CANVAS, timed=True, route="no_fuse")
        check_launches(name, pn)
        compare_runs(name, pn.results, fused.results, "per-node vs fused")
        log_read_times(name, fused, pn)
        paths[f"{name}"] = (fused.counts[-1], fused.by_sigma)
        paths[f"pernode_{name}"] = (pn.counts[-1], pn.by_sigma)
        if name in ("wood", "brick"):
            sharded = drive_template(name, "cuda", CANVAS, timed=True, mesh=mesh)
            check_mesh_run(name, fused, sharded, [e["transform"] for e in fused.expected])
            compare_runs(name, sharded.results, fused.results, "mesh vs single device")
            paths[f"mesh_{name}"] = (sharded.counts[-1], sharded.by_sigma)
            del sharded
        if name in ("emboss", "wood"):
            kept[name] = fused
        del fused, pn
        gc.collect()
    log(f"phase 11 templates: {time.perf_counter() - t0:.1f} s")

    # a Graph node wrapping emboss, fused and per node: the flat emboss's bits
    flat = [r for r in kept["emboss"].results if r[0] == "render"]
    for route in ("fused", "no_fuse"):
        nested = drive_template("nested_emboss", "cuda", CANVAS, timed=True, route=route)
        compare_runs("emboss", nested.results, flat, f"nested {route} vs flat")
        log(f"nested emboss {route} launches: {nested.counts}")

    # Write a 4096² RGBA map, decode it through an Image node
    (_, _, albedo, albedo_u8), = [r for r in kept["wood"].results
                                   if r[0] == "render" and r[1] == "albedo"]
    del kept
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "albedo.png")
        tp = TextureProcessor(memory_threshold=16 << 30, device="cuda")
        try:
            lg = tp.new_live_graph()
            with lg.write() as g:
                g.use_cache = True
                inp = g.add_node(Node(NodeType.InputRgba("albedo")))
                write = g.add_node(Node(NodeType.Write(path)))
                g.connect(inp, write, SlotId(0), SlotId(0))
                planes = [torch.from_numpy(p).cuda() for p in albedo]
                g.add_input_slot_data(SlotData(inp, SlotId(0), SlotImage.Rgba(planes)))
                img = g.add_node(Node(NodeType.Image(path)))
                out = g.add_node(Node(NodeType.OutputRgba("decoded")))
                g.connect(img, out, SlotId(0), SlotId(0))
                g.request(write)
            t_write = time.perf_counter()
            with LiveGraph.await_clean_read(lg, write):
                pass
            t_write = (time.perf_counter() - t_write) * 1e3
            if lg.fatal_error is not None:
                raise lg.fatal_error
            t_read = time.perf_counter()
            px = TextureProcessor.buffer_rgba(lg, out, SlotId(0))
            t_read = (time.perf_counter() - t_read) * 1e3
            decoded = [p.host_data() for p in lg.slot_data(out, SlotId(0)).image.planes]
        finally:
            tp.shutdown_now()
        export = albedo_u8.reshape(CANVAS, CANVAS, 4)
        want = [export[:, :, c].astype(np.float32) / np.float32(255) for c in range(4)]
        bad = sum(int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(decoded, want))
        same = np.array_equal(px, albedo_u8)
        with open(path, "rb") as f:
            data = f.read()
        t = time.perf_counter()
        image_io.encode_png(export)
        encode_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        image_io.decode_png(data)
        decode_ms = (time.perf_counter() - t) * 1e3
    log(f"image/write {CANVAS}x{CANVAS} RGBA: Image planes vs u8/255 of the export {bad} f32 "
        f"mismatches, re-export identical {same}; file {len(data)} bytes; encode {encode_ms:.1f} "
        f"ms, decode {decode_ms:.1f} ms (host); Write dispatch {t_write:.1f} ms, Image read "
        f"{t_read:.1f} ms wall")
    if bad or not same:
        raise AssertionError("the Image node did not decode what the Write node saved")

    # pow on the card: ds_pow card = CPU, the sRGB export card = CPU, Levels timed
    i = np.arange(256, dtype=np.float32)
    a = np.ascontiguousarray(np.broadcast_to(i[:, None] / np.float32(255), (256, 256)))
    b = np.ascontiguousarray(np.broadcast_to(np.float32(4) * i[None, :] / np.float32(255),
                                             (256, 256)))
    rng = np.random.default_rng(0)
    big_a = rng.random((CANVAS, CANVAS), dtype=np.float32)
    big_b = rng.random((CANVAS, CANVAS), dtype=np.float32) * np.float32(4)
    for label, (x, y) in (("u8 grid", (a, b)), (f"{CANVAS}x{CANVAS}", (big_a, big_b))):
        xc, yc = torch.from_numpy(x), torch.from_numpy(y)
        card = exact_math.ds_pow(xc.cuda(), yc.cuda()).cpu()
        cpu = exact_math.ds_pow(xc, yc)
        glibc = exact_math.powf_glibc(xc, yc)
        bad = mismatches(card, cpu)
        pow_class = mismatches(cpu, glibc)
        log(f"ds_pow {label}: card vs CPU {bad} mismatches; ds_pow vs glibc powf {pow_class} "
            "(the pow class)")
        if bad:
            raise AssertionError(f"ds_pow differs between the card and the CPU on the {label}")
    v = np.arange(256, dtype=np.float32) / np.float32(255)
    grid = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(v, (4, 256))))
    plane = torch.from_numpy(rng.random((CANVAS, CANVAS), dtype=np.float32))
    for label, x in (("u8 grid", grid), (f"{CANVAS}x{CANVAS}", plane)):
        for fn, k in ((gray_to_u8_srgb, 1), (rgba_to_u8_srgb, 4)):
            card = fn(*[x.cuda()] * k).cpu()
            cpu = fn(*[x] * k)
            bad = int((card != cpu).sum())
            log(f"sRGB export {label} {'gray' if k == 1 else 'rgba'}: card vs CPU {bad} u8 "
                "words differ")
            if bad:
                raise AssertionError(f"the sRGB export differs between the card and the CPU")
    x = plane.cuda()
    for gamma in (1.6, 1.0):
        params = np.asarray([0.2, 0.8, gamma, 0.0, 1.0], np.float32)
        ms = time_cuda(lambda: levels_plane(x, params))
        log(f"Levels {CANVAS}x{CANVAS} gamma {gamma}: {ms:.4f} ms (CUDA events, median of 20)")

    # card against CPU at 1024² under the pow allowance
    for name in TEMPLATES:
        card = drive_template(name, "cuda", 1024, capture=True)
        cpu = drive_template(name, "cpu", 1024, capture=True)
        last = lambda s: {n: u8 for step, n, _, u8 in s.results if step == s.results[-1][0]}  # noqa: E731
        report = pow_class_compare(name, cpu.graph, cpu.nodes, card.nodes, last(cpu), last(card))
        if not report["pow_nodes"] and not report["downstream"]:
            compare_runs(name, card.results, cpu.results)  # no pow: every read exact
        log(f"card vs cpu {name} 1024x1024 (after its last edit): {json.dumps(report)}")
        del card, cpu
        gc.collect()
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return paths


BATCH = 16  # canvases of the batched path (BASELINE config 5)


def batched_kernel_phase(kp_blur, kp_dist, kp_warp) -> dict:
    """Phase 12, the kernels: each dense entry on a batch against its plain
    version (4×1024² and 3×97×411, one launch per call, 0 mismatches), then
    timed at 16×4096² as one batched call beside 16 single calls back to
    back, with its plain version, its library call and its bound; there the
    plain version's output from its timing is held against the batched
    call's on the same inputs (blur σ=6.0, the JFA's far steps and near
    run, the warp), 0 mismatches. Returns
    `{"blur": {"max_abs_err", "timings"}, "jfa": ..., "jfa_near": ...,
    "warp": ...}`; a blur timing per sigma the batched graphs launch."""
    import torch

    rng = np.random.default_rng(12)
    out = {key: {"max_abs_err": 0.0, "timings": []} for key in ("blur", "jfa", "jfa_near", "warp")}

    def batch_of(b, h, w):
        return torch.from_numpy(rng.random((b, h, w), dtype=np.float32)).cuda()

    def one_launch(kernel, before, what):
        if kernel.launches != before + 1:
            raise AssertionError(f"{what}: {kernel.launches - before} launches, want 1")

    def same_bits(what, got, want):
        """Raise unless `got` and `want` (tensors, or lists of them) hold the
        same bits; logs the count."""
        pairs = list(zip(got, want)) if isinstance(got, (list, tuple)) else [(got, want)]
        bad = sum(mismatches(g, r) for g, r in pairs)
        log(f"{what} vs plain: {bad} bit mismatches")
        if bad:
            raise AssertionError(f"{what} differs from its plain version")

    for b, h, w in ((4, 1024, 1024), (3, 97, 411)):
        for sigma in (1.2, 6.0, 12.0):
            x = batch_of(b, h, w)
            before = kp_blur.BLUR_KERNEL.launches
            got = kp_blur.blur_plane_cuda(x, sigma)
            one_launch(kp_blur.BLUR_KERNEL, before, f"batched blur {b}x{h}x{w}")
            want = kp_blur.blur_plane_plain(x, sigma)
            bad = mismatches(got, want)
            err = float((got - want).abs().max().item())
            out["blur"]["max_abs_err"] = max(out["blur"]["max_abs_err"], err)
            log(f"batched blur {b}x{h}x{w} sigma={sigma}: 1 launch, {bad} bit mismatches")
            if bad:
                raise AssertionError(f"batched blur differs from plain at {b}x{h}x{w} σ={sigma}")
        state = kp_dist.pack_seeds((batch_of(b, h, w) < 1e-2).float())
        before = (kp_dist.JFA_KERNEL.launches, kp_dist.JFA_NEAR_KERNEL.launches)
        got = kp_dist.jfa_propagate_cuda(state)
        plan = kp_dist.jfa_launch_plan(h, w)
        far = sum(1 for launch in plan if launch.entry == "step")
        launched = (kp_dist.JFA_KERNEL.launches - before[0],
                    kp_dist.JFA_NEAR_KERNEL.launches - before[1])
        if launched != (far, 1):
            raise AssertionError(f"batched JFA {b}x{h}x{w}: launches {launched}, want {(far, 1)}")
        bad = mismatches(got, kp_dist.jfa_propagate_plain(state))
        log(f"batched jfa {b}x{h}x{w}: {far} + 1 launches, {bad} bit mismatches")
        if bad:
            raise AssertionError(f"batched JFA differs from plain at {b}x{h}x{w}")
        k = kp_warp.warp_bindings((37.0, 5.0))["k"]
        planes = [batch_of(b, h, w) for _ in range(4)]
        m = batch_of(b, h, w) * 1.6 - 0.3
        m.view(-1)[::97] = float("nan")
        for label, ps, st in (("both batched", planes, m), ("strength shared", planes, m[0]),
                              ("planes shared", [p[0] for p in planes], m)):
            st = st.contiguous()
            ps = [p.contiguous() for p in ps]
            before = kp_warp.WARP_KERNEL.launches
            got = kp_warp.warp_planes_cuda(ps, st, k)
            one_launch(kp_warp.WARP_KERNEL, before, f"batched warp {b}x{h}x{w} {label}")
            want = kp_warp.warp_planes_plain(ps, st, k)
            bad = sum(mismatches(g, r) for g, r in zip(got, want))
            err = max(float((g - r).abs().max().item()) for g, r in zip(got, want))
            out["warp"]["max_abs_err"] = max(out["warp"]["max_abs_err"], err)
            log(f"batched warp {b}x{h}x{w} RGBA {label}: 1 launch, {bad} bit mismatches")
            if bad:
                raise AssertionError(f"batched warp differs from plain at {b}x{h}x{w} {label}")
        torch.cuda.synchronize()

    # timings at 16×4096²
    n, b = CANVAS * CANVAS, BATCH
    x = batch_of(b, CANVAS, CANVAS)
    for sigma in (0.8, 1.0, 1.2, 2.0, 4.0, 6.0):
        taps = kp_blur.gaussian_taps(round(sigma, 6))
        ms = time_cuda(lambda: kp_blur.blur_plane_cuda(x, sigma), runs=10)
        singles = [x[i] for i in range(b)]
        singles_ms = time_cuda(lambda: [kp_blur.blur_plane_cuda(p, sigma) for p in singles],
                               runs=10)
        bound, by = blur_bound(b * n, 0, len(taps))
        t = {"shape": f"{b}x{CANVAS}x{CANVAS}", "sigma": sigma, "taps": len(taps), "ms": ms,
             "singles_ms": singles_ms, "bound_ms": bound, "bound_by": by,
             "plain_ms": None, "library_ms": None}
        if sigma == 6.0:
            kept = {}
            t["plain_ms"] = time_cuda(
                lambda: kept.update(out=kp_blur.blur_plane_plain(x, sigma)), runs=3, warmup=1)
            same_bits(f"batched blur {b}x{CANVAS}x{CANVAS} sigma={sigma}",
                      kp_blur.blur_plane_cuda(x, sigma), kept.pop("out"))
            t["library_ms"] = time_cuda(lambda: blur_library(x, taps), runs=5)
        log(f"batched blur {t['shape']} sigma={sigma}: {ms:.4f} ms in one launch, {b} single "
            f"calls {singles_ms:.4f} ms, plain {t['plain_ms']}, library {t['library_ms']}, "
            f"bound {bound:.4f} ms ({by})")
        out["blur"]["timings"].append(t)
    del x
    state = kp_dist.pack_seeds((batch_of(b, CANVAS, CANVAS) < 1e-2).float())
    plan = kp_dist.jfa_launch_plan(CANVAS, CANVAS)
    far = [launch for launch in plan if launch.entry == "step"]
    near = [launch for launch in plan if launch.entry == "near"]
    before_near = kp_dist.jfa_run_launches(state, far)
    singles = [state[i].contiguous() for i in range(b)]
    singles_near = [before_near[i].contiguous() for i in range(b)]
    for key, launches, start, single_starts in (("jfa", far, state, singles),
                                                ("jfa_near", near, before_near, singles_near)):
        ks = [k for launch in launches for k in launch.steps]
        ms = time_cuda(lambda: kp_dist.jfa_run_launches(start, launches), runs=10)
        singles_ms = time_cuda(
            lambda: [kp_dist.jfa_run_launches(s, launches) for s in single_starts], runs=5)

        kept = {}

        def plain(start=start, ks=ks):
            for k in ks:
                start = kp_dist.jfa_step_plain(start, k)
            kept["out"] = start

        plain_ms = time_cuda(plain, runs=2, warmup=1)
        same_bits(f"batched {key} {b}x{CANVAS}x{CANVAS}",
                  kp_dist.jfa_run_launches(start, launches), kept.pop("out"))
        bound, by = jfa_bound(b * n, len(ks))
        log(f"batched {key} {b}x{CANVAS}x{CANVAS} steps {ks}: {ms:.4f} ms in {len(launches)} "
            f"launches, {b} single ladders {singles_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"none, bound {bound:.4f} ms ({by})")
        out[key]["timings"].append({
            "shape": f"{b}x{CANVAS}x{CANVAS}", "steps_covered": ks, "launches": len(launches),
            "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound, "bound_by": by})
    del state, before_near, singles, singles_near
    k = kp_warp.warp_bindings((37.0, 5.0))["k"]
    planes = [batch_of(b, CANVAS, CANVAS) for _ in range(4)]
    strength = torch.from_numpy(rng.random((CANVAS, CANVAS), dtype=np.float32)).cuda()
    ms = time_cuda(lambda: kp_warp.warp_planes_cuda(planes, strength, k), runs=10)
    single_planes = [[p[i] for p in planes] for i in range(b)]
    singles_ms = time_cuda(
        lambda: [kp_warp.warp_planes_cuda(ps, strength, k) for ps in single_planes], runs=5)
    kept = {}
    plain_ms = time_cuda(
        lambda: kept.update(out=kp_warp.warp_planes_plain(planes, strength, k)), runs=2,
        warmup=1)
    same_bits(f"batched warp {b}x{CANVAS}x{CANVAS} RGBA, strength shared",
              kp_warp.warp_planes_cuda(planes, strength, k), kept.pop("out"))
    library = warp_library(planes, strength, k)
    library_ms = time_cuda(library, runs=5)
    bound, by = bound_ms(4.0 * n + 32.0 * b * n, WARP_FLOPS_PER_PX * b * n, FP32_FLOPS)
    log(f"batched warp {b}x{CANVAS}x{CANVAS} RGBA, strength shared: {ms:.4f} ms in one launch, "
        f"{b} single calls {singles_ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    out["warp"]["timings"].append({
        "shape": f"{b}x{CANVAS}x{CANVAS}", "payload": [37.0, 5.0], "strength": "shared",
        "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound, "bound_by": by})
    del planes, single_planes, library
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kernel_graph():
    """InputGray height → Blur 6.0, → Distance 512, and Warp(37°, 5) of the
    Distance's output by the blurred height: the one graph where the three
    batched entries all run on batched operands. Returns (graph, input id,
    output id)."""
    from kanter_core_tpu_torch import Node, NodeGraph, NodeType, SlotId

    graph = NodeGraph()
    height = graph.add_node(Node(NodeType.InputGray("height")))
    blur = graph.add_node(Node(NodeType.Blur(6.0)))
    dist = graph.add_node(Node(NodeType.Distance(512.0)))
    warp = graph.add_node(Node(NodeType.Warp(37.0, 5.0)))
    out = graph.add_node(Node(NodeType.OutputGray("out")))
    graph.connect(height, blur, SlotId(0), SlotId(0))
    graph.connect(height, dist, SlotId(0), SlotId(0))
    graph.connect(dist, warp, SlotId(0), SlotId(0))
    graph.connect(blur, warp, SlotId(0), SlotId(1))
    graph.connect(warp, out, SlotId(0), SlotId(0))
    return graph, height, out


def batched_graphs(n: int):
    """Phase 12's four graphs at `n`²: `{name: (graph, input ids, value id
    or None)}` (the chain's `v`)."""
    from kanter_core_tpu_torch import NodeTypeKind
    from kanter_core_tpu_torch.graphs import bounded_chain_graph, flagship_graph
    from kanter_core_tpu_torch.models import pbr_material_graph

    chain, inputs, v, _ = bounded_chain_graph(depth=16)
    pbr = pbr_material_graph()
    height = [x.node_id for x in pbr.nodes if x.node_type.kind == NodeTypeKind.INPUT_GRAY]
    flag, flag_inputs, _ = flagship_graph(n)
    kgraph, kheight, _ = kernel_graph()
    return {"chain": (chain, inputs, v), "pbr": (pbr, height, None),
            "flagship": (flag, flag_inputs, None), "kernels": (kgraph, [kheight], None)}


def batch_inputs(input_ids, b: int, n: int, seed: int, device, masked: bool = False):
    """`{input_<id>: ([b, n, n] batch,)}` from `default_rng(seed)`, made on
    the host and moved once; `masked`: a seed mask at density 1e-2 plus
    0.4 × noise (the kernel graph's height, so the Distance has seeds)."""
    import torch

    rng = np.random.default_rng(seed)
    args = {}
    for node in input_ids:
        x = rng.random((b, n, n), dtype=np.float32)
        if masked:
            x = ((rng.random((b, n, n)) < 1e-2) + x * np.float32(0.4)).astype(np.float32)
        args[f"input_{int(node)}"] = (torch.from_numpy(x).to(device),)
    return args


def checksum(planes) -> float:
    return float(sum(p.double().sum().item() for p in planes))


def check_canvases(label, graph, args, result, value=None) -> None:
    """The first and the last canvas of a batched result against the
    single-canvas `CompiledGraph` on the card, bit for bit."""
    from kanter_core_tpu_torch.compiler import CompiledGraph

    prog = CompiledGraph(graph, device="cuda")
    if value is not None:
        prog.set_value(*value)
    for i in (0, BATCH - 1):
        single = prog(**{k: (v[0][i],) for k, v in args.items()})
        bad = {str(key): [mismatches(p, q[i]) for p, q in zip(planes, result[key])]
               for key, planes in single.items()}
        log(f"batched {label} canvas {i} vs single-canvas CompiledGraph: mismatches {bad}")
        if any(any(v) for v in bad.values()):
            raise AssertionError(f"batched {label}: canvas {i} differs from its single render")
        del single


def batched_graph_phase() -> dict:
    """Phase 12, the graphs at 16×4096²: BASELINE config 5 through
    `BatchedLiveSession` (render, then `v` 0.96 → 0.93 → 0.96), PBR, the
    flagship and the kernel graph through `BatchedGraph`; launches per
    render against the single-canvas render's, canvases 0 and 15 against
    it bit for bit, peak device memory; card = CPU at 4×256² (f32 and u8);
    the kernel graph over a batch mesh of 2 shards on cuda:0 (and of the
    four cards, if present) against one device. Returns `({path name:
    (counts, blur launches by sigma)}, {path name: batched launch
    counts})`."""
    import torch
    from kanter_core_tpu_torch import SlotId
    from kanter_core_tpu_torch.compiler import CompiledGraph
    from kanter_core_tpu_torch.parallel import (
        MESH_COUNTERS, BatchedGraph, BatchedLiveSession, BatchShards, make_mesh,
    )

    paths, batched = {}, {}
    graphs = batched_graphs(CANVAS)

    # 1. BASELINE config 5 at spec: the chain through the session
    chain, inputs, v = graphs["chain"]
    session = BatchedLiveSession(chain, inputs, device="cuda")
    args = batch_inputs(inputs, BATCH, CANVAS, 0, "cuda")
    for node in inputs:
        session.set_input(node, args[f"input_{int(node)}"][0])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sums = []
    for step, value in (("render", None), ("v 0.93", 0.93), ("v 0.96", 0.96)):
        if value is not None:
            session.set_value(v, value)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        result = session.render()
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        (key,) = result
        sums.append(checksum(result[key]))
        log(f"batched chain {BATCH}x{CANVAS}x{CANVAS} {step}: {wall:.3f} ms wall, "
            f"{start.elapsed_time(end):.3f} ms CUDA events, checksum {sums[-1]!r}, "
            f"programs {len(session._programs)}")
    paths["batched_chain"] = (launch_counts(), blur_launches_by_sigma())
    batched["batched_chain"] = batched_launch_counts()
    if len(session._programs) != 1:
        raise AssertionError(f"the value edits built {len(session._programs)} programs, want 1")
    if sums[0] == sums[1] or sums[1] == sums[2]:
        raise AssertionError(f"batched chain: checksums {sums} did not change with v")
    if sums[0] != sums[2]:
        raise AssertionError(f"batched chain: v back at 0.96 gives {sums[2]!r}, not {sums[0]!r}")
    if not all(torch.isfinite(p).all() for p in result[key]):
        raise AssertionError("batched chain: non-finite output")
    log(f"batched chain peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check_canvases("chain", chain, args, result, value=(v, 0.96))
    del session, result, args
    gc.collect()

    # 2-4. PBR, the flagship and the kernel graph through BatchedGraph
    for name in ("pbr", "flagship", "kernels"):
        graph, inputs, _ = graphs[name]
        args = batch_inputs(inputs, BATCH, CANVAS, 1, "cuda", masked=name == "kernels")
        single = CompiledGraph(graph, device="cuda")
        reset_counts()
        single(**{k: (a[0][0],) for k, a in args.items()})
        torch.cuda.synchronize()
        want = launch_counts()
        bg = BatchedGraph(graph, set(args), device="cuda")
        bg(**args)  # warm-up: the per-shape host tables
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        result = bg(**args)
        end.record()
        end.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = launch_counts()
        paths[f"batched_{name}"] = (got, blur_launches_by_sigma())
        batched[f"batched_{name}"] = got_batched = batched_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"batched {name} {BATCH}x{CANVAS}x{CANVAS}: {wall:.3f} ms wall, "
            f"{start.elapsed_time(end):.3f} ms CUDA events, peak device memory {peak:.3f} GiB; "
            f"launches {got}, the single-canvas render's {want}")
        if got != want or not any(got[key] for key in ("blur", "jfa", "warp")):
            raise AssertionError(f"batched {name}: launches {got}, want the single canvas's {want}")
        # every launch takes the whole batch, except the flagship's jump
        # flood: its Distance reads the Pattern alone and runs once, unbatched
        want_batched = {key: got[key] for key in got_batched}
        if name == "flagship":
            want_batched.update(jfa=0, jfa_near=0)
        log(f"batched {name}: launches over the batch {got_batched}")
        if got_batched != want_batched:
            raise AssertionError(f"batched {name}: batched launches {got_batched}, want "
                                 f"{want_batched}")
        if peak >= 80:
            raise AssertionError(f"batched {name}: peak {peak:.3f} GiB")
        for key, planes in result.items():
            if not all(p.shape == (BATCH, CANVAS, CANVAS) and torch.isfinite(p).all()
                       for p in planes):
                raise AssertionError(f"batched {name} {key}: wrong shape or non-finite values")
        check_canvases(name, graph, args, result)
        if name == "kernels":
            kernel_result, kernel_args = result, args
        del single, bg, result
        gc.collect()

    # the kernel graph over a batch mesh against one device
    meshes = [make_mesh(devices=["cuda:0"] * 2, axes=("batch",))]
    if torch.cuda.device_count() >= 4:
        meshes.append(make_mesh(4, axes=("batch",)))
    graph, _, _ = graphs["kernels"]
    ((key, (want_plane,)),) = kernel_result.items()
    for mesh in meshes:
        bg = BatchedGraph(graph, set(kernel_args), mesh=mesh)
        sharded = {k: (bg.shard_batch_arg(a[0]),) for k, a in kernel_args.items()}
        reset_counts()
        (plane,) = bg(**sharded)[key]
        if not isinstance(plane, BatchShards) or MESH_COUNTERS.snapshot()["gathers"]["batch"]:
            raise AssertionError(f"batch mesh {mesh}: the output was gathered")
        whole = plane.gather("cuda:0")
        snap = MESH_COUNTERS.snapshot()
        want_g = dict.fromkeys(MESH_COUNTERS.CAUSES, 0)
        want_g["batch"] = 1
        bad = mismatches(whole, want_plane)
        log(f"batched kernels over {mesh}: {bad} mismatches against one device, launches "
            f"{launch_counts()}, mesh counters {snap}")
        if bad or snap["gathers"] != want_g or snap["exchanges"]:
            raise AssertionError(f"batch mesh {mesh}: mismatches {bad}, counters {snap}")
        del bg, sharded, plane, whole
    del kernel_result, kernel_args, want_plane
    gc.collect()
    torch.cuda.empty_cache()

    # card = CPU at 4×256², f32 and u8
    small = batched_graphs(256)
    for name, (graph, inputs, v) in small.items():
        runs = {}
        for device in ("cuda", "cpu"):
            args = batch_inputs(inputs, 4, 256, 2, device, masked=name == "kernels")
            if v is not None:
                args[f"value_{int(v)}"] = np.asarray([0.96, 0.93, 0.95, 0.91], np.float32)
            f32 = BatchedGraph(graph, set(args), device=device)(**args)
            u8 = BatchedGraph(graph, set(args), include_u8=True, device=device)(**args)
            runs[device] = (f32, u8)
        (f32_card, u8_card), (f32_cpu, u8_cpu) = runs["cuda"], runs["cpu"]
        counts = {str(key): [mismatches(p.cpu(), q) for p, q in zip(f32_card[key], f32_cpu[key])]
                  for key in f32_cpu}
        same_u8 = all(torch.equal(u8_card[key].cpu(), u8_cpu[key]) for key in u8_cpu)
        log(f"batched card vs cpu {name} 4x256x256: f32 mismatches {counts}, u8 identical "
            f"{same_u8}")
        if not same_u8 or any(any(c) for c in counts.values()):
            raise AssertionError(f"batched {name}: the card and the CPU disagree")
    return paths, batched


def gap_ranking(entries) -> list:
    """For each kernel: over the 4096² sequences, launches × (ms − bound) in
    ms, the time a perfect kernel would give back; largest first. A blur
    launch takes the timing of its own sigma, a far JFA launch the mean far
    step, the near launch the near run; a launch over a batch takes the
    batched timing (the warp's: RGBA over a shared strength map)."""
    ranking = []
    for e in entries:
        by_path = {}
        for path, launches in e["launches_by_path"].items():
            by_sigma = e.get("launches_by_sigma", {}).get(path)
            # a launch over a batch takes the batched timing (the batched
            # paths' blur launches are all over the batch)
            n_batched = e.get("batched", {}).get("launches_by_path", {}).get(path, 0)
            timings = e["batched"]["timings"] if n_batched else e["timings"]
            if by_sigma is None:
                gap = 0.0
                for (ms, bound, steps), count in (
                        ((e["ms"], e["bound_ms"], e["timings"][-1].get("steps_covered")),
                         launches - n_batched),
                        ((timings[-1]["ms"], timings[-1]["bound_ms"],
                          timings[-1].get("steps_covered")), n_batched)):
                    if e["name"] == "kanter_jfa_step_i32":  # a far launch: the mean step
                        ms, bound = ms / len(steps), bound / len(steps)
                    gap += count * (ms - bound)
                by_path[path] = gap
                continue
            timed = {t["sigma"]: t for t in timings}
            by_path[path] = sum(
                count * (timed[sigma]["ms"] - timed[sigma]["bound_ms"])
                for sigma, count in by_sigma.items()
            )
        ranking.append({"name": e["name"], "gap_ms_by_path": by_path,
                        "gap_ms": sum(by_path.values())})
    return sorted(ranking, key=lambda r: -r["gap_ms"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "kanter_core_tpu_torch")):
        log(f"chip_smoke: no kanter_core_tpu_torch package beside {__file__}; run it from a "
            "checkout of the repo")
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
    kp_dist.JFA_NEAR_KERNEL.entry()
    kp_warp.WARP_BLOCK_KERNEL.entry()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase:.1f} s")
        t_phase = now

    phase_done("build")

    # 3. kernels vs plain
    blur = blur_phase(kp_blur)
    jfa, jfa_near = jfa_phase(kp_dist)
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
    pbr_path, pbr_sigmas = pbr_counts[-1], pbr.by_sigma

    # 5. the flagship at full size, counters from 0
    flag = drive_flagship("cuda", 4096, timed=True)
    flag_counts = flag.counts
    log(f"flagship launches after each read (render, value, distance, warp edit): {flag_counts}")
    plan = kp_dist.jfa_launch_plan(CANVAS, CANVAS)
    ladders = [1, 1, 2, 2]  # Distance ran on the render and on its own edit
    for key, entry in (("jfa", "step"), ("jfa_near", "near")):
        per_ladder = sum(1 for launch in plan if launch.entry == entry)
        want_jfa = [per_ladder * n for n in ladders]
        if per_ladder < 1 or [c[key] for c in flag_counts] != want_jfa:
            raise AssertionError(f"{key} launches {[c[key] for c in flag_counts]}, the plan "
                                 f"gives {want_jfa}")
    if [c["warp"] for c in flag_counts] != [1, 2, 3, 4]:
        raise AssertionError(f"warp launches {[c['warp'] for c in flag_counts]}, want [1, 2, 3, 4]")
    b = [c["blur"] for c in flag_counts]
    if not (b[0] == 7 and b[1] == 14 and b[2] == 21 and b[3] == 21):
        raise AssertionError(f"blur launches {b}, want [7, 14, 21, 21] (3 AO + 4 RGBA planes)")
    flag_path, flag_sigmas = flag_counts[-1], flag.by_sigma
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
    check_mesh_run("pbr", pbr, mesh_pbr)
    mesh_pbr_path, mesh_pbr_sigmas = mesh_pbr.counts[-1], mesh_pbr.by_sigma
    compare_runs("pbr", mesh_pbr.results, pbr.results, "mesh vs single device")
    mesh_flag = drive_flagship("cuda", 4096, timed=True, mesh=mesh)
    check_mesh_run("flagship", flag, mesh_flag)
    mesh_flag_path, mesh_flag_sigmas = mesh_flag.counts[-1], mesh_flag.by_sigma
    compare_runs("flagship", mesh_flag.results, flag.results, "mesh vs single device")
    del mesh_pbr
    phase_done("mesh slices")

    # 9. mesh on the card against mesh on the CPU at 1024²
    cpu_mesh = make_mesh(devices=["cpu"] * 4)
    compare_runs("pbr", drive_pbr("cuda", 1024, mesh=mesh).results,
                 drive_pbr("cpu", 1024, mesh=cpu_mesh).results, "mesh card vs mesh cpu")
    compare_runs("flagship", drive_flagship("cuda", 1024, mesh=mesh).results,
                 drive_flagship("cpu", 1024, mesh=cpu_mesh).results, "mesh card vs mesh cpu")
    phase_done("mesh card vs cpu")

    # 10. the per-node route: the PBR sequence under auto_update and the
    # flagship sequence with fuse_subgraphs=False at full size, counters from
    # 0 before each; every read bit-identical to the fused route's (phases 4
    # and 5), the launches those derived from the graph; the flagship's over
    # four shards against one device; card vs CPU at 1024²
    pn_pbr = drive_pbr("cuda", CANVAS, timed=True, route="auto_update", keep=True)
    check_launches("pbr", pn_pbr)
    compare_runs("pbr", pn_pbr.results, pbr.results, "per-node vs fused")
    log_read_times("pbr", pbr, pn_pbr)
    pn_flag = drive_flagship("cuda", CANVAS, timed=True, route="no_fuse")
    check_launches("flagship", pn_flag)
    compare_runs("flagship", pn_flag.results, flag.results, "per-node vs fused")
    log_read_times("flagship", flag, pn_flag)
    mesh_pn_flag = drive_flagship("cuda", CANVAS, timed=True, mesh=mesh, route="no_fuse")
    check_mesh_run("per-node flagship", pn_flag, mesh_pn_flag)
    compare_runs("flagship", mesh_pn_flag.results, pn_flag.results, "per-node mesh vs single device")
    log_read_times("mesh flagship", mesh_flag, mesh_pn_flag)
    pn_pbr_path, pn_pbr_sigmas = pn_pbr.counts[-1], pn_pbr.by_sigma
    pn_flag_path, pn_flag_sigmas = pn_flag.counts[-1], pn_flag.by_sigma
    mesh_pn_path, mesh_pn_sigmas = mesh_pn_flag.counts[-1], mesh_pn_flag.by_sigma
    del pbr, flag, mesh_flag, pn_pbr, pn_flag, mesh_pn_flag
    compare_runs("flagship", drive_flagship("cuda", 1024, route="no_fuse").results,
                 drive_flagship("cpu", 1024, route="no_fuse").results, "per-node card vs cpu")
    # the PBR graph's default use_cache=False: parents' planes dropped once
    # their children are done, while siblings still read them
    compare_runs("pbr", drive_pbr("cuda", 1024, route="auto_update").results,
                 drive_pbr("cpu", 1024, route="auto_update").results, "per-node card vs cpu")
    phase_done("per-node")

    # 11. the six templates: fused, per node and (wood, brick) over the mesh
    # at full size, a nested Graph, Image → Write, pow on the card, card vs
    # CPU at 1024² under the pow allowance
    template_paths = template_phase(mesh)
    phase_done("templates")

    # 12. the batched path: each dense entry on a batch against its plain
    # version and timed at 16×4096², then BASELINE config 5 through
    # BatchedLiveSession, PBR, the flagship and the kernel graph through
    # BatchedGraph at 16×4096², a batch mesh, card vs CPU at 4×256²
    batched = batched_kernel_phase(kp_blur, kp_dist, kp_warp)
    batched_paths, batched_counts = batched_graph_phase()
    phase_done("batched")

    paths = {"pbr": (pbr_path, pbr_sigmas), "flagship": (flag_path, flag_sigmas),
             "mesh_pbr": (mesh_pbr_path, mesh_pbr_sigmas),
             "mesh_flagship": (mesh_flag_path, mesh_flag_sigmas),
             "pernode_pbr": (pn_pbr_path, pn_pbr_sigmas),
             "pernode_flagship": (pn_flag_path, pn_flag_sigmas),
             "pernode_mesh_flagship": (mesh_pn_path, mesh_pn_sigmas), **template_paths,
             **batched_paths}

    def by_path(key):
        return {name: counts[key] for name, (counts, _) in paths.items()}

    def by_sigma(key):
        return {name: sigmas[key] for name, (_, sigmas) in paths.items()}

    def entry(name, source, replaces, phase, main, key, batched_key=None):
        e = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path(key).values()), "launches_by_path": by_path(key),
            "max_abs_err": phase["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "timings": phase["timings"],
        }
        if key in ("blur", "blur_block"):
            e["launches_by_sigma"] = by_sigma(key)
        if batched_key is not None:
            # the launches over a whole batch (one launch for all canvases)
            e["batched"] = dict(batched[batched_key], launches_by_path={
                path: counts[key] for path, counts in batched_counts.items()})
        return e

    entries = [
        entry("kanter_blur_wrap_f32", "kanter_core_tpu_torch/csrc/blur.cu",
              "kanter_core_tpu/ops/pallas_blur.py:77",
              blur,
              next(t for t in blur["timings"] if t["sigma"] == 6.0), "blur", "blur"),
        entry("kanter_jfa_step_i32", "kanter_core_tpu_torch/csrc/jfa.cu",
              "kanter_core_tpu/ops/pallas_distance.py:90",
              jfa, jfa["timings"][-1], "jfa", "jfa"),
        entry("kanter_jfa_near_i32", "kanter_core_tpu_torch/csrc/jfa.cu",
              "kanter_core_tpu/ops/pallas_distance.py:90",
              jfa_near, jfa_near["timings"][-1], "jfa_near", "jfa_near"),
        entry("kanter_warp_bilinear_f32", "kanter_core_tpu_torch/csrc/warp.cu",
              "kanter_core_tpu/ops/pallas_warp.py:147",
              warp, warp["timings"][0], "warp", "warp"),
        entry("kanter_blur_block_f32", "kanter_core_tpu_torch/csrc/blur.cu",
              "kanter_core_tpu/ops/pallas_blur.py:419",
              blur_block,
              next(t for t in blur_block["timings"] if t["sigma"] == 6.0), "blur_block"),
        entry("kanter_warp_block_f32", "kanter_core_tpu_torch/csrc/warp.cu",
              "kanter_core_tpu/ops/pallas_warp.py:306",
              warp_block, warp_block["timings"][0],
              "warp_block"),
    ]
    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on the main path")
    log(json.dumps({"gap_ranking": gap_ranking(entries)}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
