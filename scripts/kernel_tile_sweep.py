#!/usr/bin/env python3
"""Sweep of the host-side tile choices of the blur, the jump-flood near
and the warp block kernels, on one GPU.

    python3 scripts/kernel_tile_sweep.py [--size 4096] [--probe] [--lattice]
    python3 scripts/kernel_tile_sweep.py --warp [--size 4096] [--sass]

`ops/blur.blur_tile_plan` and `ops/distance.jfa_launch_plan` pick one tile
per radius and shape. This script times the alternatives, so that the
choice written there rests on a measurement:

- the blur of a size² plane at every sigma the PBR and flagship graphs
  launch, on every tile of th in (16, 24, 32, 48, 64, 96, 128) by tw in
  (64, 128, 192) that the kernel takes;
- the fused near run (8, 4, 2, 1, 1) of a size² jump-flood state, on
  square and wide tiles from 32 to 128.

`--probe` also builds a copy of `csrc/blur.cu` whose staging stores a
constant instead of copying from device memory (its results are wrong by
design) and times it beside the real kernel on the planned tiles: what is
left is the time of the two passes and the output's stores alone.

`--lattice` rebuilds `csrc/jfa.cu` with other lattice patches per thread
(rows x columns) and other occupancy targets (`KANTER_JFA_LATTICE_*`) and
times the far steps of the size² ladder with each, compared bit for bit
with the built-in choice.

`--warp` sweeps the warp's block entry instead (and nothing else): the
first of four row blocks of size² RGBA with its ring halos, at the main
path's (37°, 5) and (37°, 9) and at (90°, 64), over tiles, adjacent pixels
with vector accesses against strided ones, and the three index modes (the
remainder forms cost what the general paths cost). Edited copies of
`csrc/warp.cu` add what the kernel does not carry: 1 and 4 pixels per
thread (against its 2), and the planned launch with a register bound for
4, 6 or 8 blocks per SM and without the inner rows' shortcut. Each calls
the C entry with its operands prepared once, so that the card, not the
wrapper, is timed. `--sass` also prints the instruction mix of the
kernel's and of the 4-pixel copy's instances from `cuobjdump -sass`.

Each reading is the median of 20 CUDA-event timings of 10 calls back to
back; every result is compared bit for bit with the planned tile's (the
warp's with its plain version). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_cuda(fn, runs: int = 20, calls: int = 10) -> float:
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


def blur_without_loads(blur):
    """The blur entry of a copy of the kernel that reads no input."""
    import ctypes

    from kanter_core_tpu_torch import build

    with open(blur.BLUR_KERNEL.source) as f:
        text = f.read()
    copies = {
        "__pipeline_memcpy_async(dst + 32 * c, src + gx[c], sizeof(float));":
            "dst[32 * c] = 1.0f;",
        "__pipeline_memcpy_async(tile + i * pitch + 4 * m, src, 4 * sizeof(float));":
            "*reinterpret_cast<float4*>(tile + i * pitch + 4 * m) = "
            "make_float4(1.0f, 1.0f, 1.0f, 1.0f + (src == nullptr));",
    }
    for copy, store in copies.items():
        if text.count(copy) != 1:
            raise AssertionError("a staging copy of csrc/blur.cu is not where the probe expects it")
        text = text.replace(copy, store)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "blur_no_load.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = build.build_library("blur_no_load", [path], [build.nvcc(), *build.NVCC_FLAGS])
    fn = getattr(ctypes.CDLL(lib), blur.BLUR_KERNEL.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = blur.BLUR_KERNEL.argtypes
    return fn


def lattice_variant(distance, rows: int, cols: int, blocks: int):
    """The far-step entry of `csrc/jfa.cu` built with another lattice patch."""
    import ctypes

    from kanter_core_tpu_torch import build

    flags = [f"-DKANTER_JFA_LATTICE_ROWS={rows}", f"-DKANTER_JFA_LATTICE_COLS={cols}",
             f"-DKANTER_JFA_LATTICE_BLOCKS={blocks}"]
    lib = build.build_library("jfa_lattice", [distance.JFA_KERNEL.source],
                              [build.nvcc(), *build.NVCC_FLAGS, *flags])
    with open(lib + ".log") as f:
        report = [line.strip() for line in f if "registers" in line or "spill" in line]
    fn = getattr(ctypes.CDLL(lib), distance.JFA_KERNEL.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = distance.JFA_KERNEL.argtypes
    return fn, report


def sass_mix(lib: str) -> None:
    """Per kernel of a built library: its static instruction count and the
    most frequent opcodes, from `cuobjdump -sass`."""
    import collections
    import re
    import shutil

    from kanter_core_tpu_torch import build

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    for part in re.split(r"\n\s+Function : ", text)[1:]:
        name = part.split("\n")[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", part)
        mix = collections.Counter(op.split(".")[0] for op in ops).most_common(16)
        print(f"sass {name[-70:]}: {len(ops)} instructions; "
              + ", ".join(f"{op} {n}" for op, n in mix), flush=True)


# edits of a copy of csrc/warp.cu for the variants the kernel does not
# carry: other pixels per thread (the 8-byte accesses become 4- or 16-byte
# ones), a register bound for more blocks per SM, no inner rows' shortcut
_WARP_PX_SOURCE = {
    "kPx": "constexpr int kPx = 2;",
    "load": "const float2 t = __ldg(reinterpret_cast<const float2*>(a.strength + row + x_first));"
            "\n            m[0] = t.x, m[1] = t.y;",
    "store": "*reinterpret_cast<float2*>(dst + x_first) = make_float2(o[0], o[1]);",
}
_WARP_PX_EDITS = {
    1: {"kPx": "constexpr int kPx = 1;",
        "load": "m[0] = __ldg(a.strength + row + x_first);",
        "store": "dst[x_first] = o[0];"},
    4: {"kPx": "constexpr int kPx = 4;",
        "load": "const float4 t = __ldg(reinterpret_cast<const float4*>(a.strength + row + "
                "x_first));\n            m[0] = t.x, m[1] = t.y, m[2] = t.z, m[3] = t.w;",
        "store": "*reinterpret_cast<float4*>(dst + x_first) = "
                 "make_float4(o[0], o[1], o[2], o[3]);"},
}
_WARP_BOUNDS = "__launch_bounds__(kThreads)"
_WARP_INNER = "const bool inner = MODE != kGeneral &&"


def warp_variant(warp, tag: str, edits: dict):
    """The block entry of a copy of `csrc/warp.cu` with `edits` (each text
    there exactly once, replaced), and the ptxas lines of its kernels."""
    import ctypes

    from kanter_core_tpu_torch import build

    with open(warp.WARP_BLOCK_KERNEL.source) as f:
        text = f.read()
    for old, new in edits.items():
        if text.count(old) != 1:
            raise AssertionError(f"{old!r} is not once in csrc/warp.cu")
        text = text.replace(old, new)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, f"warp_{tag}.cu")
    with open(path, "w") as f:
        f.write(text)
    lib = build.build_library(f"warp_{tag}", [path], [build.nvcc(), *build.NVCC_FLAGS])
    fn = getattr(ctypes.CDLL(lib), warp.WARP_BLOCK_KERNEL.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = warp.WARP_BLOCK_KERNEL.argtypes
    with open(lib + ".log") as f:
        report = [line.strip() for line in f if "registers" in line]
    return fn, lib, report


def warp_variants(warp) -> dict:
    """Every variant's (entry, library, ptxas lines), built in parallel:
    `px1` and `px4` pixels per thread, `blocks4/6/8` register bounds,
    `no_inner`."""
    from concurrent.futures import ThreadPoolExecutor

    edits = {f"px{px}": {_WARP_PX_SOURCE[key]: new for key, new in e.items()}
             for px, e in _WARP_PX_EDITS.items()}
    for blocks in (4, 6, 8):
        edits[f"blocks{blocks}"] = {_WARP_BOUNDS: f"__launch_bounds__(kThreads, {blocks})"}
    edits["no_inner"] = {_WARP_INNER: "const bool inner = false &&"}
    with ThreadPoolExecutor(len(edits)) as pool:
        built = {tag: pool.submit(warp_variant, warp, tag, e) for tag, e in edits.items()}
        return {tag: f.result() for tag, f in built.items()}


def warp_sweep(size: int, sass: bool) -> None:
    """The block warp's launches, timed against each other on one block.
    Each launch calls the kernel's C entry with its operands prepared once,
    so that ten calls back to back keep the card busy and read its time, not
    the wrapper's."""
    import torch

    from kanter_core_tpu_torch.ops import warp
    from kanter_core_tpu_torch.parallel import make_mesh, shard_planes_rows

    n = size
    rng = np.random.default_rng(5)
    planes = [torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda() for _ in range(4)]
    m = rng.random((n, n), dtype=np.float32) * np.float32(1.6) - np.float32(0.3)
    m.flat[::97] = np.nan
    mesh = make_mesh(devices=["cuda:0"] * 4)
    sps = [shard_planes_rows(mesh, p) for p in planes]
    ss = shard_planes_rows(mesh, torch.from_numpy(m).cuda())
    kernel = warp.WARP_BLOCK_KERNEL.entry()
    variants = warp_variants(warp)
    for tag, (_, _, report) in sorted(variants.items()):
        regs = sorted({line.split("Used ")[1].split(",")[0] for line in report})
        print(f"variant {tag}: {'; '.join(regs)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    bh = n // 4
    outs = [torch.empty_like(ss.bands[0]) for _ in range(4)]
    for payload in ((37.0, 5.0), (37.0, 9.0), (90.0, 64.0)):
        b = warp.warp_bindings(payload)
        kx, ky = (float(c) for c in b["k"])
        halos = [sp.ring_halos(b["halo"]) for sp in sps]
        args = ([sp.bands[0] for sp in sps], ss.bands[0], b["k"], [hs[0][0] for hs in halos],
                [hs[0][1] for hs in halos], 0, n)
        want = warp.warp_block_plain(*args)
        ptrs = [t.data_ptr() for seq in (args[3], args[0], args[4], outs) for t in seq]
        plan = warp.warp_block_plan(kx, ky, bh, n, n, b["halo"], True)

        def run(launch, fn):
            rc = fn(*ptrs, 4, args[1].data_ptr(), kx, ky, bh, n, n, 0, b["halo"], launch.mode,
                    launch.vec, launch.th, launch.tw, stream)
            if rc != 0:
                raise AssertionError(f"{launch}: CUDA error {rc}")

        def check_and_time(launch, fn=kernel):
            for o in outs:
                o.fill_(float("nan"))
            run(launch, fn)
            same = all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                       for g, r in zip(outs, want))
            return time_cuda(lambda: run(launch, fn)), same

        # (pixels per thread, adjacent with vector accesses, th, tw)
        direct = ((2, False, 2, 256), (2, True, 2, 256), (2, True, 2, 128), (2, True, 4, 128),
                  (2, True, 8, 64), (2, False, 8, 64), (2, True, 16, 32), (2, True, 4, 64),
                  (2, True, 8, 32), (1, False, 1, 256), (1, False, 4, 64), (1, False, 8, 32),
                  (4, True, 4, 256), (4, True, 8, 128), (4, False, 4, 256))
        rows = []
        for md in (plan.mode, warp.WARP_COL_GENERAL, warp.WARP_GENERAL):
            for px, vec, th, tw in direct:
                if md != plan.mode and (px, vec, th, tw) not in ((1, False, 1, 256),
                                                                (2, True, 8, 64)):
                    continue
                launch = warp.WarpBlockPlan(md, vec, th, tw)
                fn = kernel if px == 2 else variants[f"px{px}"][0]
                rows.append((*check_and_time(launch, fn), launch, px))
        print(f"warp block {bh}x{n} RGBA {payload} halo {b['halo']}, planned {plan}:",
              flush=True)
        for ms, same, launch, px in sorted(rows, key=lambda row: row[0]):
            kind = (f"{launch.th}x{launch.tw} {px} px/thread "
                    f"{'adjacent' if launch.vec else 'strided'}")
            mark = " (planned)" if launch == plan and px == 2 else ""
            print(f"  mode {launch.mode} {kind}: {ms:.4f} ms  identical {same}{mark}", flush=True)
        if not all(row[1] for row in rows):
            raise AssertionError(f"a launch changed the block warp's result at {payload}")
        # the planned launch built with a register bound for more blocks per
        # SM, and without the inner rows' shortcut
        for tag in ("blocks4", "blocks6", "blocks8", "no_inner"):
            ms, same = check_and_time(plan, variants[tag][0])
            print(f"  planned launch, variant {tag}: {ms:.4f} ms  identical {same}", flush=True)
            if not same:
                raise AssertionError(f"variant {tag} changed the block warp's result at {payload}")
    if sass:
        sass_mix(warp.WARP_BLOCK_KERNEL.path)
        sass_mix(variants["px4"][1])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=4096)
    parser.add_argument("--lattice", action="store_true",
                        help="also time the far steps with other lattice patches")
    parser.add_argument("--probe", action="store_true",
                        help="also time the blur without its loads from device memory")
    parser.add_argument("--warp", action="store_true",
                        help="sweep the warp block kernel's launches instead")
    parser.add_argument("--sass", action="store_true",
                        help="with --warp: print each kernel's instruction mix")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kanter_core_tpu_torch.ops import blur, distance

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    n = args.size
    print(f"card: {card}; torch {torch.__version__}; size {n}²", flush=True)
    if args.warp:
        warp_sweep(n, args.sass)
        return 0
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((n, n), dtype=np.float32)).cuda()
    planned = blur.blur_tile_plan
    if args.probe:
        real = blur.BLUR_KERNEL.entry()
        probe = blur_without_loads(blur)
        for sigma in (0.8, 1.2, 2.0, 4.0, 6.0):
            ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
            blur.BLUR_KERNEL._fn = probe
            try:
                probe_ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
            finally:
                blur.BLUR_KERNEL._fn = real
            print(f"blur {n}x{n} sigma={sigma}: {ms:.4f} ms, without its loads {probe_ms:.4f} ms",
                  flush=True)
    for sigma in (0.8, 1.2, 2.0, 4.0, 6.0):
        r = (len(blur.gaussian_taps(round(sigma, 6))) - 1) // 2
        plan = planned(r, n, n)
        want = blur.blur_plane_cuda(x, sigma)
        rows = []
        for th in (16, 24, 32, 48, 64, 96, 128):
            for tw in (64, 128, 192):
                smem = blur.blur_tile_smem(r, th, tw)
                if tw + 2 * (-(-r // 4) * 4) > 256 or smem > blur.BLUR_SMEM_MAX:
                    continue
                blur.blur_tile_plan = lambda radius, h, w: blur.BlurTilePlan(
                    th, tw, -(-h // th), -(-w // tw), smem, False)
                try:
                    same = torch.equal(blur.blur_plane_cuda(x, sigma), want)
                    ms = time_cuda(lambda: blur.blur_plane_cuda(x, sigma))
                finally:
                    blur.blur_tile_plan = planned
                rows.append((ms, th, tw, smem, same))
        print(f"blur {n}x{n} sigma={sigma} radius={r}, planned {plan.th}x{plan.tw}:", flush=True)
        for ms, th, tw, smem, same in sorted(rows):
            mark = " (planned)" if (th, tw) == (plan.th, plan.tw) else ""
            print(f"  {th:3d}x{tw:3d} {smem:6d} B  {ms:.4f} ms  identical {same}{mark}", flush=True)
        if not all(row[4] for row in rows):
            raise AssertionError(f"a tile changed the blur's result at sigma {sigma}")

    mask = torch.from_numpy((rng.random((n, n)) < 1e-2).astype(np.float32)).cuda()
    state = distance.pack_seeds(mask)
    plan = distance.jfa_launch_plan(n, n)
    far, (near,) = plan[:-1], plan[-1:]
    before_near = distance.jfa_run_launches(state, far)
    want = distance.jfa_run_launches(before_near, [near])
    print(f"jfa near run {near.steps} on {n}x{n}, planned {near.th}x{near.tw}:", flush=True)
    rows = []
    for th, tw in ((32, 32), (32, 64), (48, 48), (64, 64), (32, 128), (64, 96), (64, 128),
                   (96, 96), (80, 80), (128, 128), (48, 160), (40, 96)):
        launch = distance.JfaLaunch("near", near.steps, th, tw)
        same = torch.equal(distance.jfa_run_launches(before_near, [launch]), want)
        ms = time_cuda(lambda: distance.jfa_run_launches(before_near, [launch]))
        rows.append((ms, th, tw, same))
    for ms, th, tw, same in sorted(rows):
        mark = " (planned)" if (th, tw) == (near.th, near.tw) else ""
        print(f"  {th:3d}x{tw:3d}  {ms:.4f} ms  identical {same}{mark}", flush=True)
    if not all(row[3] for row in rows):
        raise AssertionError("a tile changed the near run's result")
    for launch in far:
        ms = time_cuda(lambda: distance.jfa_run_launches(state, [launch]))
        print(f"jfa far step {launch.steps[0]}: {ms:.4f} ms", flush=True)
    if args.lattice:
        real = distance.JFA_KERNEL.entry()
        ms = time_cuda(lambda: distance.jfa_run_launches(state, far))
        print(f"jfa far steps, built-in patch: {ms:.4f} ms", flush=True)
        variants = ((2, 4, 1), (2, 4, 2), (2, 4, 3), (2, 2, 1), (2, 2, 3), (2, 2, 4), (1, 4, 3),
                    (1, 8, 2), (4, 4, 1), (4, 2, 2), (2, 8, 1), (1, 2, 4))
        for rows, cols, blocks in variants:
            fn, report = lattice_variant(distance, rows, cols, blocks)
            distance.JFA_KERNEL._fn = fn
            try:
                same = torch.equal(distance.jfa_run_launches(state, far), before_near)
                ms = time_cuda(lambda: distance.jfa_run_launches(state, far))
            finally:
                distance.JFA_KERNEL._fn = real
            print(f"  patch {rows}x{cols}, {blocks} blocks/SM: {ms:.4f} ms  identical {same}  "
                  f"[{'; '.join(report[-4:])}]", flush=True)
            if not same:
                raise AssertionError("a lattice patch changed the far steps' result")
    return 0


if __name__ == "__main__":
    sys.exit(main())
