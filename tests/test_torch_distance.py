"""The port's Distance (JFA) against the JAX package's, on the CPU.

On a CPU tensor the port's `distance_plane` runs the plain torch ladder
(`jfa_propagate_plain`); it must be bit-identical (int32 view) to the JAX
package's `distance_plane` through its CPU default (the jnp roll ladder)
and, at kernel-viable shapes, through its Pallas step kernel in interpret
mode (as `tests/test_pallas_distance.py` runs it). The CUDA kernel itself
is compared with the plain ladder on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanter_core_tpu.ops import distance as ref_distance
from kanter_core_tpu.ops import pallas_distance
from kanter_core_tpu_torch.errors import TexProError
from kanter_core_tpu_torch.ops import distance as port_distance

torch.set_num_threads(1)


def _mask(h, w, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        return (rng.random((h, w)) < 0.01).astype(np.float32)
    if kind == "dense":
        return (rng.random((h, w)) < 0.2).astype(np.float32)
    if kind == "seedless":
        return np.zeros((h, w), np.float32)
    if kind == "all":
        return np.ones((h, w), np.float32)
    if kind == "ties":  # seeds on every other pixel: every pixel has tied seeds
        m = np.zeros((h, w), np.float32)
        m[::2, ::2] = 1.0
        m[1::2, 1::2] = 1.0
        return m
    raise ValueError(kind)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _reference(mask, max_dist, interpret=False):
    md = np.float32(max_dist)
    pallas_distance.FORCE_PALLAS_INTERPRET = interpret
    try:
        if interpret:
            assert pallas_distance.fits_kernel(*mask.shape)
        return np.asarray(
            jax.jit(lambda m, d: ref_distance.distance_plane(m, d, pallas_ok=True))(mask, md)
        )
    finally:
        pallas_distance.FORCE_PALLAS_INTERPRET = False


@pytest.mark.parametrize("h,w", [(64, 64), (5, 37), (33, 65), (1, 1), (128, 128)])
@pytest.mark.parametrize("kind", ["sparse", "dense", "seedless", "all", "ties"])
def test_distance_matches_jnp_ladder(h, w, kind):
    mask = _mask(h, w, kind, seed=h * w)
    # the mask carries non-binary values too: only > 0.5 seeds
    mask = mask * np.float32(0.75)
    want = _reference(mask, 23.0)
    got = port_distance.distance_plane(torch.from_numpy(mask), np.float32(23.0))
    assert int((_bits(got) != _bits(want)).sum()) == 0


@pytest.mark.parametrize("kind", ["sparse", "dense", "ties", "all", "seedless"])
def test_distance_matches_pallas_interpret(kind):
    mask = _mask(128, 128, kind, seed=3)
    want = _reference(mask, 16.0, interpret=True)
    got = port_distance.distance_plane(torch.from_numpy(mask), np.float32(16.0))
    assert int((_bits(got) != _bits(want)).sum()) == 0


@pytest.mark.parametrize("h,w", [(40, 256)])
def test_step_matches_pallas_step_kernel(h, w):
    """The packed state itself, step by step: `jfa_step_plain` against the
    Pallas step kernel (`_jfa_step_call`, interpret mode), including the
    `k > H` steps of a short canvas; the ladder against
    `jfa_propagate_pallas`."""
    mask = _mask(h, w, "sparse", seed=9)
    steps = port_distance._jfa_steps(h, w)
    assert steps == ref_distance._jfa_steps(h, w)
    assert pallas_distance.fits_kernel(h, w)
    state = port_distance.pack_seeds(torch.from_numpy(mask))
    ref_state = jnp.asarray(state.numpy())
    for k in steps:
        ref_state = pallas_distance._jfa_step_call(h, w, k, True)(ref_state)
        state = port_distance.jfa_step_plain(state, k)
        assert np.array_equal(state.numpy(), np.asarray(ref_state)), k
    start = port_distance.pack_seeds(torch.from_numpy(mask))
    ladder = pallas_distance.jfa_propagate_pallas(jnp.asarray(start.numpy()), steps, True)
    assert np.array_equal(port_distance.jfa_propagate_plain(start).numpy(), np.asarray(ladder))


@pytest.mark.parametrize("max_dist", [0.0, 1e-9, 3.5, 1e6, float("inf")])
def test_distance_fade_edge_spreads(max_dist):
    mask = _mask(33, 65, "sparse", seed=1)
    want = _reference(mask, max_dist)
    got = port_distance.distance_plane(torch.from_numpy(mask), np.float32(max_dist))
    assert int((_bits(got) != _bits(want)).sum()) == 0


def test_distance_packing_bound_raises():
    with pytest.raises(TexProError, match="packed-JFA bound"):
        port_distance.distance_plane(torch.zeros(32768, 1), np.float32(4.0))
    with pytest.raises(TexProError, match="packed-JFA bound"):
        port_distance.distance_plane(torch.zeros(1, 65536), np.float32(4.0))


def test_cpu_ladder_launches_no_kernel_and_cuda_entry_refuses_cpu():
    before = port_distance.JFA_KERNEL.launches
    port_distance.distance_plane(torch.zeros(8, 8), np.float32(4.0))
    assert port_distance.JFA_KERNEL.launches == before
    with pytest.raises(TexProError):
        port_distance.jfa_propagate_cuda(torch.zeros(8, 8, dtype=torch.int32))
    assert port_distance.JFA_KERNEL.launches == before


PLAN_SHAPES = [(4096, 4096), (97, 411), (5, 4096), (4096, 1), (1, 1), (33, 2049)]


@pytest.mark.parametrize("h,w", PLAN_SHAPES)
def test_launch_plan_covers_every_step_once_and_in_order(h, w):
    """`jfa_launch_plan`: the launches' steps, concatenated, are the ladder;
    exactly one near launch, the last, summing to at most the fused halo and
    within a block's shared memory; every step before it a launch of its own."""
    plan = port_distance.jfa_launch_plan(h, w)
    steps = port_distance._jfa_steps(h, w)
    assert [k for launch in plan for k in launch.steps] == steps
    *far, near = plan
    assert near.entry == "near" and all(launch.entry == "step" for launch in far)
    assert all(len(launch.steps) == 1 for launch in far)
    halo = sum(near.steps)
    assert 1 <= halo <= port_distance.JFA_NEAR_HALO and len(near.steps) <= 8
    assert not far or halo + far[-1].steps[0] > port_distance.JFA_NEAR_HALO
    assert 1 <= near.th <= max(h, 1) and 2 <= near.tw
    rh, rw = near.th + 2 * halo, near.tw + 2 * halo
    assert (2 * rh * rw + rh + rw) * 4 <= 232448
    if (h, w) == (4096, 4096):
        assert len(plan) == 9 and near.steps == (8, 4, 2, 1, 1) and (near.th, near.tw) == (64, 64)
        assert all(port_distance.jfa_step_form(launch.steps[0], h, w) == "lattice"
                   for launch in far)


def test_step_form_by_shape():
    form = port_distance.jfa_step_form
    assert form(2048, 4096, 4096) == "lattice" and form(16, 4096, 4096) == "lattice"
    assert form(32, 96, 160) == "lattice"      # lattices of 3 and 5 points
    assert form(128, 96, 160) == "pixel"       # 128 mod 160 does not divide 160
    assert form(64, 97, 411) == "pixel" and form(16, 33, 2049) == "pixel"
    assert form(2048, 5, 4096) == "pixel"      # 2048 mod 5 = 3 does not divide 5
    assert form(16, 5, 4096) == "lattice"      # 16 mod 5 = 1: a lattice of stride 1
    assert form(32, 4096, 1) == "pixel"        # the step is a multiple of the width


def _fold(best, best_d2, cand, rows, cols, h, w):
    d2 = port_distance.d2_of(cand, rows, cols, h, w)
    better = d2 < best_d2
    return torch.where(better, cand, best), torch.where(better, d2, best_d2)


def _lattice_step(state: torch.Tensor, k: int) -> torch.Tensor:
    """One far step as the lattice kernel owns it, index maps only: pixel
    (y, x) is point (y // ky, x // kx) of the lattice of its residues, and
    its candidates are the values of that lattice's neighbouring points, the
    one below and to the right first."""
    h, w = state.shape
    ky, kx = k % h, k % w
    assert port_distance.jfa_step_form(k, h, w) == "lattice"
    ly, lx = h // ky, w // kx
    ys, xs = torch.arange(h), torch.arange(w)
    rows, cols = ys.to(torch.int32)[:, None], xs.to(torch.int32)[None, :]
    best, best_d2 = state, port_distance.d2_of(state, rows, cols, h, w)
    for di in (1, 0, -1):
        for dj in (1, 0, -1):
            if di == 0 and dj == 0:
                continue
            src_y = ((ys // ky + di) % ly) * ky + ys % ky
            src_x = ((xs // kx + dj) % lx) * kx + xs % kx
            best, best_d2 = _fold(best, best_d2, state[src_y][:, src_x], rows, cols, h, w)
    return best


def _near_run(state: torch.Tensor, steps, th: int, tw: int) -> torch.Tensor:
    """The fused near steps as the near kernel runs them, index maps only:
    per tile the region of the tile plus a halo of the steps' sum, gathered
    with wrapped coordinates; every step folds the region's cells a further
    k inside its rim from the cells at ±k, with distances taken from the
    cells' coordinates on the plane; the tile is what is left at the end."""
    h, w = state.shape
    halo = sum(steps)
    out = torch.full_like(state, -7)
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            gy = torch.arange(y0 - halo, y0 + th + halo) % h
            gx = torch.arange(x0 - halo, x0 + tw + halo) % w
            region = state[gy][:, gx]
            rows, cols = gy.to(torch.int32)[:, None], gx.to(torch.int32)[None, :]
            rh, rw = region.shape
            margin = 0
            for k in steps:
                margin += k
                inner = (slice(margin, rh - margin), slice(margin, rw - margin))
                r_in, c_in = rows[margin:rh - margin], cols[:, margin:rw - margin]
                best = region[inner]
                best_d2 = port_distance.d2_of(best, r_in, c_in, h, w)
                for di in (k, 0, -k):
                    for dj in (k, 0, -k):
                        if di == 0 and dj == 0:
                            continue
                        cand = region[margin + di:rh - margin + di, margin + dj:rw - margin + dj]
                        best, best_d2 = _fold(best, best_d2, cand, r_in, c_in, h, w)
                region = region.clone()
                region[inner] = best
            tile = region[halo:halo + th, halo:halo + tw]
            out[y0:y0 + th, x0:x0 + tw] = tile[:h - y0, :w - x0]
    return out


@pytest.mark.parametrize("h,w", [(64, 64), (97, 41), (33, 129)])
@pytest.mark.parametrize("kind", ["sparse", "ties"])
def test_planned_ladder_emulated_equals_plain(h, w, kind):
    """The ladder as the plan lays it out (far steps by lattice ownership
    where the kernel would take that form, the fused near run on a shrinking
    halo) equals `jfa_propagate_plain` bit for bit."""
    state = port_distance.pack_seeds(torch.from_numpy(_mask(h, w, kind, seed=h + w)))
    got = state
    for launch in port_distance.jfa_launch_plan(h, w):
        if launch.entry == "near":
            got = _near_run(got, launch.steps, launch.th, launch.tw)
        elif port_distance.jfa_step_form(launch.steps[0], h, w) == "lattice":
            got = _lattice_step(got, launch.steps[0])
        else:
            got = port_distance.jfa_step_plain(got, launch.steps[0])
    assert torch.equal(got, port_distance.jfa_propagate_plain(state))


@pytest.mark.parametrize("h,w,k", [(64, 64, 32), (64, 64, 16), (96, 160, 32), (96, 160, 16),
                                   (5, 64, 16), (48, 36, 12)])
def test_lattice_ownership_equals_roll_step(h, w, k):
    state = port_distance.pack_seeds(torch.from_numpy(_mask(h, w, "dense", seed=k)))
    assert torch.equal(_lattice_step(state, k), port_distance.jfa_step_plain(state, k))


@pytest.mark.parametrize("h,w,th,tw", [(64, 64, 16, 16), (97, 41, 32, 8), (33, 129, 33, 64),
                                       (10, 12, 10, 12), (1, 1, 1, 2), (5, 300, 5, 64)])
def test_fused_near_steps_equal_separate_steps(h, w, th, tw):
    """Tiles smaller than the plane, a plane smaller than the halo (the
    region wraps around it several times), and a 1×1 plane."""
    state = port_distance.pack_seeds(torch.from_numpy(_mask(h, w, "dense", seed=th)))
    steps = port_distance.jfa_launch_plan(h, w)[-1].steps
    want = state
    for k in steps:
        want = port_distance.jfa_step_plain(want, k)
    assert torch.equal(_near_run(state, steps, th, tw), want)


def _d2_f32(py, px, cy, cx, h, w):
    """The f32 metric of `csrc/jfa.cu` (`MetricF32`) in torch: coordinates
    biased by 2^23 as the byte permute builds them, the wrap as
    n/2 − ||d| − n/2|, the squares summed, every operation in f32."""
    f = torch.float32
    bias = 8388608.0
    half_h, half_w = torch.tensor(0.5 * h, dtype=f), torch.tensor(0.5 * w, dtype=f)
    dy = ((py.to(f) + bias) - (cy.to(f) + bias)).abs() - half_h
    dx = ((px.to(f) + bias) - (cx.to(f) + bias)).abs() - half_w
    by, bx = half_h - dy.abs(), half_w - dx.abs()
    return bx * bx + by * by


@pytest.mark.parametrize("h,w", [(4096, 4096), (5792, 5792), (1, 8190), (97, 411), (8190, 2)])
def test_f32_metric_is_exact_where_the_kernel_uses_it(h, w):
    """Where (H/2)² + (W/2)² ≤ 2²⁴ the kernels take d² in f32: it must equal
    the i32 d² for every pixel and seed, and the sentinel as the kernels hold
    it (0xFFFFFFFF, coordinates 65535) must lie beyond every real d²."""
    assert (h // 2) ** 2 + (w // 2) ** 2 <= 2 ** 24
    rng = np.random.default_rng(h + w)
    n = 200_000
    py = torch.from_numpy(rng.integers(0, h, n)).to(torch.int32)
    px = torch.from_numpy(rng.integers(0, w, n)).to(torch.int32)
    cy = torch.from_numpy(rng.integers(0, h, n)).to(torch.int32)
    cx = torch.from_numpy(rng.integers(0, w, n)).to(torch.int32)
    # the extremes: opposite corners, half the plane apart, the same pixel
    for a, b in ((0, h - 1), (0, h // 2), (h - 1, h - 1 - h // 2), (0, 0)):
        py[:4], cy[:4] = a, b
        for c, d in ((0, w - 1), (0, w // 2), (w - 1, w - 1 - w // 2), (0, 0)):
            px[:4], cx[:4] = c, d
            want = port_distance.d2_of((cy << 16) | cx, py, px, h, w)
            got = _d2_f32(py, px, cy, cx, h, w)
            assert torch.equal(got, want.to(torch.float32))
            assert torch.equal(got.to(torch.int32), want)
    far = _d2_f32(py, px, torch.full_like(cy, 65535), torch.full_like(cx, 65535), h, w)
    assert float(far.min()) > (h // 2) ** 2 + (w // 2) ** 2


def test_near_entry_counts_apart_and_cpu_launches_neither():
    before = (port_distance.JFA_KERNEL.launches, port_distance.JFA_NEAR_KERNEL.launches)
    port_distance.distance_plane(torch.zeros(8, 8), np.float32(4.0))
    with pytest.raises(TexProError):
        port_distance.jfa_run_launches(
            torch.zeros(8, 8, dtype=torch.int32), port_distance.jfa_launch_plan(8, 8)
        )
    assert (port_distance.JFA_KERNEL.launches,
            port_distance.JFA_NEAR_KERNEL.launches) == before
