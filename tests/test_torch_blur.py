"""The port's blur (`kanter_core_tpu_torch.ops.blur`) against the JAX package.

On the CPU the port's `blur_plane` takes its plain torch version; it must be
bit-identical (int32 view of the f32 planes) to the JAX package's jnp form
(`ops.blur.blur_plane`) and to its Pallas kernel in interpret mode
(`pallas_blur.blur_pallas`, as `tests/test_pallas_blur.py` runs it). The CUDA
kernel itself is compared with the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanter_core_tpu.ops import blur as ref_blur
from kanter_core_tpu.ops.pallas_blur import blur_pallas
from kanter_core_tpu_torch.errors import TexProError
from kanter_core_tpu_torch.ops import blur as port_blur

torch.set_num_threads(1)


def _plane(h, w, seed):
    return np.random.default_rng(seed).random((h, w), dtype=np.float32)


def _bits_equal(a, b) -> bool:
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("sigma", [0.8, 1.5, 6.0])
@pytest.mark.parametrize("h,w", [(128, 128), (64, 256)])
def test_plain_blur_matches_jnp_and_pallas(h, w, sigma):
    p = _plane(h, w, seed=h * 7 + w + int(sigma * 10))
    got = port_blur.blur_plane(torch.from_numpy(p), sigma).numpy()
    want_jnp = ref_blur.blur_plane(jnp.asarray(p), sigma)
    taps = ref_blur.gaussian_taps(round(float(sigma), 6))
    want_pallas = blur_pallas(jnp.asarray(p), taps, chunk_rows=16, interpret=True)
    assert _bits_equal(got, want_jnp)
    assert _bits_equal(got, want_pallas)


@pytest.mark.parametrize("sigma", [0.8, 6.0])
@pytest.mark.parametrize("h,w", [(1, 1), (5, 37), (97, 411)])
def test_plain_blur_matches_jnp_edge_shapes(h, w, sigma):
    """1×1 (identity rolls), radius above the height (37 taps on 5 rows),
    and an odd, unaligned canvas."""
    p = _plane(h, w, seed=h + w)
    got = port_blur.blur_plane(torch.from_numpy(p), sigma).numpy()
    assert _bits_equal(got, ref_blur.blur_plane(jnp.asarray(p), sigma))


def test_gaussian_taps_match_reference():
    for sigma in (0.8, 1.5, 4.0, 6.0, 100.0):
        assert _bits_equal(port_blur.gaussian_taps(sigma), ref_blur.gaussian_taps(sigma))


def test_cpu_tensor_takes_plain_path_and_never_launches():
    before = port_blur.BLUR_KERNEL.launches
    p = torch.from_numpy(_plane(16, 16, seed=3))
    port_blur.blur_plane(p, 1.5)
    assert port_blur.BLUR_KERNEL.launches == before == 0


def test_kernel_wrapper_refuses_cpu_tensor():
    """No fallback: the kernel wrapper raises on anything but a contiguous
    2-D f32 CUDA tensor, before building anything."""
    with pytest.raises(TexProError):
        port_blur.blur_plane_cuda(torch.zeros(8, 8), 1.0)
    assert port_blur.BLUR_KERNEL.launches == 0


PLAN_SHAPES = [(4096, 4096), (97, 411), (5, 4096), (4096, 1), (1, 1)]


@pytest.mark.parametrize("radius", range(1, 32))
def test_tile_plan_fits_shared_memory_and_covers_the_plane(radius):
    """The host-side tile of `csrc/blur.cu` for every tiled radius: a tile
    the kernel takes (multiples of 8, at least 16 columns, a staged window of
    at most 256 columns), within one block's shared memory, covering the
    plane; and the rule that sends a small plane to the remainder wrap."""
    for h, w in PLAN_SHAPES:
        plan = port_blur.blur_tile_plan(radius, h, w)
        assert plan.th % 8 == 0 and plan.tw % 8 == 0 and plan.th >= 8 and plan.tw >= 16
        margin = -(-radius // 4) * 4  # the radius rounded up to 4 columns
        staged = plan.tw + 2 * margin
        assert staged <= 256
        assert plan.smem_bytes == (2 * plan.th + 2 * radius + 1) * (staged + 4) * 4
        assert plan.smem_bytes == port_blur.blur_tile_smem(radius, plan.th, plan.tw)
        assert plan.smem_bytes <= port_blur.BLUR_SMEM_MAX == 232448
        assert plan.tiles_y * plan.th >= h > (plan.tiles_y - 1) * plan.th
        assert plan.tiles_x * plan.tw >= w > (plan.tiles_x - 1) * plan.tw
        # a conditional add or subtract wraps an index once, which serves
        # every tile's window only if tile + margin fits into the plane
        assert plan.general == (plan.th + radius > h or plan.tw + margin > w)


def test_tile_plan_main_path_keeps_two_blocks_per_sm():
    """At the radii the PBR and flagship graphs launch on a 4096² plane (and
    on a 1024-row block of it) two blocks fit in an SM's 233,472 bytes beside
    the 1 KiB each block reserves, and no tile wraps with a remainder."""
    for sigma in (0.8, 1.0, 1.2, 2.0, 4.0, 6.0):
        radius = (len(port_blur.gaussian_taps(sigma)) - 1) // 2
        for h in (4096, 1024):
            plan = port_blur.blur_tile_plan(radius, h, 4096)
            assert 2 * (plan.smem_bytes + 1024) <= 233472 and not plan.general
            assert (plan.th, plan.tw) == (64, 128)


def test_tile_plan_refuses_what_the_tiled_kernel_does_not_take():
    with pytest.raises(ValueError):
        port_blur.blur_tile_plan(32, 64, 64)
    with pytest.raises(ValueError):
        port_blur.blur_tile_plan(3, 0, 64)


def _blur_by_tiles(plane: torch.Tensor, sigma: float, th: int, tw: int) -> torch.Tensor:
    """The kernel's data flow in plain torch, index maps only: per tile the
    wrapped window gathered as the kernel stages it (rows from y0 - r,
    columns from x0 - ra), the vertical pass on the window, the horizontal
    pass on its result, the tile's pixels stored."""
    taps = port_blur.gaussian_taps(round(float(sigma), 6))
    r = (len(taps) - 1) // 2
    ra = -(-r // 4) * 4
    h, w = plane.shape
    out = torch.full_like(plane, float("nan"))
    for y0 in range(0, h, th):
        for x0 in range(0, w, tw):
            rows = (torch.arange(y0 - r, y0 + th + r) % h)
            cols = (torch.arange(x0 - ra, x0 + tw + ra) % w)
            window = plane[rows][:, cols]
            mid = torch.zeros(th, tw + 2 * r)
            for t, wt in enumerate(taps):
                mid = mid + window[t:t + th, ra - r:ra - r + tw + 2 * r] * float(wt)
            acc = torch.zeros(th, tw)
            for t, wt in enumerate(taps):
                acc = acc + mid[:, t:t + tw] * float(wt)
            out[y0:y0 + th, x0:x0 + tw] = acc[:h - y0, :w - x0]
    return out


@pytest.mark.parametrize("h,w,sigma,th,tw", [
    (97, 41, 0.8, 8, 16), (97, 41, 6.0, 16, 16), (5, 130, 6.0, 8, 128), (64, 128, 1.2, 64, 128),
    (1, 1, 1.2, 8, 16),
])
def test_tiled_data_flow_equals_plain(h, w, sigma, th, tw):
    """Tiling changes which window holds a value, never the sequence of
    products and sums of an output: the emulated tiles equal the plain blur
    bit for bit, also where a window wraps around the plane more than once."""
    p = torch.from_numpy(_plane(h, w, seed=h * w))
    got = _blur_by_tiles(p, sigma, th, tw)
    assert _bits_equal(got.numpy(), port_blur.blur_plane_plain(p, sigma).numpy())
