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
