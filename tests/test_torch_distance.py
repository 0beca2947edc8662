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
