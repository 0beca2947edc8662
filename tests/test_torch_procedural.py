"""The port's procedural sources and per-pixel ops against the JAX package's,
on the CPU.

Noise, Pattern (three kinds, both outputs), Voronoi (three outputs), Ramp
(three kinds), Curvature, Hsv (gray and RGBA) and AmbientOcclusion: the
same payload or seeded numpy planes go through the JAX function (jitted,
as the fused compiler runs it) and through the port's torch function; the
f32 planes must be bit-identical (int32 view) and the bindings equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kanter_core_tpu.ops import ambient_occlusion as ref_ao
from kanter_core_tpu.ops import curvature as ref_curv
from kanter_core_tpu.ops import hsv as ref_hsv
from kanter_core_tpu.ops import noise as ref_noise
from kanter_core_tpu.ops import pattern as ref_pattern
from kanter_core_tpu.ops import ramp as ref_ramp
from kanter_core_tpu.ops import voronoi as ref_voronoi
from kanter_core_tpu_torch.ops import ambient_occlusion as port_ao
from kanter_core_tpu_torch.ops import curvature as port_curv
from kanter_core_tpu_torch.ops import hsv as port_hsv
from kanter_core_tpu_torch.ops import noise as port_noise
from kanter_core_tpu_torch.ops import pattern as port_pattern
from kanter_core_tpu_torch.ops import ramp as port_ramp
from kanter_core_tpu_torch.ops import voronoi as port_voronoi

torch.set_num_threads(1)

SHAPES = [(64, 64), (97, 411)]  # (height, width)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_bits_equal(got, want):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


def _assert_same_bindings(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and np.array_equal(g, w), key


def _index(b):
    return torch.from_numpy(b["rows"]), torch.from_numpy(b["cols"])


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("cells,octaves,seed,persistence", [
    (4, 3, 9, 0.5), (3, 4, 0xFFFFFFF0, 0.8), (7, 1, 123456789, 0.0),
])
def test_noise_matches_reference(h, w, cells, octaves, seed, persistence):
    payload = (w, h, cells, octaves, seed, persistence)
    b = port_noise.noise_bindings(payload)
    rb = ref_noise.noise_bindings(payload)
    _assert_same_bindings(b, rb)
    want = jax.jit(ref_noise.noise_plane)(
        rb["rows"], rb["cols"], rb["seed"], rb["persistence"], rb["fx"], rb["fy"], rb["periods"]
    )
    got = port_noise.noise_plane(
        *_index(b), b["seed"], b["persistence"], b["fx"], b["fy"], b["periods"]
    )
    _assert_bits_equal(got, want)


def test_noise_hash_matches_reference_on_extreme_words():
    """The int64 hash keeps the u32 wrap-around bits of the JAX hash for
    coordinates and seeds near 2^32."""
    xs = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B1], np.uint32)
    for seed in (0, 1, 0xFFFFFFFF, 0x68E31DA4):
        want = ref_noise._hash01(jnp, jnp.asarray(xs)[None, :], jnp.asarray(xs)[:, None],
                                 jnp.uint32(seed))
        x64 = torch.from_numpy(xs.astype(np.int64))
        got = port_noise._hash01(x64[None, :], x64[:, None], seed)
        _assert_bits_equal(got, want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("kind", ["Checker", "Brick", "Stripe"])
@pytest.mark.parametrize("bevel", [0.06, 0.0])
def test_pattern_matches_reference(h, w, kind, bevel):
    payload = (w, h, kind, 4, 8, 0.12, bevel, 3)
    b = port_pattern.pattern_bindings(payload)
    rb = ref_pattern.pattern_bindings(payload)
    _assert_same_bindings(b, rb)
    want = jax.jit(functools.partial(ref_pattern.pattern_planes, kind))(
        rb["rows"], rb["cols"], rb["fx"], rb["fy"], rb["px"], rb["py"],
        rb["mortar"], rb["bevel"], rb["seed"],
    )
    got = port_pattern.pattern_planes(
        kind, *_index(b), b["fx"], b["fy"], b["px"], b["py"], b["mortar"], b["bevel"], b["seed"],
    )
    for g, r in zip(got, want):
        _assert_bits_equal(g, r)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("cells,jitter,seed", [(6, 0.85, 5), (3, 1.0, 0), (9, 0.0, 77)])
def test_voronoi_matches_reference(h, w, cells, jitter, seed):
    payload = (w, h, cells, cells + 1, jitter, seed)
    b = port_voronoi.voronoi_bindings(payload)
    rb = ref_voronoi.voronoi_bindings(payload)
    _assert_same_bindings(b, rb)
    want = jax.jit(ref_voronoi.voronoi_planes)(
        rb["rows"], rb["cols"], rb["fx"], rb["fy"], rb["px"], rb["py"], rb["jitter"], rb["seed"],
    )
    got = port_voronoi.voronoi_planes(
        *_index(b), b["fx"], b["fy"], b["px"], b["py"], b["jitter"], b["seed"],
    )
    assert len(got) == 3
    for g, r in zip(got, want):
        _assert_bits_equal(g, r)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("kind", ["Linear", "Radial", "Box"])
@pytest.mark.parametrize("angle", [0.0, 37.0, 270.0])
def test_ramp_matches_reference(h, w, kind, angle):
    payload = (w, h, kind, angle, 0.5, 0.4, 0.9)
    b = port_ramp.ramp_bindings(payload)
    rb = ref_ramp.ramp_bindings(payload)
    _assert_same_bindings(b, rb)
    want = jax.jit(functools.partial(ref_ramp.ramp_plane, kind))(
        rb["rows"], rb["cols"], rb["iw"], rb["ih"], rb["k"]
    )
    got = port_ramp.ramp_plane(kind, *_index(b), b["iw"], b["ih"], b["k"])
    _assert_bits_equal(got, want)


def _plane(h, w, seed, lo=0.0, hi=1.0):
    return (np.random.default_rng(seed).random((h, w), dtype=np.float32) * np.float32(hi - lo)
            + np.float32(lo))


@pytest.mark.parametrize("h,w", SHAPES + [(1, 1), (1, 7)])
@pytest.mark.parametrize("strength", [5.0, 0.5])
def test_curvature_matches_reference(h, w, strength):
    p = _plane(h, w, h + w)
    want = jax.jit(lambda s, x: ref_curv.curvature_plane(x, s))(np.float32(strength), p)
    got = port_curv.curvature_plane(torch.from_numpy(p), np.float32(strength))
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("strength,radius", [(2.0, 1.0), (0.7, 0.6)])
def test_ambient_occlusion_matches_reference(h, w, strength, radius):
    p = _plane(h, w, h * w)
    want = jax.jit(lambda s, x: ref_ao.ao_plane(x, s, radius))(np.float32(strength), p)
    got = port_ao.ao_plane(torch.from_numpy(p), np.float32(strength), radius)
    _assert_bits_equal(got, want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("n_planes", [1, 4])
@pytest.mark.parametrize("payload", [(25.0, 1.1, 0.95), (-400.0, 0.3, 1.7), (180.0, 2.0, 0.5)])
def test_hsv_matches_reference(h, w, n_planes, payload):
    planes = [_plane(h, w, 10 * i + h, -0.1, 1.2) for i in range(n_planes)]
    # grays and ties exercise the delta == 0 and max-channel tie branches
    if n_planes == 4:
        planes[1][:3] = planes[0][:3]
        planes[2][:2] = planes[0][:2]
    params = port_hsv.hsv_bindings(payload)
    rparams = ref_hsv.hsv_bindings(payload)
    assert np.array_equal(params, rparams) and params.dtype == rparams.dtype
    want = jax.jit(lambda prm, *ps: tuple(ref_hsv.hsv_planes(list(ps), prm)))(rparams, *planes)
    tplanes = [torch.from_numpy(p) for p in planes]
    got = port_hsv.hsv_planes(tplanes, params)
    assert len(got) == n_planes
    for g, r in zip(got, want):
        _assert_bits_equal(g, r)
    if n_planes == 4:
        assert got[3] is tplanes[3]  # alpha passes through by alias
