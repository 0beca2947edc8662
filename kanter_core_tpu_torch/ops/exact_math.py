"""The f32 pow of the reference's two backends.

Port of `ds_pow` and `_ds_pow_core` of `kanter_core_tpu/ops/exact_math.py`.
The reference's CPU pow is glibc `powf`; off the CPU the JAX package
computes pow as `ds_pow`, a double-single `exp2(b·log2(a))` with glibc's
special cases, correctly rounded where glibc (max error ~0.82 ulp) is not.
The two differ only where glibc misrounds (DESIGN.md §7), which the
reference allows as the pow class. The port takes the same split, by the
device of the tensor and nothing else:

- `powf_glibc` for a CPU tensor: glibc's own `powf`, element by element,
  from a small C loop (`csrc/host.c`, built on first use with the host's C
  compiler) that calls the function pointer of `libm.so.6`'s `powf`. Neither `torch.pow` nor `np.power` is glibc's rounding;
- `ds_pow` for a CUDA tensor: the double-single construction in plain
  torch, each op a separate kernel that rounds on its own (no `addcmul`,
  `lerp` or `add(alpha=)`), so the card and the CPU give the same bits.

`pow_f32` routes between the two. The JAX package's `corrected_div` is
not ported: tensor-by-tensor division in torch is IEEE on both devices,
and `ds_pow` divides through its own double-single `ds_div`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..build import host_library
from ..errors import ErrorKind, TexProError


def _const_ds(value) -> tuple:
    """Split a float64 constant into an exact (hi, lo) f32 pair."""
    v = np.float64(value)
    hi = np.float32(v)
    lo = np.float32(v - np.float64(hi))
    return float(hi), float(lo)


_LN2 = _const_ds("0.693147180559945309417232121458")
_INV_LN2 = _const_ds("1.442695040888963407359924681002")
_ATANH_COEF = [_const_ds(1.0 / k) for k in range(3, 25, 2)]
_EXP_COEF = [_const_ds(1.0 / math.factorial(k)) for k in range(2, 15)]


def _two_sum(x, y):
    s = x + y
    yy = s - x
    return s, (x - (s - yy)) + (y - yy)


def _quick_two_sum(x, y):  # requires |x| >= |y|
    s = x + y
    return s, y - (s - x)


def _split(x):
    t = 4097.0 * x  # 2^12 + 1: Veltkamp constant for f32
    hi = t - (t - x)
    return hi, x - hi


def _two_prod(x, y):
    p = x * y
    xh, xl = _split(x)
    yh, yl = _split(y)
    return p, ((xh * yh - p) + xh * yl + xl * yh) + xl * yl


def _ds_add(x, y):
    s, e = _two_sum(x[0], y[0])
    return _quick_two_sum(s, e + (x[1] + y[1]))


def _ds_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    return _quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def _ds_div(x, y):
    q0 = x[0] / y[0]
    p = _ds_mul((q0, torch.zeros_like(q0)), y)
    r = _ds_add(x, (-p[0], -p[1]))
    return _quick_two_sum(q0, (r[0] + r[1]) / y[0])


def _ds_const(c, like):
    return (torch.full_like(like, c[0]), torch.full_like(like, c[1]))


def _exp2i(n: torch.Tensor) -> torch.Tensor:
    """2**n as f32 from its bits, exactly, for int32 `n` in [-149, 127]
    (denormal powers included); 0 below, +inf above."""
    normal = ((torch.clamp(n, -126, 128) + 127) << 23).view(torch.float32)
    denormal = (torch.ones_like(n) << torch.clamp(n + 149, 0, 22)).view(torch.float32)
    out = torch.where(n >= -126, normal, denormal)
    return torch.where(n < -149, torch.zeros_like(out), out)


def _ldexp(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """`x · 2**n` rounded once, as `jnp.ldexp` gives it, for the `x` of the
    pow core (|x| < 2): `n` splits as `a + b` with `b` in [-149, 127], so
    `x · 2**a` is exact and the product with `2**b` the one rounding.
    (`torch.ldexp` multiplies by `pow(2, n)`, whose range ends at 2**127.)
    A zero `x` stays zero whatever `n` (no 0 · inf)."""
    b = torch.clamp(n, -149, 127)
    return torch.where(x == 0, x, (x * _exp2i(n - b)) * _exp2i(b))


def _ds_pow_core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp2(b · log2(a)) in double-single, for a > 0 finite, b finite."""
    one = (torch.ones_like(a), torch.zeros_like(a))

    # log2(a): a = m·2^e with m ∈ [√0.5, √2) so |r| ≤ 0.1716
    m, e = torch.frexp(a)
    lo_m = m < 0.70710678
    m = torch.where(lo_m, m * 2.0, m)
    e = torch.where(lo_m, e - 1, e).to(torch.float32)

    num = (m - 1.0, torch.zeros_like(m))  # exact by Sterbenz
    den = _two_sum(m, torch.ones_like(m))
    r = _ds_div(num, den)
    r2 = _ds_mul(r, r)

    # ln(m) = 2·atanh(r): Horner over r² with DS coefficients 1/3, 1/5, …
    acc = _ds_const(_ATANH_COEF[-1], a)
    for coef in reversed(_ATANH_COEF[:-1]):
        acc = _ds_add(_ds_mul(acc, r2), _ds_const(coef, a))
    acc = _ds_add(_ds_mul(acc, r2), one)
    ln_m = _ds_mul(r, acc)
    ln_m = (ln_m[0] * 2.0, ln_m[1] * 2.0)  # exact ×2

    log2_a = _ds_add(_ds_mul(ln_m, _ds_const(_INV_LN2, a)), (e, torch.zeros_like(e)))

    # exp2(t), t = b·log2(a): t = n + f with |f| ≤ 0.5, exp(f·ln2) by series
    t = _ds_mul(log2_a, (b, torch.zeros_like(b)))
    n = torch.round(t[0])
    f = _ds_add(t, (-n, torch.zeros_like(n)))
    u = _ds_mul(f, _ds_const(_LN2, a))

    acc = _ds_const(_EXP_COEF[-1], a)
    for coef in reversed(_EXP_COEF[:-1]):
        acc = _ds_add(_ds_mul(acc, u), _ds_const(coef, a))
    acc = _ds_add(_ds_mul(acc, u), one)   # 1 + u·(1/2! + u·(1/3! + …))
    expu = _ds_add(_ds_mul(acc, u), one)  # 1 + u + u²/2! + …

    # the int cast of a NaN or huge t: clamped first (every |n| past 300
    # gives the same 0 or inf), NaN to 0 (torch's CPU cast gives INT_MIN)
    n_i = torch.where(torch.isnan(n), 0.0, torch.clamp(n, -300.0, 300.0)).to(torch.int32)
    return _ldexp(expu[0], n_i) + _ldexp(expu[1], n_i)


def ds_pow(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 pow with glibc powf special-case semantics and a correctly-rounded
    normal path (`_ds_pow_core`). Handles: b=0 → 1 (any a, incl. NaN), a=1 →
    1 (any b), negative a with integer b (sign by parity, NaN otherwise),
    ±0 and ±inf bases, NaN propagation. Same bits on every device."""
    a, b = torch.broadcast_tensors(a, b)
    nan, inf = float("nan"), float("inf")

    normal = (a > 0) & torch.isfinite(a) & torch.isfinite(b)
    abs_a = torch.abs(a)
    safe_a = torch.where(abs_a > 0, abs_a, 1.0)
    core = _ds_pow_core(safe_a, b)

    b_int = torch.floor(b) == b
    b_odd = b_int & (torch.floor(b * 0.5) * 2.0 != torch.floor(b))
    neg_pow = torch.where(b_int, torch.where(b_odd, -core, core), nan)

    out = torch.where(normal, core, nan)
    out = torch.where((a < 0) & torch.isfinite(a) & torch.isfinite(b), neg_pow, out)
    # b = ±inf: |a| < 1 → {0, inf}, |a| > 1 → {inf, 0}, |a| = 1 → 1
    mag = torch.abs(a)
    out = torch.where(
        b == inf, torch.where(mag == 1, 1.0, torch.where(mag > 1, inf, 0.0)), out
    )
    out = torch.where(
        b == -inf, torch.where(mag == 1, 1.0, torch.where(mag > 1, 0.0, inf)), out
    )
    # pow(±0, y): ±inf for y < 0, ±0 for y > 0 — the sign transfers only
    # for odd-integer y (IEEE 754 pow)
    zero_sign = torch.where(b_odd & torch.signbit(a), -1.0, 1.0)
    out = torch.where(a == 0, zero_sign * torch.where(b < 0, inf, 0.0), out)
    out = torch.where(a == inf, torch.where(b < 0, 0.0, inf), out)
    out = torch.where(
        a == -inf, torch.where(b_odd, -1.0, 1.0) * torch.where(b < 0, 0.0, inf), out
    )
    out = torch.where(torch.isnan(a) | torch.isnan(b), nan, out)
    out = torch.where(a == 1.0, 1.0, out)
    return torch.where(b == 0, 1.0, out)


_powf = None


def _libm_powf() -> int:
    """The address of glibc's `powf` in `libm.so.6`."""
    global _powf
    if _powf is None:
        _powf = ctypes.cast(ctypes.CDLL("libm.so.6").powf, ctypes.c_void_p).value
    return _powf


def powf_glibc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """glibc `powf` of two broadcastable f32 CPU tensors, element by element:
    the bits of the JAX package's CPU `jnp.power`."""
    a, b = torch.broadcast_tensors(a, b)
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if a.device.type != "cpu" or b.device.type != "cpu":
        raise TexProError(ErrorKind.NODE_PROCESSING, f"powf_glibc needs CPU tensors, got {a.device}")
    out = torch.empty_like(a)
    host_library().kanter_powf_array(_libm_powf(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     a.numel())
    return out


def pow_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's f32 pow on the tensors' device: glibc on the CPU,
    `ds_pow` on a card."""
    if a.device.type == "cpu":
        return powf_glibc(a, b)
    return ds_pow(a, b)
