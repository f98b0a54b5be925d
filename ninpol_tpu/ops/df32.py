"""Double-float32 ("df32") arithmetic: ~2^-48 precision from float32 ops.

The classical error-free transformations (Dekker/Knuth/Ogita-Rump) on
float32 PAIRS (hi, lo), so the GLS mixed-precision refinement runs in
float32 arithmetic at near-float64 accuracy (whether native float64
beats it on the H100 is not measured yet):

  * two_sum / fast_two_sum   — exact a+b = s + e
  * split / two_prod         — exact a*b = p + e (Veltkamp splitting;
                               no FMA assumed)
  * add / mul / from_f64 / to_f64 — df32 arithmetic
  * tree_sum                 — pairwise df32 reduction along an axis
                               (parallel, depth log2 n, error ~depth*2^-48)

Numerical contract: |result - exact| <= ~2^-44 relative after a depth-8
tree — validated by tests (XLA must not reassociate these expressions,
and IEEE float32 adds and multiplies are assumed).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_SPLITTER = 4097.0  # 2^12 + 1 for binary32 Veltkamp splitting


def two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    p = a * b
    a1, a2 = split(a)
    b1, b2 = split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def add(x, y):
    """df32 + df32 -> df32 (Dekker add2, ~2^-47 relative)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def mul(x, y):
    """df32 * df32 -> df32."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def neg(x):
    return -x[0], -x[1]


def from_f32(a):
    return a, jnp.zeros_like(a)


def from_f64(a):
    """float64 -> (hi, lo) float32 pair: hi is ``a`` rounded to nearest
    even float32, lo is ``a - hi`` rounded to float32.

    hi is rounded with integer ops on the float64 bit pattern (drop 29
    of the 52 mantissa bits), never by an f64 -> f32 -> f64 round trip:
    a compiler allowed excess precision (XLA's GPU default) may fold
    that round trip to the identity, which makes every lo zero.  Bitwise
    equal to the round trip for normal float32 magnitudes; below them
    (|a| < 2^-126) hi + lo is off a by at most 2^-149."""
    a = a.astype(jnp.float64)
    u64 = jnp.uint64
    bits = lax.bitcast_convert_type(a, u64)
    # round half to even at bit 29: add 2^28 - 1 plus the kept lsb
    half = u64(2 ** 28 - 1) + ((bits >> u64(29)) & u64(1))
    h = lax.bitcast_convert_type((bits + half) & u64(0xFFFF_FFFF_E000_0000),
                                 jnp.float64)
    return h.astype(jnp.float32), (a - h).astype(jnp.float32)


def to_f64(x):
    return x[0].astype(jnp.float64) + x[1].astype(jnp.float64)


def scale(x, s32):
    """df32 * plain f32 -> df32."""
    xh, xl = x
    p, e = two_prod(xh, s32)
    e = e + xl * s32
    return fast_two_sum(p, e)


def tree_sum(x, axis):
    """Pairwise df32 reduction along ``axis``: exactly n-1 df32 adds,
    depth ~log2(n), static slices only.

    n is split at the largest power of two below it (36 = 32 + 4), each
    part summed pairwise and the partial sums df32-added: no
    zero-padding work (padding 36 -> 64 would cost 63 adds where 35
    suffice), same ~depth*2^-48 error class."""

    def even_tree(xh, xl, n):
        # n is a power of two
        while n > 1:
            n //= 2
            a = (lax.slice_in_dim(xh, 0, n, axis=axis),
                 lax.slice_in_dim(xl, 0, n, axis=axis))
            b = (lax.slice_in_dim(xh, n, 2 * n, axis=axis),
                 lax.slice_in_dim(xl, n, 2 * n, axis=axis))
            xh, xl = add(a, b)
        return xh, xl

    def rec(xh, xl):
        n = xh.shape[axis]
        if n == 1:
            return xh, xl
        p = 1
        while p * 2 < n:
            p *= 2
        if p * 2 == n:
            return even_tree(xh, xl, n)
        a = even_tree(lax.slice_in_dim(xh, 0, p, axis=axis),
                      lax.slice_in_dim(xl, 0, p, axis=axis), p)
        b = rec(lax.slice_in_dim(xh, p, n, axis=axis),
                lax.slice_in_dim(xl, p, n, axis=axis))
        return add(a, b)

    xh, xl = rec(*x)
    return jnp.squeeze(xh, axis), jnp.squeeze(xl, axis)


def div(x, y):
    """df32 / df32 -> df32 (one Newton-style correction)."""
    xh, xl = x
    yh, yl = y
    q0 = xh / yh
    # r = x - q0*y  computed exactly-ish
    p, e = two_prod(q0, yh)
    rh = ((xh - p) - e) + xl - q0 * yl
    q1 = rh / yh
    return fast_two_sum(q0, q1)


def sqrt(x):
    """df32 sqrt (non-negative input; one correction step)."""
    xh, xl = x
    s = jnp.sqrt(xh)
    safe = jnp.where(s > 0, s, 1.0)
    p, e = two_prod(s, s)
    r = ((xh - p) - e) + xl
    lo = jnp.where(s > 0, r / (2.0 * safe), 0.0)
    return fast_two_sum(s, lo)


import math as _math
import numpy as _np


def _const_pair(v):
    hi = _np.float32(v)
    return float(hi), float(_np.float32(v - float(hi)))


_LN2 = _const_pair(_math.log(2.0))
_INV_LN2 = _const_pair(1.0 / _math.log(2.0))
_SQRT_HALF = 0.70710678


def _cpair(like, v):
    hi, lo = _const_pair(v)
    return (jnp.full_like(like, hi), jnp.full_like(like, lo))


def log2(x):
    """df32 log2 of a positive df32 pair, ~2^-42 relative.

    Range-reduce the hi mantissa to [sqrt(1/2), sqrt(2)), then the
    atanh series  log(m) = 2 atanh(t), t = (m-1)/(m+1), |t| < 0.172
    (9 odd terms reach ~2^-46), all in df32.
    """
    xh, xl = x
    # frexp via IEEE-754 bit extraction: identical to jnp.frexp for
    # normal positive floats (all callers clamp to >= 1e-30).
    bits = lax.bitcast_convert_type(xh, jnp.int32)
    # (i32 literal pinning: see exp2)
    ex = (((bits >> jnp.int32(23)) & jnp.int32(0xFF)) - jnp.int32(126))
    mant = lax.bitcast_convert_type(
        (bits & jnp.int32(0x7FFFFF)) | jnp.int32(0x3F000000),
        jnp.float32)  # mant in [0.5, 1)
    up = mant < _SQRT_HALF
    mant = jnp.where(up, mant * 2, mant)
    ex = (ex - up.astype(ex.dtype)).astype(xh.dtype)
    # carry the lo part into the mantissa: x = mant*2^e * (1 + xl/xh)
    r = xl / xh
    m = fast_two_sum(mant, mant * r)              # df32 mantissa
    num = add(m, (jnp.float32(-1.0), jnp.float32(0.0)))
    den = add(m, (jnp.float32(1.0), jnp.float32(0.0)))
    t = div(num, den)
    t2 = mul(t, t)
    # sum_{k odd} t^k/k  via Horner in t^2 (coefficients as hi/lo pairs)
    acc = _cpair(xh, 1.0 / 19.0)
    for k in (17, 15, 13, 11, 9, 7, 5, 3, 1):
        acc = add(mul(acc, t2), _cpair(xh, 1.0 / k))
    atanh = mul(t, acc)
    # log2(m) = 2*atanh / ln2
    lg_m = mul(scale(atanh, jnp.float32(2.0)),
               _cpair(xh, 1.0 / _math.log(2.0)))
    return add((ex, jnp.zeros_like(ex)), lg_m)


def exp2(x):
    """df32 2**x for |x| < ~120, ~2^-42 relative.

    Split x = k + f with integer k and |f| <= 0.5; 2^k is exact
    (jnp.exp2 on an integer-valued float), 2^f = exp(f ln2) by a
    15-term df32 Taylor series.
    """
    xh, xl = x
    k = jnp.round(xh)
    f = two_sum(xh - k, xl)      # NOT fast_two_sum: xl can exceed xh-k
    u = mul(f, _cpair(xh, _math.log(2.0)))         # |u| <= 0.347
    acc = _cpair(xh, 1.0 / _math.factorial(15))
    for k_ in (14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1):
        acc = add(mul(acc, u), _cpair(xh, 1.0 / _math.factorial(k_)))
    acc = mul(acc, u)
    acc = add(acc, (jnp.ones_like(xh), jnp.zeros_like(xh)))
    # 2^k EXACTLY via exponent-field construction (jnp.exp2 is an
    # approximation and is off by an ulp at some integers).  The exponent
    # field wraps silently outside [-126, 127], so saturate: beyond the
    # clamp the result degrades gracefully to ~2^±126-ish magnitudes
    # instead of garbage (powd's documented domain is |x| < ~120).
    # int literals pinned to i32: under x64 a bare python int traces as
    # a weak i64 constant
    ki = jnp.clip(k.astype(jnp.int32), jnp.int32(-126), jnp.int32(127))
    p2k = lax.bitcast_convert_type(
        ((ki + jnp.int32(127)) << jnp.int32(23)).astype(jnp.int32),
        jnp.float32)
    # multiply by the exact power of two DIRECTLY: scale()'s Dekker
    # two_prod splits its operands by multiplying with 4097, which
    # overflows to inf -> NaN for p2k >~ 2^116 — but a power-of-two
    # product is already exact in f32, no error term needed
    return acc[0] * p2k, acc[1] * p2k


def powd(x, y):
    """df32 x**y for positive df32 x:  2^(y * log2 x), ~2^-41.

    Runs as ~60 plain f32 vector ops.
    """
    return exp2(mul(y, log2(x)))


def dot3(x, y, axis=-1):
    """df32 dot over a SMALL axis (e.g. the 3 spatial components):
    products via two_prod, sequential df32 accumulation (exact order)."""
    xh, xl = x
    yh, yl = y
    n = xh.shape[axis]
    acc = None
    for k in range(n):
        a = (jnp.take(xh, k, axis=axis), jnp.take(xl, k, axis=axis))
        b = (jnp.take(yh, k, axis=axis), jnp.take(yl, k, axis=axis))
        p = mul(a, b)
        acc = p if acc is None else add(acc, p)
    return acc
