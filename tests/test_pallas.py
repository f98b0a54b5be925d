"""df32 (double-float32) arithmetic, the float64 -> pair split the GLS
kernel relies on, and the CholQR2 breakdown flag."""
import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ninpol_tpu.ops import df32

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_df32_arithmetic():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000) * 5)
    b = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000) * 5)
    A = df32.from_f64(jnp.asarray(a))
    B = df32.from_f64(jnp.asarray(b))
    assert np.abs(np.asarray(df32.to_f64(df32.add(A, B))) - (a + b)).max() \
        / np.abs(a + b).max() < 1e-13
    assert np.abs(np.asarray(df32.to_f64(df32.mul(A, B))) - a * b).max() \
        / np.abs(a * b).max() < 1e-13
    assert np.abs(np.asarray(df32.to_f64(df32.div(A, B))) - a / b).max() \
        / np.abs(a / b).max() < 1e-12
    pa = np.abs(a)
    assert np.abs(np.asarray(df32.to_f64(df32.sqrt(
        df32.from_f64(jnp.asarray(pa))))) - np.sqrt(pa)).max() \
        / np.sqrt(pa).max() < 1e-13


def test_df32_tree_sum():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 37))
    X = df32.from_f64(jnp.asarray(x))
    s = np.asarray(df32.to_f64(df32.tree_sum(X, axis=1)))
    assert np.abs(s - x.sum(axis=1)).max() / np.abs(x).sum(1).max() < 1e-12


def test_df32_from_f64_rounds_like_float32():
    """The bit-pattern split equals the plain f64 -> f32 -> f64 round
    trip bit for bit (round half to even included) on negatives, signed
    zeros, exact ties and magnitudes whose lo half is a normal float32
    too (XLA flushes subnormal results to zero)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(4000) * np.exp2(rng.integers(-60, 60, 4000))
    h = rng.standard_normal(1000).astype(np.float32)
    ties = h.astype(np.float64) + np.spacing(h).astype(np.float64) / 2
    a = np.concatenate([a, ties, -ties, [0.0, -0.0, 1.0, -3.5]])
    hi, lo = (np.asarray(x) for x in jax.jit(df32.from_f64)(jnp.asarray(a)))
    ref_hi = a.astype(np.float32)
    ref_lo = (a - ref_hi.astype(np.float64)).astype(np.float32)
    assert hi.dtype == lo.dtype == np.float32
    np.testing.assert_array_equal(hi.view(np.uint32), ref_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.view(np.uint32), ref_lo.view(np.uint32))


_CONVERT = re.compile(
    r"(%\S+) = stablehlo\.convert (%\S+) : "
    r"\(tensor<(?:[^>]*x)?(f\d+)>\) -> tensor<(?:[^>]*x)?(f\d+)>")


def _f64_f32_f64_chains(text):
    """Count convert(convert(x: f64 -> f32) -> f64) chains in a lowered
    StableHLO module, function by function."""
    n = 0
    for fn in text.split("func.func")[1:]:
        narrowed = set()
        for res, src, t_in, t_out in _CONVERT.findall(fn):
            if (t_in, t_out) == ("f64", "f32"):
                narrowed.add(res)
            elif (t_in, t_out) == ("f32", "f64") and src in narrowed:
                n += 1
    return n


def test_round_trip_detector_sees_the_plain_split():
    """The chain counter finds the plain f64 -> f32 -> f64 split (so a
    zero below means something) and none in df32.from_f64."""
    def plain(a):
        h = a.astype(jnp.float32)
        return h, (a - h.astype(jnp.float64)).astype(jnp.float32)

    x = jnp.ones((2, 3))
    assert _f64_f32_f64_chains(jax.jit(plain).lower(x).as_text()) == 1
    assert _f64_f32_f64_chains(
        jax.jit(df32.from_f64).lower(x).as_text()) == 0


@pytest.mark.parametrize("program", ["graft_entry", "interior_bucket"])
def test_gls_kernel_holds_no_f64_f32_f64_round_trip(program):
    """XLA's GPU compiler, which allows excess precision by default,
    folds f64 -> f32 -> f64 convert chains to the identity; a hi/lo split
    written that way loses every lo half on the card, the df32 sweeps
    stall at float32 accuracy and nearly every node falls back to the
    exact path.  The fast GLS kernel, jitted with default compiler
    options as any caller would, must hold no such chain."""
    from ninpol_tpu._methods.gls import _gls_bucket_impl

    sys.path.insert(0, REPO)
    from __graft_entry__ import entry
    fn, args = entry()
    if program == "interior_bucket":
        def fn(*a):
            return _gls_bucket_impl(*a, E=8, F=12, with_neumann=False)
    text = jax.jit(fn).lower(*args).as_text()
    assert "stablehlo.convert" in text
    assert _f64_f32_f64_chains(text) == 0


def test_clamped_pivot_flags_both_rounds():
    """Breakdown detection must look at BOTH CholQR rounds' diagonals.  A clamped round-1 pivot shows up as
    |diag(Li1)| ~ 1/sqrt(tiny), but a large round-2 diagonal can cancel
    it in the combined factor Lc = L2^{-1} Li1, pushing max |diag(Lc)|
    back under the 3e4 sick threshold — so the guard is
    max(|diag Li1|, |diag Lc|) (gls.py cholqr path)."""
    from ninpol_tpu.ops.solve import chol_linv_f32

    B, n = 4, 8
    G1 = np.tile(np.eye(n, dtype=np.float32), (B, 1, 1))
    G1[:, n - 1, n - 1] = 1e-14             # below tiny=1e-12 -> clamp
    Li1 = np.asarray(chol_linv_f32(jnp.asarray(G1)))
    d_r1 = np.abs(np.diagonal(Li1, axis1=1, axis2=2)).max()
    assert d_r1 > 3e4                        # round-1 clamp visible
    G2 = np.tile(np.eye(n, dtype=np.float32), (B, 1, 1))
    G2[:, n - 1, n - 1] = 1e8                # round 2 "compensates"
    Lc = np.asarray(chol_linv_f32(jnp.asarray(G2),
                                  mul_right=jnp.asarray(Li1)))
    d_comb = np.abs(np.diagonal(Lc, axis1=1, axis2=2)).max()
    assert d_comb < 3e4          # the combined factor alone MISSES it
    assert max(d_comb, d_r1) > 3e4   # the both-rounds guard catches it


def test_cholqr_helpers_match_float64():
    """The batched CholQR2 pieces (ops/solve.py) vs NumPy float64 on a
    well-conditioned batch: Gram, second-round Gram, the inverse factor
    with and without a right factor, and the preconditioner apply."""
    import jax
    from ninpol_tpu.ops.solve import (chol_linv_f32, gram_f32,
                                      prec_apply_f32, round2_gram_f32)

    rng = np.random.default_rng(3)
    B, m, n = 16, 40, 13
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    A64 = A.astype(np.float64)
    G = np.einsum("bmn,bmk->bnk", A64, A64)
    rel = lambda x, ref: np.abs(np.asarray(x) - ref).max() / np.abs(ref).max()
    assert rel(gram_f32(jnp.asarray(A)), G) < 1e-5

    L = np.linalg.cholesky(G)
    Li = np.linalg.inv(L)
    Li1 = chol_linv_f32(jnp.asarray(G, jnp.float32))
    assert rel(Li1, Li) < 1e-4
    assert np.abs(np.triu(np.asarray(Li1)[0], 1)).max() == 0.0

    Q = np.einsum("bmn,bkn->bmk", A64, Li)
    G2 = np.einsum("bmn,bmk->bnk", Q, Q)
    assert rel(round2_gram_f32(jnp.asarray(A), jnp.asarray(Li, jnp.float32)),
               G2) < 1e-5

    P = np.tril(rng.standard_normal((B, n, n)))
    Lc = chol_linv_f32(jnp.asarray(G, jnp.float32),
                       mul_right=jnp.asarray(P, jnp.float32))
    assert rel(Lc, Li @ P) < 1e-4

    v = rng.standard_normal((B, n))
    Mv = np.einsum("bkn,bk->bn", Li, np.einsum("bnk,bk->bn", Li, v))
    out = jax.jit(prec_apply_f32)(jnp.asarray(Li, jnp.float32),
                                  jnp.asarray(v, jnp.float32))
    assert rel(out, Mv) < 1e-5
