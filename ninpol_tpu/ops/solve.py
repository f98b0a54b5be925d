"""Batched small linear-algebra building blocks for the GLS solve.

  * :func:`gram_f32`, :func:`round2_gram_f32`, :func:`chol_linv_f32`,
    :func:`prec_apply_f32` — the float32 pieces of the shifted
    CholeskyQR2 preconditioner (methods/gls.py).  Plain batched einsums
    and ``jnp.linalg.cholesky`` / ``solve_triangular``: on the GPU XLA
    hands them to cuBLAS and cuSOLVER batched routines, on the CPU to
    LAPACK.
  * :func:`spd_block_inverse` — recursive Schur-complement inversion of
    SPD matrices (matmul-only, log2(n) recursion depth, closed-form base).
  * :func:`solve_normal_refined` — mixed-precision least-squares via the
    normal equations: float32 matmul-only inverse as preconditioner +
    float64 residual refinement, converging to ~eps64*cond accuracy.
  * :func:`householder_lastrow` — float64 Householder triangularization of
    an augmented [A | B], returning the least-squares solution's last row
    (exactly what the GLS weights need, see methods/gls.py); the "exact"
    path matching LAPACK ``dgels`` semantics
    (reference: ninpol/_methods/gls.pyx:457-472).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_F32 = jnp.float32


def gram_f32(A):
    """(B, m, n) f32 -> (B, n, n) f32 Gram matrices A_b^T A_b."""
    return jnp.einsum("bmn,bmk->bnk", A, A, preferred_element_type=_F32)


def round2_gram_f32(A, Li):
    """(B,m,n),(B,n,n) -> (B,n,n) = (A Li^T)^T (A Li^T), the second
    CholQR Gram (Q = A Li^T is the re-orthonormalised basis)."""
    Q = jnp.einsum("bmn,bkn->bmk", A, Li, preferred_element_type=_F32)
    return jnp.einsum("bmn,bmk->bnk", Q, Q, preferred_element_type=_F32)


def prec_apply_f32(Lc, v):
    """Apply the CholQR2 preconditioner M = Lc^T Lc per node.

    Lc: (B, n, n) f32 (combined factor Li2 @ Li1); v: (B, n) f32.
    Returns (B, n) f32."""
    t = jnp.einsum("bnk,bk->bn", Lc, v)
    return jnp.einsum("bkn,bk->bn", Lc, t)


def chol_linv_f32(G, tiny=1e-12, mul_right=None):
    """Batched SPD Cholesky inverse factor.

    G: (B, n, n) f32 SPD.  Returns Linv (B, n, n) with G = L L^T,
    Linv = L^{-1} (lower triangular); with ``mul_right`` (B, n, n)
    given, returns L^{-1} @ mul_right instead (used to form the
    combined CholQR2 factor Li2 @ Li1).  ``tiny`` is added to the
    diagonal, so a (near-)zero pivot shows as |diag(Linv)| ~
    1/sqrt(tiny); the non-finite entries of a failed factorization
    become 1e6.  Callers detect breakdown via ``max |diag(Linv)|``.
    """
    n = G.shape[-1]
    L = jnp.linalg.cholesky(G + (tiny * jnp.eye(n, dtype=G.dtype))[None])
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    rhs = (jnp.broadcast_to(jnp.eye(n, dtype=G.dtype), G.shape)
           if mul_right is None else mul_right)
    Li = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jnp.where(jnp.isfinite(Li), Li, _F32(1e6))


def chol_inverse_factor(g):
    """Matmul-only inverse Cholesky factor of batched SPD (..., n, n).

    Returns Linv = L^{-1} with G = L L^T, via the recursive 2x2-block
    factorization
        L11 = chol(A);  L21 = B^T L11^{-T};  S = C - L21 L21^T
        Linv = [[L11^{-1}, 0], [-L22^{-1} L21 L11^{-1}, L22^{-1}]].
    Unlike a direct Schur-complement *inversion* (which loses ~cond extra
    digits to cancellation in the A^{-1} + W S^{-1} W^T term and was
    observed to diverge at cond ~ 3e4 in float32), Cholesky keeps the
    preconditioner residual ||I - Linv^T Linv G|| ~ cond * eps.
    ``n`` must be a power of two.
    """
    n = g.shape[-1]
    # Clamp keeps the factorization finite past float32 Cholesky breakdown
    # (cond(G) > 1/eps32); such nodes are detected by the caller via the
    # final residual and re-solved on the exact float64 path.  1e-8 bounds
    # rsqrt at 1e4 so Linv^T Linv products stay below float32 overflow
    # (the diagonal of the equilibrated G is ~1, healthy pivots >> 1e-8).
    tiny = jnp.asarray(1e-8, g.dtype)
    if n == 1:
        return jax.lax.rsqrt(jnp.maximum(g, tiny))
    if n == 2:
        a = g[..., 0, 0]
        c = g[..., 1, 0]
        d = g[..., 1, 1]
        il11 = jax.lax.rsqrt(jnp.maximum(a, tiny))
        l21 = c * il11
        il22 = jax.lax.rsqrt(jnp.maximum(d - l21 * l21, tiny))
        z = jnp.zeros_like(a)
        row0 = jnp.stack([il11, z], axis=-1)
        row1 = jnp.stack([-l21 * il11 * il22, il22], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    h = n // 2
    A = g[..., :h, :h]
    B = g[..., :h, h:]
    C = g[..., h:, h:]
    Li11 = chol_inverse_factor(A)
    L21 = jnp.swapaxes(Li11 @ B, -1, -2)            # = B^T Li11^T
    S = C - L21 @ jnp.swapaxes(L21, -1, -2)
    Li22 = chol_inverse_factor(S)
    Li21 = -(Li22 @ L21) @ Li11
    z = jnp.zeros_like(B)
    top = jnp.concatenate([Li11, z], axis=-1)
    bot = jnp.concatenate([Li21, Li22], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def spd_block_inverse(g):
    """Matmul-only inverse of batched SPD matrices via Cholesky:
    G^{-1} = Linv^T Linv.  ``n`` must be a power of two."""
    Linv = chol_inverse_factor(g)
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def solve_normal_refined(A64, b64, n_refine=3):
    """Solve (A^T A) x = b per batch element in mixed precision.

    A64: (B, m, n) float64, full column rank (the GLS assembly adds
         identity regularization rows for padding columns to guarantee it).
    b64: (B, n) float64 normal-equation RHS (GLS uses b = e_{n-1}).

    Column-equilibrates, builds a float32 matmul-only SPD inverse as the
    preconditioner, then runs ``n_refine`` float64 residual-correction
    sweeps (each sweep: two float64 matvecs with A).  Error contracts by
    ~cond(A_eq)^2 * eps32 per sweep down to ~eps64 * cond(A_eq).
    """
    d2 = jnp.einsum("bmn,bmn->bn", A64, A64)           # column sq norms
    dead = d2 == 0
    D = jnp.where(dead, 0.0, jax.lax.rsqrt(jnp.where(dead, 1.0, d2)))

    A32 = (A64 * D[:, None, :]).astype(jnp.float32)
    G = jnp.einsum("bmn,bmk->bnk", A32, A32,
                   preferred_element_type=jnp.float32)
    n = G.shape[-1]
    idx = jnp.arange(n)
    G = G.at[:, idx, idx].add(dead.astype(jnp.float32))

    p = _next_pow2(n)
    if p != n:
        Gp = jnp.zeros((G.shape[0], p, p), dtype=G.dtype)
        pad_idx = jnp.arange(n, p)
        Gp = Gp.at[:, pad_idx, pad_idx].set(1.0)
        G = Gp.at[:, :n, :n].set(G)
    # G^-1 applied as Linv^T (Linv r): two triangular matvecs keep the
    # preconditioner residual at ~cond*eps32 (a formed inverse would do
    # too, but the factored form is cheaper and slightly more accurate).
    Li = chol_inverse_factor(G)[:, :n, :n]

    def apply_prec(r64):
        rs = (r64 * D).astype(jnp.float32)
        t = jnp.einsum("bnk,bk->bn", Li, rs)
        xs = jnp.einsum("bkn,bk->bn", Li, t)
        return xs.astype(jnp.float64) * D

    x = apply_prec(b64)

    def residual(x):
        Ax = jnp.einsum("bmn,bn->bm", A64, x)
        return b64 - jnp.einsum("bmn,bm->bn", A64, Ax)

    # Unrolled (n_refine is small): a lax.fori_loop here makes XLA carry
    # the loop-invariant A through the while-state, which can copy it
    # per iteration; unrolling lets it stay in place and fuse.
    dx2 = jnp.zeros((A64.shape[0],), jnp.float64)
    for _ in range(n_refine):
        dx = apply_prec(residual(x))
        x = x + dx
        dx2 = jnp.sum(dx * dx, axis=1)
    x = jnp.where(dead, 0.0, x)
    # Error indicator: size of the LAST refinement correction relative to
    # the solution — the standard iterative-refinement error estimate
    # (||dy_k||/||y|| ~ current relative error while converging; large or
    # NaN when diverging).  A raw residual norm under-reports the error by
    # a cond(G) factor and lets ill-conditioned nodes slip through.
    err_est = jnp.sqrt(dx2) / jnp.maximum(
        jnp.linalg.norm(x, axis=1), 1e-300)
    return x, err_est


def qr_r_factor(A, n_cols):
    """Float32 Householder triangularization of (B, m, n): returns the
    upper-triangular R (B, n, n).  Used as the refinement preconditioner:
    unlike Cholesky of A^T A (residual ~ cond(A)^2 * eps32, which stalls
    the refinement on finer meshes where cond(G) ~ 1e6), the QR residual
    is ~cond(A) * eps32, so two refinement sweeps always reach the f64
    floor.  O(n) sequential batched rank-1 updates, traffic-bound.
    """
    m = A.shape[1]
    rows = jnp.arange(m)
    dt = A.dtype

    def body(k, R):
        col = R[:, :, k]
        mask = (rows >= k)[None, :]
        x = jnp.where(mask, col, 0.0)
        e_k = (rows == k).astype(dt)[None, :]
        xk = jnp.sum(x * e_k, axis=1)
        normx = jnp.sqrt(jnp.sum(x * x, axis=1))
        alpha = jnp.where(xk >= 0, -normx, normx)
        v = x - alpha[:, None] * e_k
        vnorm2 = jnp.sum(v * v, axis=1)
        beta = jnp.where(vnorm2 > 0, 2.0 / vnorm2, 0.0)
        w = jnp.einsum("bm,bmn->bn", v, R)
        return R - beta[:, None, None] * v[:, :, None] * w[:, None, :]

    R = jax.lax.fori_loop(0, n_cols, body, A)
    return R[:, :n_cols, :n_cols]


def tri_upper_inverse(R):
    """Matmul-only inverse of batched upper-triangular (..., n, n):
    inv([[A, B], [0, C]]) = [[A^-1, -A^-1 B C^-1], [0, C^-1]].
    ``n`` must be a power of two; near-zero diagonals are clamped (the
    caller flags those systems for the exact path)."""
    n = R.shape[-1]
    if n == 1:
        d = R[..., 0, 0]
        safe = jnp.where(jnp.abs(d) < 1e-8,
                         jnp.where(d < 0, -1e-8, 1e-8), d)
        return (1.0 / safe)[..., None, None] if R.ndim == 2 else 1.0 / R
    if n == 2:
        a = R[..., 0, 0]
        b = R[..., 0, 1]
        c = R[..., 1, 1]
        clamp = lambda d: jnp.where(jnp.abs(d) < 1e-8,
                                    jnp.where(d < 0, -1e-8, 1e-8), d)
        ia = 1.0 / clamp(a)
        ic = 1.0 / clamp(c)
        z = jnp.zeros_like(a)
        row0 = jnp.stack([ia, -ia * b * ic], axis=-1)
        row1 = jnp.stack([z, ic], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    h = n // 2
    A = R[..., :h, :h]
    B = R[..., :h, h:]
    C = R[..., h:, h:]
    Ai = tri_upper_inverse(A)
    Ci = tri_upper_inverse(C)
    TR = -(Ai @ B) @ Ci
    z = jnp.zeros_like(B)
    top = jnp.concatenate([Ai, TR], axis=-1)
    bot = jnp.concatenate([jnp.swapaxes(z, -1, -2), Ci], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def solve_normal_refined_ops(A32, b64, mul_G, n_refine=3):
    """Mixed-precision solve of (A^T A) y = b: float32 QR(A)-based
    preconditioner + float64 residual refinement through the structured
    ``mul_G(y) = A^T(A y)`` closure (the dense float64 A is never
    materialized).  ``A32`` is the float32 dense assembly, used only
    for equilibration + the preconditioner."""
    d2_32 = jnp.einsum("bmn,bmn->bn", A32, A32)
    dead = d2_32 == 0
    D32 = jnp.where(dead, 0.0,
                    jax.lax.rsqrt(jnp.where(dead, 1.0, d2_32)))
    D = D32.astype(jnp.float64)

    A32s = A32 * D32[:, None, :]
    n = A32.shape[2]
    m = A32.shape[1]
    # Dead (padding) columns need a nonzero Householder diagonal to stay
    # positionally aligned.  APPENDED identity rows (scaled by the dead
    # mask) provide it without touching real rows — a unit injected into
    # an existing row couples padding columns to real columns in A^T A
    # and was measured to degrade the preconditioner enough to throw
    # 10-70% of partially-filled buckets onto the exact-path fallback.
    reg = jnp.eye(n, dtype=A32s.dtype)[None] * dead[:, None, :].astype(
        A32s.dtype)
    A32s = jnp.concatenate([A32s, reg], axis=1)

    R = qr_r_factor(A32s, n)
    p = _next_pow2(n)
    if p != n:
        Rp = jnp.zeros((R.shape[0], p, p), dtype=R.dtype)
        pad_idx = jnp.arange(n, p)
        Rp = Rp.at[:, pad_idx, pad_idx].set(1.0)
        R = Rp.at[:, :n, :n].set(R)
    with jax.default_matmul_precision("high"):
        Rinv = tri_upper_inverse(R)[:, :n, :n]

    # (Near-)singular systems: refinement may converge INSIDE the solution
    # family to a different member than LAPACK dgels picks (observed at
    # rank-deficient 2D boundary-Neumann stencils); the error estimate
    # alone cannot catch that — flag for the exact fallback outright.
    sick = jnp.max(jnp.abs(jnp.diagonal(Rinv, axis1=1, axis2=2)),
                   axis=1) > 3e3

    def apply_prec(r64):
        rs = (r64 * D).astype(jnp.float32)
        t = jnp.einsum("bkn,bk->bn", Rinv, rs)     # R^-T rs
        xs = jnp.einsum("bnk,bk->bn", Rinv, t)     # R^-1 t
        return xs.astype(jnp.float64) * D

    x = apply_prec(b64)
    dx2 = jnp.zeros((A32.shape[0],), jnp.float64)
    for _ in range(n_refine):
        dx = apply_prec(b64 - mul_G(x))
        x = x + dx
        dx2 = jnp.sum(dx * dx, axis=1)
    x = jnp.where(dead, 0.0, x)
    err_est = jnp.sqrt(dx2) / jnp.maximum(
        jnp.linalg.norm(x, axis=1), 1e-300)
    err_est = jnp.where(sick, 1.0, err_est)
    return x, err_est


def householder_lastrow(Aug, n_cols):
    """Float64 Householder triangularization of augmented [A|B] (B, m, n+r);
    returns the last LS-solution row (B, r) = R[n-1, n:]/R[n-1, n-1].

    For an upper-triangular R the last row of R11^-1 is e_n^T/R[n-1,n-1],
    so the full triangular solve is unnecessary.  Matches LAPACK ``dgels``
    up to rounding.  O(n_cols) sequential batched rank-1 updates in
    float64: the exact path.
    """
    dt = Aug.dtype
    m = Aug.shape[1]
    rows = jnp.arange(m)

    def body(k, R):
        col = R[:, :, k]
        mask = (rows >= k)[None, :]
        x = jnp.where(mask, col, 0.0)
        e_k = (rows == k).astype(dt)[None, :]
        xk = jnp.sum(x * e_k, axis=1)
        normx = jnp.sqrt(jnp.sum(x * x, axis=1))
        alpha = jnp.where(xk >= 0, -normx, normx)
        v = x - alpha[:, None] * e_k
        vnorm2 = jnp.sum(v * v, axis=1)
        beta = jnp.where(vnorm2 > 0, 2.0 / vnorm2, 0.0)
        w = jnp.einsum("bm,bmn->bn", v, R)
        R = R - beta[:, None, None] * v[:, :, None] * w[:, None, :]
        return R

    R = jax.lax.fori_loop(0, n_cols, body, Aug)
    denom = R[:, n_cols - 1, n_cols - 1]
    denom = jnp.where(denom == 0, 1.0, denom)
    return R[:, n_cols - 1, n_cols:] / denom[:, None]
