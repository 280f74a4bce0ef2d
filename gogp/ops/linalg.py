"""Dense linear algebra for the GP core.

Replaces gonum ``mat.Cholesky`` (Factorize gp/gp.go:228, SolveVecTo :233,
SolveTo :338/:454/:480, LogDet :250).  Everything here is plain ``jnp`` and
``lax``: on the GPU, XLA hands the factorization to cuSOLVER and the
triangular solves to cuBLAS.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

Array = jax.Array

# Matmul precision for near-cancellation consumers: gp.serve's predictive
# variance (prior - explained) and gp.laplace/ep's Newton and site updates.
# "highest" is true float32 products.  JAX's default for float32 products
# on the GPU is TF32 (10-bit mantissa), which measured 2.4e-3 absolute
# error on served sigma at n=4096 against 1.8e-6 at "highest" (H100 at a
# 400 W power limit, chip_smoke.py serving phase).  Callers that consume
# only the mean may pass precision=None explicitly.
ACCURATE_PRECISION = "highest"

# The products of the LML backward (K^-1 = W^T W) run at true float32:
# TF32 keeps about three significant digits per product, and the trace
# term of the gradient that K^-1 feeds cancels badly when K is
# ill-conditioned.
_BACKWARD_PRECISION = "highest"


def cholesky(K: Array) -> Array:
    """Lower Cholesky factor of an SPD matrix."""
    return jnp.linalg.cholesky(K)


def cholesky_with_jitter(
    K: Array,
    max_tries: int = 5,
    initial_jitter: float = 1e-8,
) -> tuple[Array, Array]:
    """Cholesky with escalating diagonal jitter — the failure-detection path.

    The reference surfaces a failed factorization as a hard error with the
    offending matrix (gp/gp.go:228-230) and dies; under jit we can't raise,
    so instead: try plain Cholesky, and while the factor contains non-finite
    entries re-try with jitter ``initial_jitter * mean(diag) * 10^t`` added
    to the diagonal, up to ``max_tries`` escalations (a bounded while_loop).

    Returns ``(L, jitter_used)``; callers can expose ``jitter_used > 0`` as
    a warning signal.  With ``max_tries`` exhausted the factor still carries
    NaNs, which propagate to the log-density — samplers treat non-finite
    energies as divergences, so a truly unsalvageable matrix degrades into
    a rejected proposal instead of a crashed run.
    """
    n = K.shape[-1]
    eye = jnp.eye(n, dtype=K.dtype)
    scale = jnp.mean(jnp.diagonal(K)) * initial_jitter

    def ok(L):
        return jnp.all(jnp.isfinite(jnp.diagonal(L)))

    def cond(state):
        t, L, _ = state
        return (t < max_tries) & ~ok(L)

    def body(state):
        t, _, _ = state
        jitter = scale * (10.0 ** t.astype(K.dtype))
        L = cholesky(K + jitter * eye)
        return t + 1, L, jitter

    L0 = cholesky(K)
    _, L, jitter = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), L0, jnp.asarray(0.0, K.dtype))
    )
    return L, jitter


def syrk_lower_t(W: Array, min_size: int = 1024) -> Array:
    """W^T W for LOWER-TRIANGULAR W, exploiting the triangularity.

    A dense product spends 2n^3 flops; recursive 2x2 splitting

        [W1 0; W2 W3]^T [W1 0; W2 W3] =
            [W1^T W1 + W2^T W2,  W2^T W3]
            [   (W2^T W3)^T,     W3^T W3]

    recurses on the triangular W1/W3 diagonal blocks and pays dense
    products only for the dense W2 quarter: T(n) = 2 T(n/2) + n^3/2, about
    2n^3/3 flops, all of them large matmuls.  The recursion is unrolled at
    trace time down to ``min_size``.
    """
    n = W.shape[-1]
    if n <= min_size or n % 2 != 0 or (n // 2) % 8 != 0:
        return _tmm(W, W)
    h = n // 2
    W1, W2, W3 = W[:h, :h], W[h:, :h], W[h:, h:]
    top_left = syrk_lower_t(W1, min_size) + _tmm(W2, W2)
    off = _tmm(W2, W3)  # (h, h) = W2^T W3
    bottom_right = syrk_lower_t(W3, min_size)
    top = jnp.concatenate([top_left, off], axis=1)
    bottom = jnp.concatenate([off.T, bottom_right], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def _tmm(A: Array, B: Array) -> Array:
    """A^T B at the backward's precision."""
    return jax.lax.dot_general(
        A, B, (((0,), (0,)), ((), ())),
        preferred_element_type=A.dtype, precision=_BACKWARD_PRECISION,
    )


def _lml_core_fwd(K: Array, y: Array):
    L = jnp.linalg.cholesky(K)
    z = solve_triangular(L, y, lower=True)
    alpha = solve_triangular(L, z, lower=True, trans=1)
    value = -jnp.sum(jnp.log(jnp.diagonal(L))) - 0.5 * jnp.dot(z, z)
    return value, (L, alpha)


def _lml_core_bwd(res, g):
    # GPML eq. 5.9: dlml = -1/2 tr(K^-1 dK) + 1/2 a^T dK a with a = K^-1 y,
    # so Kbar = g/2 (a a^T - K^-1) and ybar = -g a.  K^-1 = W^T W with
    # W = inv(L): one triangular solve against I plus a triangular SYRK.
    L, alpha = res
    Kinv = syrk_lower_t(tril_inv(L))
    Kbar = (0.5 * g) * (jnp.outer(alpha, alpha) - Kinv)
    return Kbar, -g * alpha


@jax.custom_vjp
def lml_core(K: Array, y: Array) -> Array:
    """-1/2 (log|K| + y^T K^-1 y) — the data-dependent part of the GP log
    marginal likelihood (GPML eq. 5.8; reference gp/gp.go:244-253 minus the
    2pi constant).

    The reverse rule is the analytic GPML-5.9 pullback
    Kbar = g/2 (aa^T - K^-1) with K^-1 = inv(L)^T inv(L), which skips the
    generic Cholesky pullback.  On an H100 at a 400 W power limit it
    measured 7.3 ms against 11.9 ms for autodiff through the factorization
    at n=4096, and 243 against 490 ms at n=16384 (float32).  Reverse mode
    only: forward-mode differentiation of this function is not defined.
    """
    return _lml_core_fwd(K, y)[0]


lml_core.defvjp(_lml_core_fwd, _lml_core_bwd)


def cho_solve_vec(L: Array, y: Array) -> Array:
    """alpha = K^{-1} y given lower factor L (reference gp/gp.go:232-233)."""
    z = solve_triangular(L, y, lower=True)
    return solve_triangular(L, z, lower=True, trans=1)


def cho_solve_mat(L: Array, B: Array) -> Array:
    """K^{-1} B given lower factor L (reference SolveTo call sites)."""
    Z = solve_triangular(L, B, lower=True)
    return solve_triangular(L, Z, lower=True, trans=1)


def trsm_lower(L: Array, B: Array) -> Array:
    """L^{-1} B — the half-solve used by fused predictive variance."""
    return solve_triangular(L, B, lower=True)


def tril_inv(L: Array) -> Array:
    """W = inv(L) for lower-triangular L — the serving-cache precompute
    (gp/serve.py): spend one O(n^3/3) inversion at fit time so every later
    predictive solve is a single matmul instead of a triangular solve."""
    eye = jnp.eye(L.shape[-1], dtype=L.dtype)
    return solve_triangular(L, eye, lower=True)


def logdet_from_chol(L: Array, mask: Array | None = None) -> Array:
    """log|K| = 2 sum log diag(L) (reference gp/gp.go:250 L.LogDet()).

    With ``mask`` (0/1 per point), padded diagonal entries are excluded —
    padding contributes L_ii = 1 under the masked-covariance convention of
    gogp.gp.core.masked_cov, so this is belt-and-braces exactness.
    """
    d = jnp.log(jnp.diagonal(L))
    if mask is not None:
        d = d * mask
    return 2.0 * jnp.sum(d)
