"""Toeplitz fast path: O(n log n) covariance matvecs for gridded inputs.

The reference's domain is 1-D time series (every tutorial dataset,
SURVEY.md C14) — and on a *regular* time grid a stationary kernel's
covariance is symmetric Toeplitz: K[i, j] = c(|i - j|).  The whole matrix
is one length-n vector, and K v computes in O(n log n) by circulant
embedding + FFT.  Plugged into the framework's matvec-generic iterative
engine (ops/iterative: CG solves, stochastic Lanczos quadrature, frozen-
solution Hutchinson gradients) this gives LML + gradients whose cost per
CG step is n log n flops and O(n) memory — the regime where even the
panel-rematerialized matrix-free path (O(panel * n) per matvec) is
quadratic.

Notes: the FFTs run in f32 complex (XLA lowers real-input FFTs
natively); there are no matmuls to run at reduced precision, so the matvec
is *more* accurate than a dense TF32 product.  Everything is static
shape; the circulant length is 2n (no padding to powers of two — XLA's
FFT handles arbitrary sizes; pad externally if profiling shows a win).

Constraints (asserted where checkable, documented here):
- inputs must lie on a regular 1-D grid (spacing checked by the GP-layer
  wrapper up to a tolerance);
- homoscedastic noise (a Toeplitz diagonal must be constant);
- no padding mask (identity-row padding breaks Toeplitz structure — at
  O(n log n) there is no reason to pad).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def circulant_spectrum(c: Array) -> Array:
    """rfft of the 2n circulant embedding of symmetric-Toeplitz first
    column ``c``: [c_0..c_{n-1}, 0, c_{n-1}..c_1]."""
    n = c.shape[0]
    circ = jnp.concatenate([c, jnp.zeros((1,), c.dtype), c[1:][::-1]])
    return jnp.fft.rfft(circ)


def toeplitz_matvec_fn(c: Array):
    """Batched matvec V -> K V for K = SymToeplitz(c); V: (n,) or (n, k).

    One rfft of the padded operand, a pointwise product with the cached
    circulant spectrum, one irfft — O(n log n) per column, O(n) memory.
    """
    n = c.shape[0]
    fc = circulant_spectrum(c)

    def mv(V):
        squeeze = V.ndim == 1
        Vm = V[:, None] if squeeze else V
        pad = jnp.zeros((n, Vm.shape[1]), Vm.dtype)
        fv = jnp.fft.rfft(jnp.concatenate([Vm, pad], axis=0), axis=0)
        out = jnp.fft.irfft(fv * fc[:, None], n=2 * n, axis=0)[:n]
        out = out.astype(V.dtype)
        return out[:, 0] if squeeze else out

    return mv


def toeplitz_col_fn(c: Array):
    """Column accessor for the pivoted-Cholesky preconditioner:
    col_j[i] = c[|i - j|] — one gather per requested column."""
    n = c.shape[0]
    idx = jnp.arange(n)

    def col(j):
        return c[jnp.abs(idx - j)]

    return col


def lml_toeplitz_core(
    c_fn,
    y: Array,
    key: Array,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    noise_var: Array | float | None = None,
):
    """-1/2 (log|K| + y^T K^-1 y) for K = SymToeplitz(c_fn(...)) with the
    frozen-solution gradient trick of ops.iterative.lml_matfree.

    ``c_fn() -> (n,)`` produces the first column (closing over
    hyperparameters); returns (value, aux) with aux = (alpha, Z, S) —
    package with a custom VJP that differentiates
    :func:`toeplitz_quadratic_forms` (gp.core.lml_toeplitz does this).
    ``precond_rank > 0`` runs PCG + preconditioned SLQ with the pivoted-
    Cholesky preconditioner built from O(rank) Toeplitz column gathers
    (``noise_var`` required: the constant noise variance on the diagonal).
    """
    from gogp.ops.iterative import (
        cg_solve,
        pivoted_precond_cols,
        rademacher,
        slq_logdet,
        slq_logdet_pcg,
    )

    c = c_fn()
    n = y.shape[0]
    mv = toeplitz_matvec_fn(c)
    k1, k2 = jax.random.split(jnp.asarray(key))
    pc = None
    if precond_rank > 0:
        if noise_var is None:
            raise ValueError("precond_rank > 0 needs noise_var")
        c_sg = jax.lax.stop_gradient(c)
        pc = pivoted_precond_cols(
            toeplitz_col_fn(c_sg),
            jnp.broadcast_to(c_sg[0], (n,)),
            precond_rank,
            jnp.broadcast_to(jnp.asarray(noise_var, y.dtype), (n,)),
        )
        probes_slq = jax.random.normal(k1, (num_probes, n + precond_rank), y.dtype)
    else:
        probes_slq = rademacher(k1, (num_probes, n), y.dtype)
    probes_tr = rademacher(k2, (n, num_probes), y.dtype)
    X, _ = cg_solve(
        mv, jnp.concatenate([y[:, None], probes_tr], axis=1), cg_iters,
        precond=pc,
    )
    alpha, S = X[:, 0], X[:, 1:]
    if pc is not None:
        logdet = slq_logdet_pcg(
            mv, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters
        )
    else:
        logdet = slq_logdet(mv, probes_slq, lanczos_iters)
    value = -0.5 * (logdet + jnp.dot(y, alpha))
    return value, (alpha, probes_tr, S)


def toeplitz_quadratic_forms(c_fn, alpha: Array, Z: Array, S: Array) -> Array:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K) via FFT matvecs.

    d lml = g/2 * dh/dtheta with (alpha, Z, S) frozen — the Toeplitz
    counterpart of ops.iterative.matfree_quadratic_forms; differentiate
    w.r.t. whatever ``c_fn`` closes over (gradients flow through the FFT
    of the first column — O(n log n), O(n) residuals).
    """
    c = c_fn()
    mv = toeplitz_matvec_fn(c)
    p = Z.shape[1]
    quad = jnp.dot(alpha, mv(alpha))
    tr = 0.5 * (jnp.sum(Z * mv(S)) + jnp.sum(S * mv(Z)))
    return quad - tr / p


__all__ = [
    "circulant_spectrum",
    "lml_toeplitz_core",
    "toeplitz_col_fn",
    "toeplitz_matvec_fn",
    "toeplitz_quadratic_forms",
]
