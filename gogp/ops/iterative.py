"""Matrix-free iterative GP inference: CG solves + stochastic Lanczos
quadrature log-determinants + Hutchinson-trace gradients.

The exact path (ops/linalg.lml_core -> dense Cholesky) is O(n^3)
and materializes the factor; this module is the O(n^2)-per-iteration
alternative in the GPyTorch/BBMM family (Gardner et al. 2018; the
determinant-free fully-Bayesian framework of arXiv 2412.20884): everything
is batched covariance matvecs, which are pure bandwidth-bound matmul
work, and a block of probe vectors rides each matvec for free (the n x n
HBM traffic dominates; extra right-hand sides are nearly free).  At n
where the dense factorization's n^3 hurts, ~30
preconditioner-free CG iterations of n^2 each win; it also composes with
row sharding — the matvec's rows split over the data axis and one tiled
all_gather replicates each product (the far simpler distributed story
than a blocked factorization).

Replaces (approximately) the same gonum calls as ops/linalg: Factorize /
SolveVecTo / LogDet (reference gp/gp.go:228-250) — with a controlled,
key-deterministic estimator for the logdet instead of an exact one.

Estimator contract (tested): given a fixed PRNG key the forward value is
a deterministic function with ~0.5% relative error at 32 probes x 48
Lanczos steps.  ``jax.grad`` through it is NOT the derivative of that
estimator: the custom VJP substitutes the Hutchinson estimate of
tr(K^-1 dK) (reusing the CG probe solves), i.e. an independent stochastic
estimator of the EXACT gradient — element-wise Kbar noise is ~10% but the
theta-gradient (Kbar contracted against smooth dK) lands within 1-3% of
the exact gradient at 8-128 probes, the BBMM operating regime.  The
y-gradient is exact (-g alpha).

The backward pass (custom VJP) uses the analytic identities
    d lml = 1/2 a^T dK a - 1/2 tr(K^-1 dK),        a = K^-1 y,
with tr(K^-1 dK) ~= (1/p) sum_j s_j^T dK z_j,      s_j = K^-1 z_j,
i.e.  Kbar = g/2 (a a^T - (1/2p)(Z S^T + S Z^T)),  ybar = -g a  —
the probe solves S are computed in the SAME batched CG as a, so the
gradient costs no extra solves (GPML eq. 5.9 with a stochastic trace).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array

_LOG_2PI = 1.8378770664093453


def _as_matvec(A):
    """Accept an (n, n) array or a callable (n, k) -> (n, k) matvec —
    the callable form is how row-sharded/distributed operators plug in
    (each device computes its block-rows' product and all_gathers)."""
    return A if callable(A) else (lambda V: A @ V)


def cg_solve(
    A,
    B: Array,
    max_iters: int = 100,
    tol: float = 1e-6,
    precond=None,
) -> tuple[Array, Array]:
    """Batched (preconditioned) conjugate gradients for SPD ``A``: A X = B.

    ``A``: (n, n) array or callable batched matvec (see :func:`_as_matvec`).
    ``B``: (n, k) — all right-hand sides share each A matvec (the point of
    the method: the matvec streams A once from HBM regardless of k).
    ``precond``: optional callable V -> M^-1 V (see
    :func:`pivoted_precond`); with it the loop runs standard PCG.
    Runs until every column's relative residual is below ``tol`` or
    ``max_iters``; converged columns freeze (alpha forced to 0) so extra
    iterations cannot reintroduce error.  Returns (X, iters_used).
    """
    mv = _as_matvec(A)
    pc = (lambda V: V) if precond is None else precond
    B = jnp.asarray(B)
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    bnorm2 = jnp.sum(B * B, axis=0)
    stop2 = (tol * tol) * jnp.maximum(bnorm2, 1e-30)

    X0 = jnp.zeros_like(B)
    R0 = B
    Z0 = pc(B)
    P0 = Z0
    rz0 = jnp.sum(R0 * Z0, axis=0)
    rr0 = jnp.sum(R0 * R0, axis=0)

    def cond(carry):
        _, _, _, _, rr, it = carry
        return (it < max_iters) & jnp.any(rr > stop2)

    def body(carry):
        X, R, P, rz, rr, it = carry
        AP = mv(P)
        denom = jnp.sum(P * AP, axis=0)
        # a non-positive curvature p^T A p means matvec precision noise
        # (~eps * lambda_max) has swamped the smallest eigenvalues — the
        # column cannot make progress at this precision.  Freeze it (alpha
        # 0) instead of taking the exploding step: the result honestly
        # stalls at the achievable residual rather than overflowing to NaN
        # (observed: cond ~1e6 covariance at reduced-precision matvecs).
        active = (rr > stop2) & (denom > 0.0)
        alpha = jnp.where(active, rz / jnp.maximum(denom, 1e-30), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = pc(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(active, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        P = Z + beta[None, :] * P
        return X, R, P, rz_new, jnp.sum(R * R, axis=0), it + 1

    X, _, _, _, _, iters = jax.lax.while_loop(
        cond, body, (X0, R0, P0, rz0, rr0, jnp.asarray(0, jnp.int32))
    )
    return (X[:, 0] if squeeze else X), iters


def pivoted_cholesky_cols(col_fn, d0: Array, rank: int) -> Array:
    """Partial pivoted Cholesky from a COLUMN ACCESSOR: L (n, rank) with
    target ~= L L^T, where ``col_fn(i) -> (n,)`` returns column i of the
    target matrix and ``d0`` is its (n,) diagonal.

    Greedy residual-diagonal pivoting (Harbrecht et al.) — the standard
    low-rank capture of a smooth kernel matrix's fast-decaying spectrum.
    This is the matrix-free / row-sharded form: the build touches only
    ``rank`` columns (one kernel-row evaluation, or one all_gather of a
    local column slice, each), never a dense K.  O(n * rank^2), fully
    jittable (dynamic pivots are gathers); safe inside shard_map when
    ``col_fn``'s collectives are — the pivot argmax runs on the replicated
    residual diagonal, so every device picks the same columns.
    """
    n = d0.shape[0]
    L0 = jnp.zeros((n, rank), d0.dtype)

    def step(j, carry):
        L, d = carry
        i = jnp.argmax(d)
        col = col_fn(i)
        lj = (col - L @ L[i]) / jnp.sqrt(jnp.maximum(d[i], 1e-30))
        # a tiny/negative residual pivot means the rank is exhausted:
        # write a zero column instead of amplified noise
        lj = jnp.where(d[i] > 1e-12 * jnp.maximum(d0[0], 1e-30), lj, 0.0)
        L = L.at[:, j].set(lj)
        d = jnp.maximum(d - lj * lj, 0.0)
        return L, d

    L, _ = jax.lax.fori_loop(0, rank, step, (L0, d0))
    return L


def pivoted_cholesky(K: Array, rank: int, shift: Array | float = 0.0) -> Array:
    """Partial pivoted Cholesky: L (n, rank) with K - shift*I ~= L L^T.

    ``shift`` removes a known diagonal (noise/jitter) from the pivoting
    target so the columns chase the signal part.  Dense wrapper over
    :func:`pivoted_cholesky_cols`.
    """
    n = K.shape[-1]

    def col_fn(i):
        return jnp.take(K, i, axis=1) - shift * (
            jnp.arange(n) == i
        ).astype(K.dtype)

    return pivoted_cholesky_cols(col_fn, jnp.diagonal(K) - shift, rank)


class PivotedPrecond:
    """P = L L^T + D from a partial pivoted Cholesky: callable Woodbury
    apply V -> P^-1 V, plus the two extras preconditioned SLQ needs —
    exact ``logdet`` (matrix determinant lemma) and ``sample`` of
    z ~ N(0, P) from standard-normal seeds (z = D^1/2 eps_n + L eps_r)."""

    def __init__(self, L: Array, dvec: Array):
        self.L = L
        self.dvec = dvec
        self.dinv = 1.0 / dvec
        rank = L.shape[1]
        M = jnp.eye(rank, dtype=L.dtype) + L.T @ (self.dinv[:, None] * L)
        self.Mc = jnp.linalg.cholesky(M)
        # log det(D + L L^T) = log det(D) + log det(I + L^T D^-1 L)
        self.logdet = jnp.sum(jnp.log(dvec)) + 2.0 * jnp.sum(
            jnp.log(jnp.diagonal(self.Mc))
        )

    def __call__(self, V):
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        DV = self.dinv[:, None] * V
        t = jax.scipy.linalg.cho_solve((self.Mc, True), self.L.T @ DV)
        out = DV - self.dinv[:, None] * (self.L @ t)
        return out[:, 0] if squeeze else out

    def sample(self, eps_n: Array, eps_r: Array) -> Array:
        """(p, n) and (p, rank) standard normals -> (n, p) draws of
        N(0, P)."""
        return jnp.sqrt(self.dvec)[:, None] * eps_n.T + self.L @ eps_r.T


def pivoted_precond(K: Array, rank: int, noise_diag: Array | float) -> PivotedPrecond:
    """Build :class:`PivotedPrecond` for P = L L^T + D with L from
    :func:`pivoted_cholesky` (pivoting on K - D):

        P^-1 = D^-1 - D^-1 L (I + L^T D^-1 L)^-1 L^T D^-1.

    ``noise_diag``: scalar or (n,) — the observation-noise/jitter diagonal
    of K (for GP covariances this is exactly gp.noise + jitter).  The
    returned object is callable, (n, k) -> (n, k) in O(n * rank * k).
    """
    n = K.shape[-1]
    dvec = jnp.broadcast_to(jnp.asarray(noise_diag, K.dtype), (n,))
    L = pivoted_cholesky(K, rank, shift=jnp.mean(dvec))
    return PivotedPrecond(L, dvec)


def pivoted_precond_cols(col_fn, diag: Array, rank: int, noise_diag) -> PivotedPrecond:
    """Matrix-free :func:`pivoted_precond`: build P = L L^T + D from a
    column accessor ``col_fn(i) -> (n,)`` (column i of K itself) and the
    (n,) diagonal of K, without a dense K ever existing.  Identical math
    to the dense builder — same shift (mean of ``noise_diag``), same
    pivot sequence — so with matching columns the two produce the same
    preconditioner bit-for-bit up to reassociation of the column source.
    """
    n = diag.shape[0]
    dvec = jnp.broadcast_to(jnp.asarray(noise_diag, diag.dtype), (n,))
    shift = jnp.mean(dvec)

    def col_shifted(i):
        return col_fn(i) - shift * (jnp.arange(n) == i).astype(diag.dtype)

    L = pivoted_cholesky_cols(col_shifted, diag - shift, rank)
    return PivotedPrecond(L, dvec)


def _lanczos(A, z: Array, num_steps: int) -> tuple[Array, Array]:
    """``num_steps`` of Lanczos on SPD A (array or callable matvec) from
    start vector z (normalized inside), with full reorthogonalization
    (m is small; stability first).

    Returns (alphas (m,), betas (m-1,)) of the tridiagonal T.
    """
    mv = _as_matvec(A)
    n = z.shape[0]
    m = num_steps
    q = z / jnp.linalg.norm(z)
    Q = jnp.zeros((m, n), z.dtype).at[0].set(q)
    alphas = jnp.zeros((m,), z.dtype)
    betas = jnp.zeros((m - 1,), z.dtype)

    def step(i, carry):
        Q, alphas, betas = carry
        q = Q[i]
        w = mv(q[:, None])[:, 0]
        alpha = jnp.dot(q, w)
        w = w - alpha * q - jnp.where(
            i > 0, betas[jnp.maximum(i - 1, 0)] * Q[jnp.maximum(i - 1, 0)], 0.0
        )
        # full reorthogonalization against the Krylov basis built so far
        # (rows past i are zero, so the masked projection is exact)
        proj = Q @ w  # (m,)
        row_ids = jnp.arange(m)
        proj = jnp.where(row_ids <= i, proj, 0.0)
        w = w - Q.T @ proj
        beta = jnp.linalg.norm(w)
        q_next = w / jnp.maximum(beta, 1e-30)
        Q = jax.lax.cond(
            i + 1 < m, lambda Q: Q.at[i + 1].set(q_next), lambda Q: Q, Q
        )
        alphas = alphas.at[i].set(alpha)
        betas = jax.lax.cond(
            i + 1 < m, lambda b: b.at[i].set(beta), lambda b: b, betas
        )
        return Q, alphas, betas

    Q, alphas, betas = jax.lax.fori_loop(0, m, step, (Q, alphas, betas))
    return alphas, betas


def rademacher(key: Array, shape, dtype) -> Array:
    return jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0).astype(
        dtype
    )


def slq_logdet(
    A,
    probes: Array,
    num_steps: int = 32,
) -> Array:
    """Stochastic Lanczos quadrature estimate of log|A| for SPD A
    ((n, n) array or callable batched matvec).

    ``probes``: (p, n) Rademacher vectors (see :func:`rademacher`); for
    each, m Lanczos steps give a tridiagonal T_j whose eigenpairs (theta,
    tau = first component of eigenvectors) form the Gauss quadrature
    e1^T log(T) e1 = sum tau^2 log(theta); logdet ~= (n/p) * sum_j of that
    (||z_j||^2 = n exactly for Rademacher).  Deterministic given probes.
    """
    n = probes.shape[-1]
    Z = probes

    def one(z):
        alphas, betas = _lanczos(A, z, num_steps)
        T = (
            jnp.diag(alphas)
            + jnp.diag(betas, 1)
            + jnp.diag(betas, -1)
        )
        theta, V = jnp.linalg.eigh(T)
        tau2 = V[0, :] ** 2
        # clip guards tiny negative Ritz values from float error; the
        # quadrature weight tau^2 of such a value is O(eps) anyway
        return jnp.sum(tau2 * jnp.log(jnp.maximum(theta, 1e-30)))

    quads = jax.vmap(one)(Z)
    return jnp.asarray(n, Z.dtype) * jnp.mean(quads)


def _maybe_precond(K, noise_diag, precond_rank):
    if precond_rank <= 0:
        return None
    return pivoted_precond(
        jax.lax.stop_gradient(K), precond_rank, jax.lax.stop_gradient(noise_diag)
    )


def _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank):
    """precond_rank > 0: preconditioned SLQ — probes_slq carries (p, n)
    standard-normal seeds for D^1/2 plus (p, rank) for L (the N(0, P)
    draw), and the quadrature runs at the PRECONDITIONED spectrum's rate
    (measured: machine-precision logdet in 10 steps on the smooth-kernel
    covariance where plain SLQ plateaus at 3e-3).  Otherwise plain SLQ
    over Rademacher probes."""
    if precond_rank > 0:
        n = K.shape[-1]
        return slq_logdet_pcg(
            K, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters
        )
    return slq_logdet(K, probes_slq, lanczos_iters)


@partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7))
def _lml_core_iterative(
    K: Array,
    y: Array,
    probes_slq: Array,  # (p, n [+ rank]) for the logdet quadrature
    probes_tr: Array,  # (n, p) for the Hutchinson trace in the backward
    noise_diag: Array,  # (n,) diagonal for the optional preconditioner
    cg_iters: int,
    lanczos_iters: int,
    precond_rank: int,
) -> Array:
    pc = _maybe_precond(K, noise_diag, precond_rank)
    alpha, _ = cg_solve(K, y, cg_iters, precond=pc)
    logdet = _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank)
    return -0.5 * (logdet + jnp.dot(y, alpha))


def _lml_iter_fwd(K, y, probes_slq, probes_tr, noise_diag,
                  cg_iters, lanczos_iters, precond_rank):
    pc = _maybe_precond(K, noise_diag, precond_rank)
    # one batched CG solves y and all trace probes together: K streams
    # from HBM once per iteration for the whole block
    X, _ = cg_solve(
        K, jnp.concatenate([y[:, None], probes_tr], axis=1), cg_iters, precond=pc
    )
    alpha, S = X[:, 0], X[:, 1:]
    logdet = _logdet_dispatch(K, pc, probes_slq, lanczos_iters, precond_rank)
    value = -0.5 * (logdet + jnp.dot(y, alpha))
    return value, (alpha, probes_tr, S)


def _lml_iter_bwd(cg_iters, lanczos_iters, precond_rank, res, g):
    alpha, Z, S = res
    n, p = Z.shape
    # tr(K^-1 dK) ~= tr(dK (1/2p)(Z S^T + S Z^T)); dK is symmetric so the
    # symmetrization is exact in expectation and halves the variance
    trace_est = (Z @ S.T + S @ Z.T) / (2.0 * p)
    Kbar = (0.5 * g) * (jnp.outer(alpha, alpha) - trace_est)
    ybar = -g * alpha
    # probes and the preconditioner diagonal are constants of the
    # estimator: zero cotangents (probes_slq carries rank extra seed
    # columns in the preconditioned form)
    zbar_slq = jnp.zeros((p, n + max(precond_rank, 0)), Z.dtype)
    return Kbar, ybar, zbar_slq, jnp.zeros_like(Z), jnp.zeros((n,), Z.dtype)


_lml_core_iterative.defvjp(_lml_iter_fwd, _lml_iter_bwd)


def lml_core_iterative(
    K: Array,
    y: Array,
    key: Array,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    noise_diag: Array | float | None = None,
) -> Array:
    """-1/2 (log|K| + y^T K^-1 y) without factorizing K.

    The iterative counterpart of ops/linalg.lml_core: CG for the solve,
    SLQ for the logdet, and a custom VJP whose stochastic trace term
    reuses the probe solves — see the module docstring for the exact
    value/gradient estimator contract.  The (n/2)log2pi constant lives in
    the GP layer, as for lml_core.

    ``precond_rank > 0`` runs the solves as PCG with the rank-k pivoted-
    Cholesky Woodbury preconditioner (:func:`pivoted_precond`); pass the
    covariance's noise/jitter diagonal as ``noise_diag`` (scalar or (n,)).
    The logdet quadrature stays unpreconditioned (GPyTorch-style
    preconditioned SLQ is future work); the preconditioner only
    accelerates the solves, it never changes what they converge to.
    """
    n = K.shape[-1]
    if precond_rank > 0 and noise_diag is None:
        raise ValueError("precond_rank > 0 needs the covariance noise_diag")
    nd = jnp.broadcast_to(
        jnp.asarray(0.0 if noise_diag is None else noise_diag, K.dtype), (n,)
    )
    k1, k2 = jax.random.split(jnp.asarray(key))
    if precond_rank > 0:
        # N(0, P) probe seeds for the preconditioned quadrature
        probes_slq = jax.random.normal(
            k1, (num_probes, n + precond_rank), K.dtype
        )
    else:
        probes_slq = rademacher(k1, (num_probes, n), K.dtype)
    probes_tr = rademacher(k2, (n, num_probes), K.dtype)
    return _lml_core_iterative(
        K, y, probes_slq, probes_tr, nd, cg_iters, lanczos_iters, precond_rank
    )


# ---------------------------------------------------------------------------
# Row-sharded form: the distributed story of the iterative path.
#
# Where the blocked distributed Cholesky (ops/distributed.py) needs a
# pipelined panel factorization with per-step tile broadcasts, the iterative
# path distributes through ONE primitive: the covariance matvec.  Each
# device holds its block-rows K_rows (n_local, n) — ordered by
# lax.axis_index, the ops/distributed convention — computes its shard of
# each product, and one tiled all_gather (n x k floats) replicates the
# result for the next recurrence.  CG/Lanczos control flow is replicated.
# ---------------------------------------------------------------------------


def _rows_mv_and_precond(K_rows, noise_diag, axis, precond_rank):
    """The row-sharded matvec, plus (optionally) the pivoted-Cholesky
    preconditioner built WITHOUT a dense K: column i of K is this device's
    local column slice all_gathered (axis-index row order), the diagonal
    likewise — ``rank`` gathers of (n,) floats total.  Every device builds
    the identical (replicated) preconditioner, so PCG/quadrature control
    flow stays replicated."""

    def mv(V):
        return jax.lax.all_gather(K_rows @ V, axis, tiled=True)

    if precond_rank <= 0:
        return mv, None
    Kr = jax.lax.stop_gradient(K_rows)
    n_local = Kr.shape[0]
    row0 = jax.lax.axis_index(axis) * n_local
    local_ids = jnp.arange(n_local)
    local_diag = jnp.take_along_axis(
        Kr, (row0 + local_ids)[:, None], axis=1
    )[:, 0]
    diag = jax.lax.all_gather(local_diag, axis, tiled=True)

    def col_fn(i):
        return jax.lax.all_gather(jnp.take(Kr, i, axis=1), axis, tiled=True)

    pc = pivoted_precond_cols(
        col_fn, diag, precond_rank, jax.lax.stop_gradient(noise_diag)
    )
    return mv, pc


def _rows_logdet(mv, pc, probes_slq, lanczos_iters, precond_rank, n):
    if precond_rank > 0:
        return slq_logdet_pcg(
            mv, pc, probes_slq[:, :n], probes_slq[:, n:], lanczos_iters
        )
    return slq_logdet(mv, probes_slq, lanczos_iters)


@partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8))
def _lml_core_iter_rows(
    K_rows: Array,
    y: Array,
    probes_slq: Array,
    probes_tr: Array,
    noise_diag: Array,
    axis: str,
    cg_iters: int,
    lanczos_iters: int,
    precond_rank: int,
) -> Array:
    mv, pc = _rows_mv_and_precond(K_rows, noise_diag, axis, precond_rank)
    alpha, _ = cg_solve(mv, y, cg_iters, precond=pc)
    logdet = _rows_logdet(mv, pc, probes_slq, lanczos_iters, precond_rank, y.shape[0])
    return -0.5 * (logdet + jnp.dot(y, alpha))


def _lml_rows_fwd(K_rows, y, probes_slq, probes_tr, noise_diag,
                  axis, cg_iters, lanczos_iters, precond_rank):
    mv, pc = _rows_mv_and_precond(K_rows, noise_diag, axis, precond_rank)
    X, _ = cg_solve(
        mv, jnp.concatenate([y[:, None], probes_tr], axis=1), cg_iters, precond=pc
    )
    alpha, S = X[:, 0], X[:, 1:]
    logdet = _rows_logdet(mv, pc, probes_slq, lanczos_iters, precond_rank, y.shape[0])
    value = -0.5 * (logdet + jnp.dot(y, alpha))
    return value, (alpha, probes_tr, S)


def _lml_rows_bwd(axis, cg_iters, lanczos_iters, precond_rank, res, g):
    alpha, Z, S = res
    p = Z.shape[1]
    n_local = None  # resolved from the cotangent row count below

    # this device's row block of the (replicated) estimator matrices: the
    # cotangent K_rows-bar has shape (n_local, n), so slice alpha/Z/S rows
    # at the device's offset — lax.axis_index is available because the
    # backward runs inside the same shard_map region as the forward
    def rows_of(v, n_local):
        row0 = jax.lax.axis_index(axis) * n_local
        return jax.lax.dynamic_slice_in_dim(v, row0, n_local, 0)

    n = alpha.shape[0]
    n_local = n // jax.lax.axis_size(axis)
    a_rows = rows_of(alpha, n_local)
    Z_rows = rows_of(Z, n_local)
    S_rows = rows_of(S, n_local)
    trace_rows = (Z_rows @ S.T + S_rows @ Z.T) / (2.0 * p)
    Kbar_rows = (0.5 * g) * (jnp.outer(a_rows, alpha) - trace_rows)
    ybar = -g * alpha
    # preconditioned probes carry rank extra N(0,1) seed columns; the
    # probes and the preconditioner diagonal are estimator constants
    zbar_slq = jnp.zeros((p, n + max(precond_rank, 0)), Z.dtype)
    return Kbar_rows, ybar, zbar_slq, jnp.zeros_like(Z), jnp.zeros((n,), Z.dtype)


_lml_core_iter_rows.defvjp(_lml_rows_fwd, _lml_rows_bwd)


def lml_rowsharded_iterative(
    K_rows: Array,
    y: Array,
    key: Array,
    axis: str,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    noise_diag: Array | float | None = None,
) -> Array:
    """Row-sharded matrix-free LML core: ``K_rows`` (n_local, n) is this
    device's block of the covariance (axis-index row order), ``y`` the
    replicated full observation vector; returns the replicated estimate of
    -1/2 (log|K| + y^T K^-1 y).  Same estimator contract as
    :func:`lml_core_iterative` — identical probes (same key on every
    device) make the sharded value match the dense one up to float
    reassociation of the gathered matvecs.  The backward yields this
    device's rows of Kbar; pair with parallel.large_n.psum_grads for the
    complete theta gradient.

    ``precond_rank > 0`` enables the pivoted-Cholesky preconditioner for
    the solves and the preconditioned SLQ quadrature for the logdet,
    built matrix-free from all_gathered column slices (rank (n,)-float
    gathers); pass the covariance's noise/jitter diagonal (full (n,),
    replicated) as ``noise_diag``.  Same probe layout as the dense
    lml_core_iterative, so the same key reproduces its estimate.
    """
    n = y.shape[0]
    k1, k2 = jax.random.split(jnp.asarray(key))
    if precond_rank > 0:
        if noise_diag is None:
            raise ValueError("precond_rank > 0 needs the covariance noise_diag")
        probes_slq = jax.random.normal(
            k1, (num_probes, n + precond_rank), K_rows.dtype
        )
        nd = jnp.broadcast_to(jnp.asarray(noise_diag, K_rows.dtype), (n,))
    else:
        probes_slq = rademacher(k1, (num_probes, n), K_rows.dtype)
        nd = jnp.zeros((n,), K_rows.dtype)
    probes_tr = rademacher(k2, (n, num_probes), K_rows.dtype)
    return _lml_core_iter_rows(
        K_rows, y, probes_slq, probes_tr, nd, axis,
        cg_iters, lanczos_iters, precond_rank
    )


# ---------------------------------------------------------------------------
# Matrix-free form: K is never materialized at all.
#
# The iterative path above still stores K (n, n) and streams it from HBM —
# 4 GB at n=32768.  Rematerializing
# instead is the accelerator-shaped trade: a stationary kernel entry costs a few
# flops while an f32 read costs 4 bytes of bandwidth, so computing each
# (panel, n) block of K on the fly inside every matvec is roughly as fast
# as reading it and needs O(panel * n) memory — n is then bounded by
# compute, not HBM.  The theta gradient never forms Kbar (n, n) either:
# with the CG solutions frozen, d lml = g/2 * d/dtheta [ a^T K(theta) a
# - mean_j s_j^T K(theta) z_j ], a scalar function evaluated panel-wise
# and differentiated by jax.grad.
# ---------------------------------------------------------------------------


def _panel_rows(cov_rows_fn, row0: Array, panel: int, n: int):
    """Rows [row0, row0+panel) of the implicit matrix via the caller's
    ``cov_rows_fn(row0, panel) -> (panel, n)``."""
    return cov_rows_fn(row0, panel)


def matfree_matvec(cov_rows_fn, n: int, panel: int):
    """Batched matvec V -> K V with K produced panel-by-panel.

    ``cov_rows_fn(row0) -> (panel, n)``: rows of K starting at static-size
    panels (n % panel == 0).  The loop is a lax.map over panel starts —
    sequential, constant memory, each step one (panel, n) x (n, k)
    matmul fused with the kernel evaluation that produced the rows.
    """
    if n % panel != 0:
        raise ValueError(f"n={n} not divisible by panel={panel}")
    starts = jnp.arange(0, n, panel)

    def mv(V):
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]

        def one(row0):
            return cov_rows_fn(row0) @ V  # (panel, k)

        out = jax.lax.map(one, starts)  # (n/panel, panel, k)
        out = out.reshape(n, V.shape[1])
        return out[:, 0] if squeeze else out

    return mv


def lml_matfree(
    cov_rows_fn,
    y: Array,
    key: Array,
    panel: int = 1024,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    cov_col_fn=None,
    cov_diag: Array | None = None,
    noise_diag: Array | float | None = None,
):
    """Matrix-free -1/2 (log|K| + y^T K^-1 y) plus the ingredients for the
    caller's gradient: returns (value, aux) where aux = (alpha, Z, S).

    ``cov_rows_fn(row0) -> (panel, n)`` produces rows of K; it may close
    over hyperparameters — differentiate the VALUE through
    :func:`matfree_quadratic_forms` with the aux frozen (see
    gp.core.lml_iterative_matfree for the packaged custom-VJP form).

    ``precond_rank > 0`` runs the solves as PCG and the logdet as
    preconditioned SLQ with the rank-k pivoted-Cholesky preconditioner
    built matrix-free from ``cov_col_fn(i) -> (n,)`` (column i of K),
    ``cov_diag`` (its (n,) diagonal) and ``noise_diag`` — rank column
    evaluations, never a dense K.  Same probe layout as the dense
    lml_core_iterative (N(0, P) seeds for the quadrature), so with the
    same key the two paths agree up to matvec reassociation.  The
    preconditioner is an estimator constant (stop_gradient), exactly as
    in the dense path.
    """
    n = y.shape[0]
    mv = matfree_matvec(cov_rows_fn, n, panel)
    k1, k2 = jax.random.split(jnp.asarray(key))
    pc = None
    if precond_rank > 0:
        if cov_col_fn is None or cov_diag is None or noise_diag is None:
            raise ValueError(
                "precond_rank > 0 needs cov_col_fn, cov_diag and noise_diag"
            )
        pc = pivoted_precond_cols(
            lambda i: jax.lax.stop_gradient(cov_col_fn(i)),
            jax.lax.stop_gradient(jnp.asarray(cov_diag, y.dtype)),
            precond_rank,
            jax.lax.stop_gradient(
                jnp.broadcast_to(jnp.asarray(noise_diag, y.dtype), (n,))
            ),
        )
        probes_slq = jax.random.normal(k1, (num_probes, n + precond_rank), y.dtype)
    else:
        probes_slq = rademacher(k1, (num_probes, n), y.dtype)
    probes_tr = rademacher(k2, (n, num_probes), y.dtype)
    X, _ = cg_solve(
        mv, jnp.concatenate([y[:, None], probes_tr], axis=1), cg_iters, precond=pc
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


def matfree_quadratic_forms(cov_rows_fn, n: int, panel: int,
                            alpha: Array, Z: Array, S: Array) -> Array:
    """h = alpha^T K alpha - (1/2p) tr(Z S^T K + S Z^T K), panel-wise.

    d lml = g/2 * dh/dtheta with (alpha, Z, S) held fixed — the matrix-
    free equivalent of pairing Kbar = g/2 (aa^T - sym(ZS^T)/p) against dK
    without ever forming either (n, n) matrix.  Differentiate this scalar
    w.r.t. whatever ``cov_rows_fn`` closes over.
    """
    if n % panel != 0:
        raise ValueError(f"n={n} not divisible by panel={panel}")
    starts = jnp.arange(0, n, panel)
    p = Z.shape[1]

    # checkpoint is what keeps this matrix-free under differentiation:
    # without it, jax.grad through the lax.map saves every panel's
    # (panel, n) rows as residuals — the entire K, several times over
    # (measured 71 GB at n=65536/panel=4096).  Rematerializing the rows in
    # the backward holds memory at O(panel * n), the module's contract.
    @jax.checkpoint
    def one(row0):
        rows = cov_rows_fn(row0)  # (panel, n)
        a_rows = jax.lax.dynamic_slice_in_dim(alpha, row0, panel)
        Z_rows = jax.lax.dynamic_slice_in_dim(Z, row0, panel, 0)
        S_rows = jax.lax.dynamic_slice_in_dim(S, row0, panel, 0)
        quad = a_rows @ (rows @ alpha)
        # symmetrized trace estimate, same form as the dense backward
        tr = 0.5 * (jnp.sum(Z_rows * (rows @ S)) + jnp.sum(S_rows * (rows @ Z)))
        return quad - tr / p

    vals = jax.lax.map(one, starts)
    return jnp.sum(vals)


# ---------------------------------------------------------------------------
# Preconditioned SLQ (GPyTorch App. C / Gardner et al. 2018): the plain
# quadrature needs Lanczos steps ~ sqrt(cond); with P = L L^T + D capturing
# the covariance's fast-decaying spectrum,
#
#     log|K| = log|P| + logdet(P^-1/2 K P^-1/2),
#
# log|P| is analytic (Woodbury determinant) and the remaining factor has
# cond(P^-1 K) ~ small.  Its quadrature comes FREE from PCG: the CG
# coefficients (alpha_k, beta_k) of the solve K x = z with preconditioner P
# rebuild the Lanczos tridiagonal of the preconditioned operator, and
# probes z ~ N(0, P) (cheap to sample through L and D) with weights
# z^T P^-1 z make the estimator unbiased.
# ---------------------------------------------------------------------------


def cg_coefficients(A, B: Array, num_steps: int, precond=None):
    """Run exactly ``num_steps`` (P)CG iterations on A X = B, returning
    (X, alphas (m, k), betas (m, k)) — the recurrence coefficients that
    rebuild the Lanczos tridiagonal of the (preconditioned) operator.

    Converged columns freeze: their trailing alphas are marked 0 (the
    tridiagonal builder decouples those steps).  Fixed-length scan (no
    early exit) so the coefficient arrays have static shape.
    """
    mv = _as_matvec(A)
    pc = (lambda V: V) if precond is None else precond
    X0 = jnp.zeros_like(B)
    R0 = B
    Z0 = pc(B)
    P0 = Z0
    rz0 = jnp.sum(R0 * Z0, axis=0)
    rr_scale = jnp.maximum(jnp.sum(B * B, axis=0), 1e-30)

    def step(carry, _):
        X, R, P, rz = carry
        AP = mv(P)
        denom = jnp.sum(P * AP, axis=0)
        rr = jnp.sum(R * R, axis=0)
        active = (rr > 1e-24 * rr_scale) & (denom > 0.0)
        alpha = jnp.where(active, rz / jnp.maximum(denom, 1e-30), 0.0)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = pc(R)
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(active, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        P = Z + beta[None, :] * P
        return (X, R, P, rz_new), (alpha, beta)

    (X, _, _, _), (alphas, betas) = jax.lax.scan(
        step, (X0, R0, P0, rz0), None, length=num_steps
    )
    return X, alphas, betas


def _tridiag_from_cg(alphas: Array, betas: Array) -> Array:
    """Lanczos tridiagonal from one column's CG coefficients:
    T[0,0] = 1/alpha_0;  T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1};
    T[k,k-1] = sqrt(beta_{k-1})/alpha_{k-1}.  Steps where CG had frozen
    (alpha == 0) become decoupled identity rows (diag 1, offdiag 0), which
    the e1 quadrature cannot see."""
    m = alphas.shape[0]
    live = alphas > 0.0
    inv_a = jnp.where(live, 1.0 / jnp.maximum(alphas, 1e-30), 0.0)
    diag0 = inv_a[0]
    prev_live = live[:-1] & live[1:]
    diag_rest = jnp.where(
        live[1:], inv_a[1:] + jnp.where(prev_live, betas[:-1] * inv_a[:-1], 0.0), 1.0
    )
    diag = jnp.concatenate([jnp.where(live[0], diag0, 1.0)[None], diag_rest])
    off = jnp.where(prev_live, jnp.sqrt(jnp.maximum(betas[:-1], 0.0)) * inv_a[:-1], 0.0)
    return jnp.diag(diag) + jnp.diag(off, 1) + jnp.diag(off, -1)


def slq_logdet_pcg(
    A,
    precond,
    eps_n: Array,
    eps_r: Array,
    num_steps: int = 32,
) -> Array:
    """log|K| via preconditioned SLQ.

    ``precond``: a :class:`PivotedPrecond` (apply/sample/logdet);
    ``eps_n`` (p, n) and ``eps_r`` (p, rank): standard-normal seeds from
    which probes z = D^1/2 eps_n + L eps_r ~ N(0, P) are formed.  Returns
    log|P| + (1/p) sum_j (z_j^T P^-1 z_j) * e1^T log(T_j) e1 with T_j from
    the PCG coefficients of K x = z_j — unbiased for log|K|, with the
    quadrature converging at the PRECONDITIONED spectrum's rate.
    """
    Z = precond.sample(eps_n, eps_r)  # (n, p)
    _, alphas, betas = cg_coefficients(A, Z, num_steps, precond=precond)
    PinvZ = precond(Z)
    weights = jnp.sum(Z * PinvZ, axis=0)  # (p,)

    def one(a_col, b_col):
        T = _tridiag_from_cg(a_col, b_col)
        theta, V = jnp.linalg.eigh(T)
        tau2 = V[0, :] ** 2
        return jnp.sum(tau2 * jnp.log(jnp.maximum(theta, 1e-30)))

    quads = jax.vmap(one, in_axes=(1, 1))(alphas, betas)
    return precond.logdet + jnp.mean(weights * quads)
