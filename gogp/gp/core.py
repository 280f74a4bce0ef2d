"""GP core: covariance assembly, log marginal likelihood, prediction.

Functional counterpart of reference gp/gp.go.  The reference's mutable ``GP``
struct with cached Cholesky state (gp/gp.go:20-38) becomes:

- an immutable :class:`GP` *spec* (dimensions + kernels), and
- an immutable :class:`Posterior` pytree (theta, X, y, L, alpha) — the
  explicit version of the reference's "Produce works off stored fields"
  contract (gp/gp.go:255-257), trivially checkpointable.

Everything is pure and jit/vmap/grad-safe.  The analytic gradient machinery
of gp/gp.go:418-499 (per-theta dK matrices, trace identities) does not exist
here — ``jax.grad`` of :func:`lml` computes the same thing via one reverse
pass through Cholesky, turning the reference's O(p·n³) gradient loop into
O(n³ + p·n²).

Padding/masking: all shapes are static.  A boolean/0-1 ``mask`` marks which
of the n rows are real observations; padded rows contribute identity
rows/cols to K and zeros to y, so LML, gradients and predictions are exactly
those of the unpadded problem.  This is what lets the rolling-forecast loop
(reference tutorial/tutorial.go:91: one refit per prefix length, serially)
compile once and vmap over all prefix lengths at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gogp.kernels.base import Kernel, NoiseKernel
from gogp.kernels.noise import constant_noise
from gogp.ops import linalg

Array = jax.Array

_LOG_2PI = 1.8378770664093453

# Default noise std, present for numerical stability; zero it by passing
# constant_noise(0.) explicitly — reference gp/gp.go:40-47 (nonoise = 1e-5,
# squared to variance 1e-10 by kernel/noise.go:27-30).
DEFAULT_NOISE_STD = 1e-5


@dataclasses.dataclass(frozen=True)
class GP:
    """GP spec: input dimensionality + similarity and noise kernels.

    Mirrors the configuration part of the reference GP struct
    (gp/gp.go:20-27); data and cached factors live in :class:`Posterior`.
    """

    ndim: int
    simil: Kernel
    noise: NoiseKernel | None = None

    def __post_init__(self):
        if self.noise is None:
            object.__setattr__(self, "noise", constant_noise(DEFAULT_NOISE_STD))

    @property
    def n_theta_simil(self) -> int:
        return self.simil.n_theta

    @property
    def n_theta_noise(self) -> int:
        return self.noise.n_theta

    @property
    def n_theta(self) -> int:
        return self.simil.n_theta + self.noise.n_theta


class Posterior(NamedTuple):
    """Immutable fitted-GP state: everything ``predict`` needs.

    The explicit pytree form of the reference's cached fields
    ThetaSimil/ThetaNoise/X/L/Alpha (gp/gp.go:24-37, contract at :255-257).
    Orbax-checkpointable as-is.
    """

    theta_simil: Array  # (n_theta_simil,) natural scale
    theta_noise: Array  # (n_theta_noise,) natural scale
    x: Array  # (n, ndim)
    y: Array  # (n,)
    chol: Array  # (n, n) lower Cholesky factor of K
    alpha: Array  # (n,) K^{-1} y
    mask: Array  # (n,) 1.0 for real observations, 0.0 for padding


def _as_xy(gp: GP, x, y):
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    y = jnp.asarray(y)
    return x, y


def masked_cov(gp: GP, theta_simil, theta_noise, x: Array, mask: Array | None) -> Array:
    """Covariance matrix with noise on the diagonal (gp/gp.go:106-156).

    K[i,j] = simil(theta_s, x_i, x_j) + delta_ij * noise(theta_n, x_j).
    Padded rows/cols are replaced by identity rows so downstream Cholesky /
    solves behave as if they weren't there.

    Diagonal terms are applied with a broadcasted-iota equality mask, NOT
    ``jnp.diag``: the elementwise form fuses into the kernel evaluation,
    where the scatter that diag lowers to would be a separate pass.
    """
    n = x.shape[0]
    k = gp.simil.matrix(theta_simil, x, x)
    eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (n, n), 1
    )
    noise = gp.noise.vector(theta_noise, x)
    k = jnp.where(eye, k + noise[None, :], k)
    if mask is not None:
        m = mask.astype(k.dtype)
        outer = m[:, None] * m[None, :]
        k = k * outer + jnp.where(eye, 1.0 - m[None, :], 0.0)
    return k


def absorb(gp: GP, theta_simil, theta_noise, x, y, mask=None, robust: bool = False) -> Posterior:
    """Factorize K and solve for alpha — reference ``Absorb``/``absorb``
    (gp/gp.go:80-241) without the gradient side-channel (jax.grad replaces it).

    ``robust=True`` retries a failed factorization with escalating diagonal
    jitter (linalg.cholesky_with_jitter) instead of propagating NaNs — the
    jit-compatible version of the reference's hard Cholesky error
    (gp/gp.go:228-230).
    """
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    y = y * mask
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    if robust:
        L, _ = linalg.cholesky_with_jitter(K)
    else:
        L = linalg.cholesky(K)
    alpha = linalg.cho_solve_vec(L, y)
    return Posterior(theta_simil, theta_noise, x, y, L, alpha, mask)


def lml_from_posterior(post: Posterior) -> Array:
    """GPML eq. 5.8 — reference ``LML`` (gp/gp.go:244-253):
    L = -(n/2) log 2pi - 1/2 log|K| - 1/2 y^T alpha; 0 with no data."""
    n_eff = jnp.sum(post.mask)
    logdet = linalg.logdet_from_chol(post.chol, post.mask)
    quad = jnp.dot(post.y, post.alpha)
    return -0.5 * (n_eff * _LOG_2PI + logdet + quad)


def lml(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> Array:
    """Log marginal likelihood at natural-scale hyperparameters.

    Unlike :func:`absorb` + :func:`lml_from_posterior`, this routes the
    factorize/solve/logdet core through ``linalg.lml_core`` and its analytic
    GPML-5.9 pullback, the hot path of every optimizer and sampler step.
    Padded rows are identity rows in K and zeros in y, so they contribute
    nothing to the core; only the 2pi constant needs the explicit mask
    count.
    """
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    y = y * mask
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    n_eff = jnp.sum(mask)
    return -0.5 * n_eff * _LOG_2PI + linalg.lml_core(K, y)


def lml_iterative(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    key,
    mask=None,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
) -> Array:
    """Matrix-free LML: the :func:`lml` protocol routed through CG solves
    and stochastic-Lanczos-quadrature logdet instead of a factorization
    (ops/iterative — O(n^2) per CG step, ~0.5% value error and 1-3%
    theta-gradient error at default probe counts; see its module
    docstring for the estimator contract).  For the very-large-n regime
    where the O(n^3) exact path or its compile cost dominates.  Padded
    rows are identity rows in K and zeros in y, exactly as for the exact
    core, so only the 2pi constant needs the mask count.

    ``precond_rank > 0`` enables the pivoted-Cholesky PCG preconditioner
    for the solves, with the noise diagonal taken from the GP's own noise
    kernel — the ill-conditioned regime (optimized lengthscale, small
    noise) is where it earns its O(n rank^2) setup.
    """
    from gogp.ops.iterative import lml_core_iterative

    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    y = y * mask
    K = masked_cov(gp, theta_simil, theta_noise, x, mask)
    n_eff = jnp.sum(mask)
    noise_diag = None
    if precond_rank > 0:
        # padded rows carry identity diagonals in K; the preconditioner's
        # D must match what the matrix actually has there
        noise_diag = gp.noise.vector(theta_noise, x) * mask + (1.0 - mask)
    return -0.5 * n_eff * _LOG_2PI + lml_core_iterative(
        K, y, key, num_probes, cg_iters, lanczos_iters, precond_rank, noise_diag
    )


def _cov_rows_fn(gp: GP, theta_simil, theta_noise, x, mask, panel: int):
    """Rows [row0, row0+panel) of masked_cov, built on the fly — the
    panel-rematerialized form of the same assembly (noise + identity rows
    via broadcasted-iota, never scatters)."""
    n = x.shape[0]

    def rows_at(row0):
        x_p = jax.lax.dynamic_slice_in_dim(x, row0, panel, 0)
        m_p = jax.lax.dynamic_slice_in_dim(mask, row0, panel, 0)
        rows = gp.simil.matrix(theta_simil, x_p, x)  # (panel, n)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (panel, n), 1)
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (panel, n), 0) + row0
        eye = col_ids == row_ids
        noise = gp.noise.vector(theta_noise, x_p)
        rows = jnp.where(eye, rows + noise[:, None], rows)
        rows = rows * (m_p[:, None] * mask[None, :])
        rows = jnp.where(eye, rows + (1.0 - m_p[:, None]), rows)
        return rows

    return rows_at


def _cov_col_fn(gp: GP, theta_simil, theta_noise, x, mask):
    """Column i of masked_cov, built on the fly — one (n,) kernel-column
    evaluation (the matrix-free preconditioner's unit of work: rank
    columns total, never a dense K)."""
    n = x.shape[0]

    def col_at(i):
        xi = jax.lax.dynamic_slice_in_dim(x, i, 1, 0)  # (1, d)
        col = gp.simil.matrix(theta_simil, x, xi)[:, 0]  # (n,)
        ei = (jnp.arange(n) == i).astype(col.dtype)
        col = col + gp.noise.vector(theta_noise, xi)[0] * ei
        mi = jax.lax.dynamic_slice_in_dim(mask, i, 1, 0)[0]
        col = col * (mask * mi)
        return col + (1.0 - mi) * ei

    return col_at


def _cov_diag(gp: GP, theta_simil, theta_noise, x, mask):
    """Diagonal of masked_cov: simil diag + noise where live, 1 where
    padded (identity rows)."""
    d = gp.simil.diag_matrix(theta_simil, x) + gp.noise.vector(theta_noise, x)
    return d * mask + (1.0 - mask)


def lml_iterative_matfree(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    key,
    mask=None,
    panel: int = 1024,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
) -> Array:
    """Matrix-free LML with K never materialized: O(panel * n) memory.

    :func:`lml_iterative` stores K (n, n); this form rematerializes each
    (panel, n) block inside every CG/Lanczos matvec — a stationary kernel
    entry costs a few flops while an f32 HBM read costs 4 bytes, so on an
    accelerator recomputing beats storing and n is bounded by compute, not
    HBM (the dense iterative path stores the 4 GB covariance at n=32768).  The theta gradient differentiates the quadratic-forms
    scalar with the CG solutions frozen (ops.iterative.
    matfree_quadratic_forms), so no (n, n) object exists in the backward
    either.  Same estimator contract (and same probes, given the same
    key) as :func:`lml_iterative`.

    ``precond_rank > 0`` enables the pivoted-Cholesky PCG + preconditioned
    SLQ, with the preconditioner itself built matrix-free from
    ``precond_rank`` kernel-column evaluations (:func:`_cov_col_fn`) and
    the GP's own noise diagonal — the full ill-conditioned-regime rescue
    of :func:`lml_iterative` without ever materializing K.
    """
    from gogp.ops import iterative

    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    y = y * mask

    def _pc_kwargs(ts, tn):
        if precond_rank <= 0:
            return {}
        return dict(
            precond_rank=precond_rank,
            cov_col_fn=_cov_col_fn(gp, ts, tn, x, mask),
            cov_diag=_cov_diag(gp, ts, tn, x, mask),
            noise_diag=gp.noise.vector(tn, x) * mask + (1.0 - mask),
        )

    @jax.custom_vjp
    def core(ts, tn, yv):
        rows_fn = _cov_rows_fn(gp, ts, tn, x, mask, panel)
        value, _ = iterative.lml_matfree(
            rows_fn, yv, key, panel, num_probes, cg_iters, lanczos_iters,
            **_pc_kwargs(ts, tn),
        )
        return value

    def fwd(ts, tn, yv):
        rows_fn = _cov_rows_fn(gp, ts, tn, x, mask, panel)
        value, aux = iterative.lml_matfree(
            rows_fn, yv, key, panel, num_probes, cg_iters, lanczos_iters,
            **_pc_kwargs(ts, tn),
        )
        return value, (ts, tn, aux)

    def bwd(res, g):
        ts, tn, (alpha, Z, S) = res

        def h(ts_, tn_):
            rows_fn = _cov_rows_fn(gp, ts_, tn_, x, mask, panel)
            return iterative.matfree_quadratic_forms(
                rows_fn, n, panel, alpha, Z, S
            )

        gts, gtn = jax.grad(h, argnums=(0, 1))(ts, tn)
        return (0.5 * g) * gts, (0.5 * g) * gtn, -g * alpha

    core.defvjp(fwd, bwd)
    n_eff = jnp.sum(mask)
    return -0.5 * n_eff * _LOG_2PI + core(theta_simil, theta_noise, y)


def lml_toeplitz(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    key,
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    grid_rtol: float = 1e-4,
) -> Array:
    """LML for 1-D inputs on a REGULAR grid: O(n log n) per CG step.

    On a regular grid a stationary kernel's covariance is symmetric
    Toeplitz — one length-n first column instead of an (n, n) matrix —
    and every solve/quadrature matvec runs as an FFT circulant product
    (ops/toeplitz module docstring).  This is the time-series regime the
    reference actually lives in (every tutorial dataset is a 1-D series);
    at large n it is the cheapest path in the framework by an asymptotic
    factor (the matrix-free panel path pays O(n^2) per matvec).

    Same estimator contract as :func:`lml_iterative` (value error
    ~1/sqrt(probes); theta gradient via frozen-solution quadratic forms);
    ``precond_rank > 0`` enables pivoted-Cholesky PCG + preconditioned
    SLQ built from O(rank) column gathers.

    Constraints: 1-D inputs on a regular grid (spacing checked host-side
    up to ``grid_rtol``; pass presorted x), homoscedastic noise (the
    noise kernel is evaluated at x[0] and must be input-independent),
    no padding mask.
    """
    from gogp.ops import toeplitz as tz

    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError("lml_toeplitz needs 1-D inputs on a regular grid")
    # host-side regularity check; under jit the inputs are traced (any op
    # on even a constant stages out a tracer) and the caller owns the grid
    # contract — the check runs wherever x is concretely available
    import numpy as _np

    try:
        xs = _np.asarray(x)[:, 0]
    except jax.errors.TracerArrayConversionError:
        xs = None
    if xs is not None:
        steps = _np.diff(xs)
        # floor the tolerance at the grid's own representable resolution:
        # an f32 linspace carries ulp-level spacing jitter ~eps * max|x|
        eps = float(_np.finfo(xs.dtype).eps) if xs.dtype.kind == "f" else 0.0
        tol = max(
            grid_rtol * float(_np.mean(_np.abs(steps))) if steps.size else 0.0,
            8.0 * eps * float(_np.max(_np.abs(xs))) if xs.size else 0.0,
            1e-30,
        )
        if steps.size and (_np.max(steps) - _np.min(steps) > tol):
            raise ValueError(
                "lml_toeplitz needs equally spaced inputs "
                f"(spacing range [{steps.min():.3g}, {steps.max():.3g}]); "
                "use lml_iterative/lml for irregular designs"
            )
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)

    def c_of(ts, tn):
        # first column: k(x_0, x_i) + noise variance at lag 0
        col = gp.simil.matrix(ts, x, x[:1])[:, 0]  # (n,)
        e0 = (jnp.arange(n) == 0).astype(col.dtype)
        return col + gp.noise.vector(tn, x[:1])[0] * e0

    noise_var = gp.noise.vector(theta_noise, x[:1])[0] if precond_rank > 0 else None

    @jax.custom_vjp
    def core(ts, tn, yv):
        value, _ = tz.lml_toeplitz_core(
            lambda: c_of(ts, tn), yv, key, num_probes, cg_iters,
            lanczos_iters, precond_rank, noise_var,
        )
        return value

    def fwd(ts, tn, yv):
        value, aux = tz.lml_toeplitz_core(
            lambda: c_of(ts, tn), yv, key, num_probes, cg_iters,
            lanczos_iters, precond_rank, noise_var,
        )
        return value, (ts, tn, aux)

    def bwd(res, g):
        ts, tn, (alpha, Z, S) = res

        def h(ts_, tn_):
            return tz.toeplitz_quadratic_forms(
                lambda: c_of(ts_, tn_), alpha, Z, S
            )

        gts, gtn = jax.grad(h, argnums=(0, 1))(ts, tn)
        return (0.5 * g) * gts, (0.5 * g) * gtn, -g * alpha

    core.defvjp(fwd, bwd)
    return -0.5 * n * _LOG_2PI + core(theta_simil, theta_noise, y)


def predict_from_posterior(gp: GP, post: Posterior, z) -> tuple[Array, Array]:
    """Posterior mean and std at test inputs ``z`` — reference ``Produce``
    (gp/gp.go:258-360), with its exact semantics:

    - prior variance from the similarity kernel only, *no noise added*
      (gp/gp.go:270-278): predictive bands are for the noise-free latent f;
    - mu = Kstar^T alpha (:335);
    - sigma_i = sqrt(k(z_i,z_i) - [Kstar^T K^{-1} Kstar]_ii) (:349-357).

    Where the reference materializes the full m×m predictive covariance and
    reads its diagonal (:337-342), this computes diag(Kstar^T K^{-1} Kstar)
    as squared column norms of the single triangular solve L^{-1} Kstar —
    one TRSM + an elementwise square-reduce that XLA fuses.
    With no (real) observations: mu = 0, sigma = prior std (:343-347).
    """
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    prior_var = gp.simil.diag_matrix(post.theta_simil, z)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z)  # (n, m)
    kstar = kstar * post.mask[:, None]
    mu = kstar.T @ post.alpha
    v = linalg.trsm_lower(post.chol, kstar)  # (n, m)
    cov_diag = jnp.sum(v * v, axis=0)
    var = prior_var - cov_diag
    # Exact arithmetic keeps var >= 0; clamp float error so interpolation at
    # observed points (golden case "self", gp/gp_test.go:38-49) yields 0.
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    return mu, sigma


def predict_y_from_posterior(gp: GP, post: Posterior, z) -> tuple[Array, Array]:
    """Predictive mean/std of the OBSERVATION y* — noise-inclusive bands.

    The reference's ``Produce`` deliberately excludes observation noise
    (latent-function bands, gp/gp.go:270-278) and
    :func:`predict_from_posterior` keeps that contract bit-for-bit.  This
    is the forecast-interval variant a production consumer usually wants:

        sigma_y(z)^2 = sigma_f(z)^2 + noise_var(z)

    with the noise variance from the GP's own noise kernel evaluated at
    the TEST inputs (heteroscedastic noise kernels supported — the same
    diagonal ``absorb`` put into K at the training inputs)."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    mu, sigma = predict_from_posterior(gp, post, z)
    nv = gp.noise.vector(post.theta_noise, z)
    return mu, jnp.sqrt(sigma * sigma + nv)


def predict(gp: GP, theta_simil, theta_noise, x, y, z, mask=None) -> tuple[Array, Array]:
    """Fit-and-predict convenience: absorb then predict."""
    post = absorb(gp, theta_simil, theta_noise, x, y, mask)
    return predict_from_posterior(gp, post, z)


def predict_iterative(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    mask=None,
    panel: int = 1024,
    cg_iters: int = 200,
    tol: float = 1e-6,
) -> tuple[Array, Array]:
    """Matrix-free ``Produce``: the exact predict semantics (noise-free
    latent bands, reference gp/gp.go:258-360) with every K-solve done by
    CG over panel-rematerialized covariance matvecs — no factorization,
    no (n, n) storage, O(panel*n + n*m) memory.

    One batched CG solves [y | Kstar] together (m+1 right-hand sides share
    each matvec), then  mu = Kstar^T alpha  and
    sigma_i^2 = k(z_i, z_i) - Kstar[:, i] . W[:, i]  with W = K^-1 Kstar.
    Deterministic (no probes — only solves are needed).  For n where
    :func:`absorb`'s factorization is the bottleneck or K does not fit.
    """
    from gogp.ops.iterative import cg_solve, matfree_matvec

    x, y = _as_xy(gp, x, y)
    z = jnp.atleast_2d(jnp.asarray(z))
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    yv = y * mask

    rows_fn = _cov_rows_fn(gp, theta_simil, theta_noise, x, mask, panel)
    mv = matfree_matvec(rows_fn, n, panel)
    kstar = gp.simil.matrix(theta_simil, x, z) * mask[:, None]  # (n, m)
    X, _ = cg_solve(mv, jnp.concatenate([yv[:, None], kstar], axis=1),
                    cg_iters, tol)
    alpha, W = X[:, 0], X[:, 1:]
    mu = kstar.T @ alpha
    prior_var = gp.simil.diag_matrix(theta_simil, z)
    var = prior_var - jnp.sum(kstar * W, axis=0)
    # exact-path semantics: tiny negative from solve error clamps to 0
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    return mu, sigma


def predict_toeplitz(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    cg_iters: int = 200,
    tol: float = 1e-6,
    precond_rank: int = 0,
) -> tuple[Array, Array]:
    """``Produce`` for regular-grid time series via FFT circulant solves.

    The exact predict semantics (noise-free latent bands, reference
    gp/gp.go:258-360) with every K-solve a batched CG over O(n log n)
    Toeplitz matvecs — the O(n)-memory companion of :func:`lml_toeplitz`
    (same grid/homoscedastic-noise constraints; test inputs ``z`` are
    arbitrary, only the training grid must be regular).  One batched CG
    solves [y | Kstar] together; deterministic (no probes).
    """
    from gogp.ops import toeplitz as tz
    from gogp.ops.iterative import cg_solve, pivoted_precond_cols

    x, y = _as_xy(gp, x, y)
    z = jnp.atleast_2d(jnp.asarray(z))
    n = x.shape[0]
    if x.shape[1] != 1:
        raise ValueError("predict_toeplitz needs 1-D inputs on a regular grid")
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)

    col = gp.simil.matrix(theta_simil, x, x[:1])[:, 0]
    e0 = (jnp.arange(n) == 0).astype(col.dtype)
    noise_var = gp.noise.vector(theta_noise, x[:1])[0]
    c = col + noise_var * e0
    mv = tz.toeplitz_matvec_fn(c)
    pc = None
    if precond_rank > 0:
        pc = pivoted_precond_cols(
            tz.toeplitz_col_fn(c),
            jnp.broadcast_to(c[0], (n,)),
            precond_rank,
            jnp.broadcast_to(noise_var, (n,)),
        )

    kstar = gp.simil.matrix(theta_simil, x, z)  # (n, m)
    X, _ = cg_solve(mv, jnp.concatenate([y[:, None], kstar], axis=1),
                    cg_iters, tol, precond=pc)
    alpha, W = X[:, 0], X[:, 1:]
    mu = kstar.T @ alpha
    prior_var = gp.simil.diag_matrix(theta_simil, z)
    var = prior_var - jnp.sum(kstar * W, axis=0)
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    return mu, sigma


def predict_mixture(gp: GP, vs: Array, x, y, z, mask=None) -> tuple[Array, Array]:
    """Bayesian posterior predictive: moment-matched mixture over sampled
    hyperparameters.

    ``vs``: (S, n_theta) *log-scale* parameter vectors (NUTS/SMC/ADVI draws
    under the reference Observe protocol).  Each draw conditions the GP and
    predicts at ``z``; the returned (mu, sigma) are the mixture's first two
    moments:  mu = E[mu_s],  var = E[sigma_s^2 + mu_s^2] - mu^2.

    The per-draw fit+predict is vmapped — one batched covariance build +
    batched Cholesky for all S draws (the reference has no equivalent; its
    only integration over hyperparameters is MLE plug-in).
    """
    x, y = _as_xy(gp, x, y)
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    vs = jnp.asarray(vs)
    nts = gp.n_theta_simil

    def one(v):
        theta = jnp.exp(v)
        post = absorb(gp, theta[:nts], theta[nts:], x, y, mask)
        return predict_from_posterior(gp, post, z)

    mus, sigmas = jax.vmap(one)(vs)  # (S, m) each
    mu = jnp.mean(mus, axis=0)
    var = jnp.mean(sigmas * sigmas + mus * mus, axis=0) - mu * mu
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


def predict_prior(gp: GP, theta_simil, z) -> tuple[Array, Array]:
    """Prediction with no observations: mu = 0, sigma = prior std
    (reference gp/gp.go:343-347 zero path)."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    prior_var = gp.simil.diag_matrix(jnp.asarray(theta_simil), z)
    return jnp.zeros(z.shape[0], dtype=prior_var.dtype), jnp.sqrt(prior_var)
