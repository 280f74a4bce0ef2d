"""Sparse (inducing-point) GPs: SGPR and SVGP — the production serving path.

The reference has no sparse approximation: its only large-n levers are
goroutine row-parallelism over the exact O(n^3) computation (gp/gp.go:
165-213).  This framework already provides the exact Cholesky path,
the matrix-free iterative path, and the row-sharded distributed path; this
module adds the fourth regime — *approximate* inference with m << n
inducing points, where training is O(n m^2) and a fitted model predicts in
O(m^2) per test point.  That is the shape production serving wants: the
whole predictive state is (m, m) matrices that stay small, every predict
is a couple of matmuls, and minibatch training shards trivially over
data (psum of a sum — see :func:`svgp_elbo`'s data-parallel notes).

Two standard variational constructions, both accelerator-shaped (static shapes,
batched dense linear algebra at m x m, no data-dependent control flow):

- **SGPR** (Titsias 2009): the collapsed evidence lower bound.  q(u) is
  optimal in closed form, so the only parameters are the hyperparameters
  and the inducing locations Z.  Exact-arithmetic property used by the
  tests: with Z = X the bound equals the exact log marginal likelihood.

- **SVGP** (Hensman et al. 2013): explicit whitened q(u) = N(L v | ...)
  with v ~ N(q_mu, q_sqrt q_sqrt^T); the ELBO decomposes over data points
  so minibatches (and data-sharded meshes) give unbiased gradients.  With
  a Gaussian likelihood the per-point expected log-density is analytic;
  non-Gaussian likelihoods (e.g. the anynoise study's Laplace,
  /root/reference/tutorial/anynoise/model/model.go:40-43) integrate via
  Gauss-Hermite quadrature.

Semantics kept aligned with the exact core (gp/core.py):

- noise comes from the GP's noise kernel as a per-point *variance* vector
  (heteroscedastic diagonals are allowed, reference kernel/noise.go:23-34
  convention of std squared to variance);
- predictions return noise-free latent-f bands exactly like the exact
  ``predict`` (reference gp/gp.go:270-278 adds no noise to prior
  variance);
- padding follows the house mask convention: mask_i = 0 rows contribute
  nothing to the bound (their effective inverse-noise weight is zero).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp.core import GP, _LOG_2PI, _as_xy
from gogp.ops import linalg

Array = jax.Array

# Relative jitter added to Kuu before factorization.  Kuu is a *prior*
# covariance of m distinct inducing points with no noise on the diagonal —
# exactly the near-singular regime the exact path's DEFAULT_NOISE_STD
# guards against (gp/core.py:44) — so the standard fixed relative jitter.
DEFAULT_JITTER = 1e-6


def _chol_kuu(gp: GP, theta_simil, z: Array, jitter: float) -> Array:
    m = z.shape[0]
    kuu = gp.simil.matrix(theta_simil, z, z)
    scale = jnp.mean(jnp.diagonal(kuu))
    eye = jax.lax.broadcasted_iota(jnp.int32, (m, m), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (m, m), 1
    )
    kuu = jnp.where(eye, kuu + jitter * scale, kuu)
    return linalg.cholesky(kuu)


def _noise_weights(gp: GP, theta_noise, x: Array, mask: Array):
    """(s, w): per-point noise variance and masked inverse-noise weight."""
    s = gp.noise.vector(theta_noise, x)
    w = mask / s
    return s, w


class SGPRPosterior(NamedTuple):
    """Serving cache for a fitted SGPR: everything ``sgpr_predict`` needs,
    all O(m^2) — the sparse counterpart of gp.core.Posterior (itself the
    explicit form of the reference's stored-fields contract,
    gp/gp.go:255-257).  Orbax-checkpointable as-is."""

    theta_simil: Array  # (n_theta_simil,) natural scale
    theta_noise: Array  # (n_theta_noise,) natural scale
    z: Array  # (m, ndim) inducing inputs
    chol_kuu: Array  # (m, m) lower Cholesky of Kuu (+ jitter)
    chol_b: Array  # (m, m) lower Cholesky of B = I + A A^T
    c: Array  # (m,)  LB^{-1} A ytilde


def _sgpr_core(gp: GP, theta_simil, theta_noise, x, y, z, mask, jitter):
    """Shared SGPR assembly.  Returns (elbo, L, LB, c).

    Notation (GPflow-standard): V = L^{-1} Kuf, A = V sqrt(w),
    B = I + A A^T, LB = chol(B), ytilde = y sqrt(w), c = LB^{-1} A ytilde,
    with w the masked inverse noise weights.  Then

      elbo = -1/2 [ sum_i mask_i log(2 pi s_i) + log|B|
                    + |ytilde|^2 - |c|^2
                    + sum_i w_i kff_i - (tr(B) - m) ]

    where the last line is the Titsias trace correction
    -1/2 tr(Sigma^{-1}(Kff - Qff)): sum_i w_i qff_i = tr(A A^T) = tr(B) - m.
    """
    m = z.shape[0]
    L = _chol_kuu(gp, theta_simil, z, jitter)
    kuf = gp.simil.matrix(theta_simil, z, x)  # (m, n)
    s, w = _noise_weights(gp, theta_noise, x, mask)
    sqw = jnp.sqrt(w)
    V = linalg.trsm_lower(L, kuf)  # (m, n)
    A = V * sqw[None, :]
    eye = jnp.eye(m, dtype=A.dtype)
    B = eye + A @ A.T
    LB = linalg.cholesky(B)
    ytil = y * sqw
    c = linalg.trsm_lower(LB, (A @ ytil)[:, None])[:, 0]
    # kff is the *latent* prior variance: the noise kernel is not part of f
    # (the same noise-free-latent convention as the exact predict,
    # reference gp/gp.go:270-278).
    kff = gp.simil.diag_matrix(theta_simil, x)
    logdet_b = 2.0 * jnp.sum(jnp.log(jnp.diagonal(LB)))
    n_eff = jnp.sum(mask)
    elbo = -0.5 * (
        n_eff * _LOG_2PI
        + jnp.sum(mask * jnp.log(s))
        + logdet_b
        + jnp.dot(ytil, ytil)
        - jnp.dot(c, c)
        + jnp.sum(w * kff)
        - (jnp.trace(B) - m)
    )
    return elbo, L, LB, c


def _prep(gp: GP, theta_simil, theta_noise, x, y, mask):
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    theta_simil = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    theta_noise = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    return theta_simil, theta_noise, x, y * mask, mask


def sgpr_elbo(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    mask=None,
    jitter: float = DEFAULT_JITTER,
) -> Array:
    """Titsias collapsed bound on the log marginal likelihood.

    O(n m^2) with (m, n) peak memory; every heavy op is a matmul or
    an m x m factorization.  ``elbo <= lml`` always, with equality at
    Z = X (tests pin both).  Differentiable in hyperparameters AND ``z``
    (inducing locations are standard variational parameters)."""
    theta_simil, theta_noise, x, y, mask = _prep(
        gp, theta_simil, theta_noise, x, y, mask
    )
    z = jnp.atleast_2d(jnp.asarray(z, dtype=x.dtype))
    elbo, _, _, _ = _sgpr_core(gp, theta_simil, theta_noise, x, y, z, mask, jitter)
    return elbo


def sgpr_fit(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    mask=None,
    jitter: float = DEFAULT_JITTER,
) -> SGPRPosterior:
    """Condition on data at fixed hyperparameters: the sparse ``absorb``.

    Returns the O(m^2) serving cache; the (m, n) cross-covariance is
    consumed here and never needed again."""
    theta_simil, theta_noise, x, y, mask = _prep(
        gp, theta_simil, theta_noise, x, y, mask
    )
    z = jnp.atleast_2d(jnp.asarray(z, dtype=x.dtype))
    _, L, LB, c = _sgpr_core(gp, theta_simil, theta_noise, x, y, z, mask, jitter)
    return SGPRPosterior(theta_simil, theta_noise, z, L, LB, c)


def sgpr_predict(gp: GP, post: SGPRPosterior, t) -> tuple[Array, Array]:
    """Posterior mean and std at test inputs — O(m^2) per point.

    Same output contract as the exact ``predict_from_posterior``: bands are
    for the noise-free latent f (reference gp/gp.go:270-278 semantics).

      tmp1 = L^{-1} Kut,  tmp2 = LB^{-1} tmp1
      mu = tmp2^T c
      var = ktt - colnorm^2(tmp1) + colnorm^2(tmp2)
    """
    t = jnp.atleast_2d(jnp.asarray(t))
    kut = gp.simil.matrix(post.theta_simil, post.z, t)  # (m, t)
    tmp1 = linalg.trsm_lower(post.chol_kuu, kut)
    tmp2 = linalg.trsm_lower(post.chol_b, tmp1)
    mu = tmp2.T @ post.c
    prior = gp.simil.diag_matrix(post.theta_simil, t)
    var = prior - jnp.sum(tmp1 * tmp1, axis=0) + jnp.sum(tmp2 * tmp2, axis=0)
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


# ---------------------------------------------------------------------------
# SVGP: explicit whitened variational posterior, minibatch/data-sharded ELBO.
# ---------------------------------------------------------------------------


class SVGPState(NamedTuple):
    """Whitened variational state: u = L_uu v, v ~ N(q_mu, q_sqrt q_sqrt^T).

    ``q_sqrt`` is lower-triangular (enforced by ``tril`` at use sites so a
    gradient step cannot leak mass above the diagonal).  Whitening makes
    the KL prior N(0, I) — independent of the hyperparameters — which is
    what lets one Adam loop move thetas, Z, and q jointly without the
    pathological coupling of the unwhitened parameterization."""

    z: Array  # (m, ndim)
    q_mu: Array  # (m,)
    q_sqrt: Array  # (m, m) lower triangular


def svgp_init(gp: GP, z, dtype=jnp.float32) -> SVGPState:
    """q = N(0, I) — the KL-zero initialization."""
    z = jnp.atleast_2d(jnp.asarray(z, dtype=dtype))
    m = z.shape[0]
    return SVGPState(z, jnp.zeros((m,), dtype), jnp.eye(m, dtype=dtype))


def kl_whitened(q_mu: Array, q_sqrt: Array) -> Array:
    """KL( N(q_mu, S S^T) || N(0, I) ) with S lower-triangular."""
    S = jnp.tril(q_sqrt)
    m = q_mu.shape[0]
    d = jnp.diagonal(S)
    return 0.5 * (
        jnp.dot(q_mu, q_mu)
        + jnp.sum(S * S)
        - m
        - 2.0 * jnp.sum(jnp.log(jnp.abs(d)))
    )


def _latent_moments(gp: GP, theta_simil, state: SVGPState, x: Array, jitter):
    """Marginal q(f_i) = N(mean_i, var_i) at inputs x under whitened q(u)."""
    L = _chol_kuu(gp, theta_simil, state.z, jitter)
    kuf = gp.simil.matrix(theta_simil, state.z, x)  # (m, n)
    A = linalg.trsm_lower(L, kuf)  # (m, n)
    S = jnp.tril(state.q_sqrt)
    mean = A.T @ state.q_mu
    kff = gp.simil.diag_matrix(theta_simil, x)
    SA = S.T @ A  # (m, n)
    var = kff - jnp.sum(A * A, axis=0) + jnp.sum(SA * SA, axis=0)
    return mean, jnp.maximum(var, 0.0)


# Gauss-Hermite nodes for non-Gaussian expected log-likelihoods: constants
# computed host-side once per order (physicists' convention; the change of
# variables f = mean + sqrt(2 var) x absorbs the weight normalization).
def _gh_nodes(order: int, dtype):
    xs, ws = np.polynomial.hermite.hermgauss(order)
    return jnp.asarray(xs, dtype), jnp.asarray(ws / np.sqrt(np.pi), dtype)


def svgp_elbo(
    gp: GP,
    theta_simil,
    theta_noise,
    state: SVGPState,
    x,
    y,
    n_total: int | Array | None = None,
    mask=None,
    likelihood: Callable[[Array, Array], Array] | None = None,
    quad_order: int = 20,
    jitter: float = DEFAULT_JITTER,
) -> Array:
    """Hensman et al. minibatch evidence lower bound.

    ``x``/``y`` may be a minibatch; ``n_total`` is the full dataset size
    the data term is rescaled to (None = this batch is the whole dataset).
    With ``likelihood=None`` the Gaussian expected log-density is analytic:

      E_q [log N(y_i | f_i, s_i)] = log N(y_i | mean_i, s_i) - var_i/(2 s_i)

    with ``s`` from the GP's noise kernel.  A non-Gaussian per-point
    ``likelihood(y_i, f_i) -> log p`` integrates by ``quad_order``-point
    Gauss-Hermite quadrature over q(f_i) (e.g. the Laplace observation
    model of the anynoise study).

    Data-parallel: the data term is a masked sum over points, so sharding
    (x, y, mask) over a mesh axis and ``psum``-ing the local sums gives the
    identical ELBO — exercise via shard_map with the KL added once on the
    unsharded side (tests/test_sparse.py pins device-count invariance).
    """
    theta_simil, theta_noise, x, y, mask = _prep(
        gp, theta_simil, theta_noise, x, y, mask
    )
    mean, var = _latent_moments(gp, theta_simil, state, x, jitter)
    if likelihood is None:
        s = gp.noise.vector(theta_noise, x)
        point = (
            -0.5 * (_LOG_2PI + jnp.log(s) + (y - mean) ** 2 / s)
            - 0.5 * var / s
        )
    else:
        xs, ws = _gh_nodes(quad_order, x.dtype)
        f = mean[:, None] + jnp.sqrt(2.0 * var)[:, None] * xs[None, :]
        point = jnp.sum(
            jax.vmap(jax.vmap(likelihood))(jnp.broadcast_to(y[:, None], f.shape), f)
            * ws[None, :],
            axis=1,
        )
    batch_eff = jnp.sum(mask)
    data = jnp.sum(point * mask)
    if n_total is not None:
        data = data * (jnp.asarray(n_total, x.dtype) / jnp.maximum(batch_eff, 1.0))
    return data - kl_whitened(state.q_mu, state.q_sqrt)


def svgp_predict(
    gp: GP,
    theta_simil,
    state: SVGPState,
    t,
    jitter: float = DEFAULT_JITTER,
) -> tuple[Array, Array]:
    """Latent posterior mean/std at test inputs — O(m^2) per point,
    noise-free bands (house predict semantics)."""
    t = jnp.atleast_2d(jnp.asarray(t))
    theta_simil = jnp.asarray(theta_simil).reshape(gp.n_theta_simil)
    mean, var = _latent_moments(gp, theta_simil, state, t, jitter)
    return mean, jnp.sqrt(var)


def svgp_optimal_state(
    gp: GP,
    theta_simil,
    theta_noise,
    x,
    y,
    z,
    mask=None,
    jitter: float = DEFAULT_JITTER,
) -> SVGPState:
    """The closed-form optimal whitened q for a *Gaussian* likelihood.

    SGPR's collapsed bound is SVGP's bound maximized over q analytically;
    in whitened coordinates the optimum is

      cov(v) = B^{-1},            q_sqrt = LB^{-T} (inverse-transpose factor)
      q_mu   = B^{-1} A ytilde  = LB^{-T} c

    Tests use it to pin svgp_elbo == sgpr_elbo at the optimum; users get a
    warm start whose ELBO already equals the collapsed bound.

    NB ``LB^{-T}`` is upper triangular — the returned q_sqrt is its
    re-factorized lower-triangular Cholesky so it satisfies the SVGPState
    contract (tril projections at use sites must not change it).
    """
    theta_simil, theta_noise, x, y, mask = _prep(
        gp, theta_simil, theta_noise, x, y, mask
    )
    z = jnp.atleast_2d(jnp.asarray(z, dtype=x.dtype))
    _, L, LB, c = _sgpr_core(gp, theta_simil, theta_noise, x, y, z, mask, jitter)
    m = z.shape[0]
    eye = jnp.eye(m, dtype=x.dtype)
    lb_inv = linalg.trsm_lower(LB, eye)  # LB^{-1}
    q_mu = lb_inv.T @ c
    # cov = B^{-1} = LB^{-T} LB^{-1}; lower Cholesky factor of that product
    cov = lb_inv.T @ lb_inv
    q_sqrt = jnp.linalg.cholesky(cov)
    return SVGPState(z, q_mu, q_sqrt)


# ---------------------------------------------------------------------------
# Flat-vector protocol adapters: the house Observe convention (log-scale
# thetas first, SURVEY.md §2.1-1) extended with the inducing locations so
# the existing optimizers/samplers (infer.mle, infer.chees, ...) drive
# sparse models unchanged.
# ---------------------------------------------------------------------------


def split_sparse_params(gp: GP, v: Array, m: int):
    """v = [log theta_simil..., log theta_noise..., z_11...z_m-ndim] ->
    (theta_simil, theta_noise, z) with thetas exp-transformed (the same
    boundary transform as models.params.split_params)."""
    v = jnp.asarray(v)
    nt = gp.n_theta
    theta = jnp.exp(v[:nt])
    z = v[nt : nt + m * gp.ndim].reshape(m, gp.ndim)
    if v.shape[0] != nt + m * gp.ndim:
        raise ValueError(
            f"sparse parameter vector length {v.shape[0]} != "
            f"n_theta + m*ndim = {nt + m * gp.ndim}"
        )
    return theta[: gp.n_theta_simil], theta[gp.n_theta_simil :], z


def join_sparse_params(gp: GP, log_theta, z) -> Array:
    return jnp.concatenate(
        [jnp.asarray(log_theta).reshape(-1), jnp.asarray(z).reshape(-1)]
    )


class SVGPParams(NamedTuple):
    """Trainable SVGP parameter pytree: log-scale thetas (the house
    Observe-boundary transform, SURVEY.md §2.1-1) + variational state."""

    log_theta: Array  # (n_theta,)
    state: SVGPState


def svgp_fit(
    gp: GP,
    x,
    y,
    m: int,
    key,
    iters: int = 500,
    batch: int | None = None,
    rate: float = 0.01,
    likelihood: Callable[[Array, Array], Array] | None = None,
    quad_order: int = 20,
    jitter: float = DEFAULT_JITTER,
    log_theta0: Array | None = None,
    train_theta: bool = True,
) -> tuple[SVGPParams, Array]:
    """Minibatch Adam training of an SVGP — one compiled ``lax.scan``.

    Inducing inputs initialize to a random subset of the data; q to the
    KL-zero whitened N(0, I).  Each step draws ``batch`` points uniformly
    with replacement (unbiased under the n_total rescaling) and ascends
    the ELBO in (log_theta, Z, q_mu, q_sqrt) jointly; ``train_theta=False``
    freezes the hyperparameters (fixed-theta conditioning, the sparse
    analogue of the reference's Absorb-at-given-theta, gp/gp.go:80).

    Returns ``(params, elbo_trace)`` with one (minibatch) ELBO per step.
    The whole optimization is a single XLA program: no host round trips,
    static shapes throughout, like the rest of infer/mle.
    """
    import optax

    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    if batch is None or batch >= n:
        batch = n
    key, sub = jax.random.split(jnp.asarray(key))
    perm = jax.random.permutation(sub, n)[:m]
    state0 = svgp_init(gp, x[perm], dtype=x.dtype)
    if log_theta0 is None:
        log_theta0 = jnp.zeros((gp.n_theta,), dtype=x.dtype)
    params0 = SVGPParams(jnp.asarray(log_theta0, dtype=x.dtype), state0)
    opt = optax.adam(rate)
    opt_state0 = opt.init(params0)

    def elbo_of(params: SVGPParams, xb, yb):
        theta = jnp.exp(params.log_theta)
        ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
        return svgp_elbo(
            gp, ts, tn, params.state, xb, yb,
            n_total=n, likelihood=likelihood, quad_order=quad_order,
            jitter=jitter,
        )

    def step(carry, k):
        params, opt_state = carry
        if batch == n:
            xb, yb = x, y
        else:
            idx = jax.random.randint(k, (batch,), 0, n)
            xb, yb = x[idx], y[idx]
        value, grads = jax.value_and_grad(lambda p: elbo_of(p, xb, yb))(params)
        if not train_theta:
            grads = grads._replace(log_theta=jnp.zeros_like(grads.log_theta))
        neg = jax.tree.map(jnp.negative, grads)  # optax minimizes
        updates, opt_state = opt.update(neg, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), value

    keys = jax.random.split(key, iters)
    (params, _), trace = jax.lax.scan(step, (params0, opt_state0), keys)
    return params, trace


def _elbo_mS(
    gp: GP, theta_simil, theta_noise, z, q_mu, S_cov, x, y,
    n_total, mask, likelihood, quad_order, jitter,
) -> Array:
    """svgp_elbo re-parameterized by the full covariance S (not its
    Cholesky): the natural-gradient update needs dELBO/dS at fixed S, which
    the q_sqrt parameterization obscures.  Math identical to svgp_elbo."""
    theta_simil, theta_noise, x, y, mask = _prep(
        gp, theta_simil, theta_noise, x, y, mask
    )
    L = _chol_kuu(gp, theta_simil, z, jitter)
    kuf = gp.simil.matrix(theta_simil, z, x)
    A = linalg.trsm_lower(L, kuf)
    mean = A.T @ q_mu
    kff = gp.simil.diag_matrix(theta_simil, x)
    var = jnp.maximum(
        kff - jnp.sum(A * A, axis=0) + jnp.sum(A * (S_cov @ A), axis=0), 0.0
    )
    if likelihood is None:
        s = gp.noise.vector(theta_noise, x)
        point = (
            -0.5 * (_LOG_2PI + jnp.log(s) + (y - mean) ** 2 / s) - 0.5 * var / s
        )
    else:
        xs, ws = _gh_nodes(quad_order, x.dtype)
        f = mean[:, None] + jnp.sqrt(2.0 * var)[:, None] * xs[None, :]
        point = jnp.sum(
            jax.vmap(jax.vmap(likelihood))(jnp.broadcast_to(y[:, None], f.shape), f)
            * ws[None, :],
            axis=1,
        )
    batch_eff = jnp.sum(mask)
    data = jnp.sum(point * mask)
    if n_total is not None:
        data = data * (jnp.asarray(n_total, x.dtype) / jnp.maximum(batch_eff, 1.0))
    m = q_mu.shape[0]
    Ls = linalg.cholesky(S_cov)
    kl = 0.5 * (
        jnp.dot(q_mu, q_mu) + jnp.trace(S_cov) - m
        - 2.0 * jnp.sum(jnp.log(jnp.diagonal(Ls)))
    )
    return data - kl


def svgp_natgrad_step(
    gp: GP,
    theta_simil,
    theta_noise,
    state: SVGPState,
    x,
    y,
    gamma: float | Array,
    n_total: int | Array | None = None,
    mask=None,
    likelihood: Callable[[Array, Array], Array] | None = None,
    quad_order: int = 20,
    jitter: float = DEFAULT_JITTER,
) -> SVGPState:
    """One natural-gradient ascent step on the whitened q(u).

    Natural parameters Lambda1 = S^{-1} m, Lambda2 = -S^{-1}/2; the natural
    gradient of the ELBO w.r.t. them is its ordinary gradient w.r.t. the
    EXPECTATION parameters (m, S + m m^T) (Hensman et al. 2013, Salimbeni
    et al. 2018):

        Lambda1 <- Lambda1 + gamma (g_m - 2 g_S m)
        Lambda2 <- Lambda2 + gamma g_S

    For the Gaussian likelihood on a full batch, gamma = 1 lands on the
    OPTIMAL q in a single step from any start (== svgp_optimal_state) — the
    correctness anchor in tests/test_natgrad.py.  All solves are m x m.
    """
    S0 = jnp.tril(state.q_sqrt)
    S_cov = S0 @ S0.T
    q_mu = state.q_mu
    g_m, g_S = jax.grad(
        lambda mm, SS: _elbo_mS(
            gp, theta_simil, theta_noise, state.z, mm, SS, x, y,
            n_total, mask, likelihood, quad_order, jitter,
        ),
        argnums=(0, 1),
    )(q_mu, S_cov)
    g_S = 0.5 * (g_S + g_S.T)
    m = q_mu.shape[0]
    eye = jnp.eye(m, dtype=S_cov.dtype)
    Ls = linalg.cholesky(S_cov)
    P = linalg.cho_solve_mat(Ls, eye)  # S^{-1}
    lam1 = linalg.cho_solve_vec(Ls, q_mu)  # S^{-1} m
    gamma = jnp.asarray(gamma, S_cov.dtype)
    P_new = P - 2.0 * gamma * g_S
    lam1_new = lam1 + gamma * (g_m - 2.0 * (g_S @ q_mu))
    # S_new = P_new^{-1}; non-PD P_new (too-large gamma on a non-concave
    # direction) degrades via escalating jitter instead of NaN.
    Lp, _ = linalg.cholesky_with_jitter(0.5 * (P_new + P_new.T))
    S_new = linalg.cho_solve_mat(Lp, eye)
    S_new = 0.5 * (S_new + S_new.T)
    m_new = S_new @ lam1_new
    q_sqrt_new = linalg.cholesky(S_new)
    return SVGPState(state.z, m_new, q_sqrt_new)


def svgp_fit_natgrad(
    gp: GP,
    x,
    y,
    m: int,
    key,
    iters: int = 300,
    batch: int | None = None,
    gamma: float = 0.3,
    rate: float = 0.01,
    likelihood: Callable[[Array, Array], Array] | None = None,
    quad_order: int = 20,
    jitter: float = DEFAULT_JITTER,
    log_theta0: Array | None = None,
    train_theta: bool = True,
) -> tuple[SVGPParams, Array]:
    """SVGP training with NATURAL gradients on q(u) + Adam on (theta, Z).

    The standard fast path for variational GPs: the variational
    distribution moves in information geometry (one step is exact for the
    Gaussian likelihood; for non-Gaussian it takes the curvature of the
    Gaussian family into account), while hyperparameters and inducing
    inputs follow ordinary Adam.  Same estimator and API shape as svgp_fit;
    one compiled lax.scan.
    """
    import optax

    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    if batch is None or batch >= n:
        batch = n
    key, sub = jax.random.split(jnp.asarray(key))
    perm = jax.random.permutation(sub, n)[:m]
    state0 = svgp_init(gp, x[perm], dtype=x.dtype)
    if log_theta0 is None:
        log_theta0 = jnp.zeros((gp.n_theta,), dtype=x.dtype)
    hyper0 = (jnp.asarray(log_theta0, dtype=x.dtype), state0.z)
    opt = optax.adam(rate)
    opt_state0 = opt.init(hyper0)

    def elbo_of(hyper, q_mu, q_sqrt, xb, yb):
        log_theta, z = hyper
        theta = jnp.exp(log_theta)
        ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
        return svgp_elbo(
            gp, ts, tn, SVGPState(z, q_mu, q_sqrt), xb, yb,
            n_total=n, likelihood=likelihood, quad_order=quad_order,
            jitter=jitter,
        )

    def step(carry, k):
        hyper, q_mu, q_sqrt, opt_state = carry
        if batch == n:
            xb, yb = x, y
        else:
            idx = jax.random.randint(k, (batch,), 0, n)
            xb, yb = x[idx], y[idx]
        value, grads = jax.value_and_grad(
            lambda h: elbo_of(h, q_mu, q_sqrt, xb, yb)
        )(hyper)
        if train_theta:
            neg = jax.tree.map(jnp.negative, grads)
            updates, opt_state = opt.update(neg, opt_state, hyper)
            hyper = optax.apply_updates(hyper, updates)
        log_theta, z = hyper
        theta = jnp.exp(log_theta)
        ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
        new_state = svgp_natgrad_step(
            gp, ts, tn, SVGPState(z, q_mu, q_sqrt), xb, yb, gamma,
            n_total=n, likelihood=likelihood, quad_order=quad_order,
            jitter=jitter,
        )
        return (hyper, new_state.q_mu, new_state.q_sqrt, opt_state), value

    keys = jax.random.split(key, iters)
    (hyper, q_mu, q_sqrt, _), trace = jax.lax.scan(
        step, (hyper0, state0.q_mu, state0.q_sqrt, opt_state0), keys
    )
    log_theta, z = hyper
    return SVGPParams(log_theta, SVGPState(z, q_mu, q_sqrt)), trace


def svgp_fit_stream(
    gp: GP,
    batches,
    n_total: int,
    m: int,
    z0,
    iters: int = 500,
    rate: float = 0.01,
    likelihood: Callable[[Array, Array], Array] | None = None,
    quad_order: int = 20,
    jitter: float = DEFAULT_JITTER,
    log_theta0: Array | None = None,
    train_theta: bool = True,
    dtype=jnp.float64,
) -> tuple[SVGPParams, Array]:
    """Out-of-core SVGP training: minibatches arrive from a host iterator.

    The streaming twin of :func:`svgp_fit` — same estimator (the
    uniform-with-replacement sampling semantics live in the stream, e.g.
    utils.dataio.MinibatchStream backed by the native prefetch loader),
    but the dataset never has to fit in device (or host) memory.  One
    jitted step function (theta/variational ascent on the rescaled ELBO)
    is compiled once for the fixed batch shape and fed by the host loop
    while the native loader's background thread keeps the next batch
    gathered — the classic double-buffered input pipeline.

    ``z0``: (m, ndim) initial inducing inputs (with no in-memory dataset to
    subsample, the caller provides them — e.g. the first stream batch).
    Returns ``(params, elbo_trace)`` like svgp_fit.
    """
    import optax

    z0 = jnp.asarray(z0, dtype=dtype)
    if z0.shape[0] != m:
        raise ValueError(f"z0 rows {z0.shape[0]} != m {m}")
    state0 = svgp_init(gp, z0, dtype=dtype)
    if log_theta0 is None:
        log_theta0 = jnp.zeros((gp.n_theta,), dtype=dtype)
    params0 = SVGPParams(jnp.asarray(log_theta0, dtype=dtype), state0)
    opt = optax.adam(rate)
    opt_state0 = opt.init(params0)

    def elbo_of(params: SVGPParams, xb, yb):
        theta = jnp.exp(params.log_theta)
        ts, tn = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
        return svgp_elbo(
            gp, ts, tn, params.state, xb, yb,
            n_total=n_total, likelihood=likelihood, quad_order=quad_order,
            jitter=jitter,
        )

    @jax.jit
    def step(params, opt_state, xb, yb):
        value, grads = jax.value_and_grad(lambda p: elbo_of(p, xb, yb))(params)
        if not train_theta:
            grads = grads._replace(log_theta=jnp.zeros_like(grads.log_theta))
        neg = jax.tree.map(jnp.negative, grads)
        updates, opt_state = opt.update(neg, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    params, opt_state = params0, opt_state0
    trace = []
    it = iter(batches)
    for _ in range(iters):
        xb, yb = next(it)
        xb = jnp.asarray(xb, dtype=dtype)
        if xb.ndim == 1:
            xb = xb[:, None]
        params, opt_state, value = step(params, opt_state, xb, jnp.asarray(yb, dtype=dtype))
        trace.append(value)
    return params, jnp.stack(trace)


def make_sgpr_logp(gp: GP, x, y, m: int, mask=None, jitter: float = DEFAULT_JITTER):
    """``logp(v) -> collapsed ELBO`` over [log thetas | Z] — plug into
    infer.mle.adam/lbfgs (or any sampler) exactly like make_gp_logp."""

    def logp(v):
        ts, tn, z = split_sparse_params(gp, v, m)
        return sgpr_elbo(gp, ts, tn, x, y, z, mask, jitter)

    return logp
