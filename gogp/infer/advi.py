"""Automatic Differentiation Variational Inference (mean-field Gaussian).

North-star inference engine (BASELINE.json: "HMC + ADVI comparison" on the
anynoise study).  Fits q(v) = N(mu, diag(exp(log_sigma)^2)) to a log-density
by stochastic maximization of the ELBO with the reparameterization trick
(Kucukelbir et al. 2017), all inside one compiled ``lax.scan`` — the Monte
Carlo ELBO gradient at each step is a vmapped batch of draws, which XLA
fuses into a single batched evaluation of the model (for GP targets: one
batched covariance build + Cholesky per step).

Supports the 0/1 ``free`` mask protocol (SURVEY.md §2.1-10): pinned
coordinates keep q a point mass at their initialization (their mu is frozen
and their sigma forced to ~0 in sampling).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

Array = jax.Array
LogDensity = Callable[[Array], Array]

_LOG_2PI = 1.8378770664093453


class ADVIResult(NamedTuple):
    mu: Array  # (dim,) variational mean
    log_sigma: Array  # (dim,) variational log-std
    elbos: Array  # (num_steps,) ELBO trace
    final_elbo: Array


def _entropy(log_sigma: Array, free: Array | None) -> Array:
    ls = log_sigma if free is None else log_sigma * free
    dim = jnp.sum(free) if free is not None else log_sigma.shape[0]
    return 0.5 * dim * (1.0 + _LOG_2PI) + jnp.sum(ls)


def elbo(
    logp: LogDensity,
    mu: Array,
    log_sigma: Array,
    key: Array,
    num_draws: int = 8,
    free: Array | None = None,
) -> Array:
    """Monte Carlo ELBO: E_q[logp(v)] + H(q), reparameterized draws."""
    sigma = jnp.exp(log_sigma)
    if free is not None:
        sigma = sigma * free
    eps = jax.random.normal(key, (num_draws,) + mu.shape, dtype=mu.dtype)
    draws = mu[None, :] + eps * sigma[None, :]
    logps = jax.vmap(logp)(draws)
    return jnp.mean(logps) + _entropy(log_sigma, free)


def run_advi(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    num_steps: int = 2000,
    num_draws: int = 8,
    learning_rate: float = 0.01,
    init_log_sigma: float = -2.0,
    free: Array | None = None,
) -> ADVIResult:
    """Optimize the mean-field ELBO; returns variational parameters."""
    position0 = jnp.asarray(position0)
    mu0 = position0
    ls0 = jnp.full_like(position0, init_log_sigma)
    if free is not None:
        free = jnp.asarray(free, dtype=position0.dtype)

    params0 = (mu0, ls0)
    opt = optax.adam(learning_rate)
    opt_state0 = opt.init(params0)

    def neg_elbo(params, key):
        mu, ls = params
        return -elbo(logp, mu, ls, key, num_draws, free)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(neg_elbo)(params, key)
        if free is not None:
            grads = (grads[0] * free, grads[1] * free)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    keys = jax.random.split(rng, num_steps)
    (params, _), elbos = jax.lax.scan(step, (params0, opt_state0), keys)
    mu, ls = params
    return ADVIResult(mu, ls, elbos, elbos[-1])


def sample_posterior(
    result: ADVIResult, key: Array, num_samples: int, free: Array | None = None
) -> Array:
    """Draw from the fitted mean-field Gaussian."""
    sigma = jnp.exp(result.log_sigma)
    if free is not None:
        sigma = sigma * jnp.asarray(free, dtype=sigma.dtype)
    eps = jax.random.normal(key, (num_samples,) + result.mu.shape, dtype=result.mu.dtype)
    return result.mu[None, :] + eps * sigma[None, :]


# ---------------------------------------------------------------------------
# Full-rank ADVI: q(v) = N(mu, L L^T), L lower-triangular.
# ---------------------------------------------------------------------------
#
# GP hyperparameter posteriors are strongly correlated (amplitude/
# lengthscale/noise trade off through the LML), which a diagonal q cannot
# represent — mean-field ADVI systematically underestimates their marginal
# variances.  Full-rank costs O(d^2) parameters; for the d ~ 3-10 of every
# model here that is free.  Parametrization: raw (d, d) matrix whose strict
# lower triangle is L's and whose diagonal is log L_ii (positivity), so
# H(q) = 0.5 d (1 + log 2 pi) + sum_i raw_ii.


class FullRankADVIResult(NamedTuple):
    mu: Array  # (dim,)
    chol_raw: Array  # (dim, dim) strict-lower = L, diag = log L_ii
    elbos: Array
    final_elbo: Array


def _chol_of(raw: Array) -> Array:
    return jnp.tril(raw, -1) + jnp.diag(jnp.exp(jnp.diagonal(raw)))


def _entropy_fullrank(raw: Array, free: Array | None) -> Array:
    d = jnp.diagonal(raw)
    if free is not None:
        d = d * free
        dim = jnp.sum(free)
    else:
        dim = raw.shape[0]
    return 0.5 * dim * (1.0 + _LOG_2PI) + jnp.sum(d)


def elbo_fullrank(
    logp: LogDensity,
    mu: Array,
    chol_raw: Array,
    key: Array,
    num_draws: int = 8,
    free: Array | None = None,
) -> Array:
    L = _chol_of(chol_raw)
    if free is not None:
        # zero pinned ROWS (their draws stay at mu) AND pinned COLUMNS:
        # a strict-lower L[i, j] with j pinned would feed noise into free
        # coordinate i through a direction the triangular-free-block
        # entropy formula does not count, so the masked family must be
        # exactly the free-block triangle
        L = L * free[:, None] * free[None, :]
    eps = jax.random.normal(key, (num_draws,) + mu.shape, dtype=mu.dtype)
    draws = mu[None, :] + eps @ L.T
    logps = jax.vmap(logp)(draws)
    return jnp.mean(logps) + _entropy_fullrank(chol_raw, free)


def run_advi_fullrank(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    num_steps: int = 2000,
    num_draws: int = 8,
    learning_rate: float = 0.01,
    init_log_sigma: float = -2.0,
    free: Array | None = None,
) -> FullRankADVIResult:
    """Optimize the full-rank ELBO; same driving pattern as :func:`run_advi`."""
    position0 = jnp.asarray(position0)
    dim = position0.shape[0]
    mu0 = position0
    raw0 = jnp.eye(dim, dtype=position0.dtype) * init_log_sigma
    raw0 = jnp.where(jnp.eye(dim, dtype=bool), raw0, 0.0)
    if free is not None:
        free = jnp.asarray(free, dtype=position0.dtype)

    params0 = (mu0, raw0)
    opt = optax.adam(learning_rate)
    opt_state0 = opt.init(params0)

    def neg_elbo(params, key):
        mu, raw = params
        return -elbo_fullrank(logp, mu, raw, key, num_draws, free)

    def step(carry, key):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(neg_elbo)(params, key)
        if free is not None:
            grads = (grads[0] * free, grads[1] * free[:, None])
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    keys = jax.random.split(rng, num_steps)
    (params, _), elbos = jax.lax.scan(step, (params0, opt_state0), keys)
    mu, raw = params
    return FullRankADVIResult(mu, raw, elbos, elbos[-1])


def sample_posterior_fullrank(
    result: FullRankADVIResult, key: Array, num_samples: int,
    free: Array | None = None,
) -> Array:
    """Draw from the fitted full-rank Gaussian."""
    L = _chol_of(result.chol_raw)
    if free is not None:
        fr = jnp.asarray(free, dtype=L.dtype)
        L = L * fr[:, None] * fr[None, :]  # match elbo_fullrank's masked family
    eps = jax.random.normal(
        key, (num_samples,) + result.mu.shape, dtype=result.mu.dtype
    )
    return result.mu[None, :] + eps @ L.T
