"""Serving: precompiled posterior caches for low-latency batch prediction.

The reference's serving story is ``Produce`` off the stored GP fields
(gp/gp.go:255-360): every prediction re-runs a triangular solve against the
cached Cholesky factor.  A triangular solve is the wrong shape for a
latency-critical serve loop — its recurrence serializes, while the matrix
units want one big matmul.  This module trades a one-time O(n^3/3) triangular
inversion at *fit* time for pure-matmul predictions at *serve* time:

    ServingPosterior = Posterior with W = inv(L) precomputed
    mu    = Kstar^T alpha                       (one (m,n)@(n,) matvec)
    sigma = sqrt(kzz - colnorms^2(W @ Kstar))   (one (n,n)@(n,m) matmul)

Semantics are identical to gp.core.predict_from_posterior (noise-free
latent-f bands, reference gp/gp.go:270-278; zero-observation prior fallback
:343-347) — pinned by tests against the exact path.

Bayesian serving: a fitted sampler chain (S hyperparameter draws) compiles
into a ``ServingMixture`` — the S posteriors stacked as one pytree — and
serves the moment-matched predictive mixture as S-batched matmuls
(einsums), amortizing every HBM stream of the test covariances across
draws.

Both caches are plain NamedTuple pytrees: orbax-checkpointable with
utils.checkpoint.save/restore, shardable with jax.device_put — the
"model artifact" of this framework.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gogp.gp.core import GP, Posterior, absorb
from gogp.ops import linalg

Array = jax.Array


class ServingPosterior(NamedTuple):
    """Fitted-GP serving cache: Posterior with the factor inverted.

    ``w`` is inv(chol(K)) (lower triangular): the one-time O(n^3/3) spend
    that turns every predictive half-solve L^{-1} Kstar into a matmul.
    """

    theta_simil: Array  # (n_theta_simil,) natural scale
    theta_noise: Array  # (n_theta_noise,) natural scale
    x: Array  # (n, ndim)
    alpha: Array  # (n,)  K^{-1} y
    w: Array  # (n, n) inv(L), lower triangular
    mask: Array  # (n,) 1.0 real / 0.0 padding


def compile_posterior(gp: GP, post: Posterior) -> ServingPosterior:
    """Posterior -> ServingPosterior: invert the cached factor once."""
    del gp  # symmetry with the other entry points; spec not needed here
    w = linalg.tril_inv(post.chol)
    return ServingPosterior(
        post.theta_simil, post.theta_noise, post.x, post.alpha, w, post.mask
    )


def fit_serving(gp: GP, theta_simil, theta_noise, x, y, mask=None) -> ServingPosterior:
    """absorb + compile in one call — the fit-time entry point."""
    return compile_posterior(gp, absorb(gp, theta_simil, theta_noise, x, y, mask))


def serve_predict(
    gp: GP, sp: ServingPosterior, z, precision: str | None = linalg.ACCURATE_PRECISION
) -> tuple[Array, Array]:
    """Predictive mean/std at test inputs ``z`` from the compiled cache.

    Identical semantics to gp.core.predict_from_posterior (reference
    Produce, gp/gp.go:258-360): prior variance has no noise added, padded
    training rows contribute nothing, sigma is the noise-free latent band.
    The half-solve is ``w @ kstar`` — one matmul instead of a triangular
    solve.

    ``precision``: matmul precision for the serve matmuls.  The predictive
    variance is the difference of two nearly equal numbers wherever the
    data explains the test point (var = prior - explained), so at TF32
    (JAX's default for float32 products on the GPU) sigma carried 2.4e-3
    max abs error at n=4096 on an H100, against 1.8e-6 at "highest".  The
    DEFAULT is therefore linalg.ACCURATE_PRECISION ("highest"); mu-only
    throughput serving may pass precision=None for the faster TF32 path
    (mu is a well-conditioned inner product and is fine there).
    """
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    prior_var = gp.simil.diag_matrix(sp.theta_simil, z)
    kstar = gp.simil.matrix(sp.theta_simil, sp.x, z)  # (n, m)
    kstar = kstar * sp.mask[:, None]
    mu = jnp.matmul(kstar.T, sp.alpha, precision=precision)
    v = jnp.matmul(sp.w, kstar, precision=precision)  # precompiled L^{-1} Kstar
    var = prior_var - jnp.sum(v * v, axis=0)
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    return mu, sigma


def serve_predict_y(
    gp: GP, sp: ServingPosterior, z, precision: str | None = linalg.ACCURATE_PRECISION
) -> tuple[Array, Array]:
    """Noise-inclusive predictive bands from the compiled cache:
    sigma_y^2 = sigma_f^2 + noise_var(z) (gp.core.predict_y_from_posterior
    semantics; the plain :func:`serve_predict` keeps the reference's
    noise-free latent bands, gp/gp.go:270-278)."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    mu, sigma = serve_predict(gp, sp, z, precision)
    nv = gp.noise.vector(sp.theta_noise, z)
    return mu, jnp.sqrt(sigma * sigma + nv)


def serve_predict_cov(
    gp: GP, sp: ServingPosterior, z, precision: str | None = linalg.ACCURATE_PRECISION
) -> tuple[Array, Array]:
    """Predictive mean and FULL joint covariance at ``z`` (m x m).

    The reference materializes this internally and throws away everything
    but the diagonal (gp/gp.go:337-342); joint bands / trajectory risk
    need the whole thing:  cov = Kzz - v^T v  with v = W Kstar.  Noise-free
    latent-f covariance, consistent with :func:`serve_predict`.
    """
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    kzz = gp.simil.matrix(sp.theta_simil, z, z)
    kstar = gp.simil.matrix(sp.theta_simil, sp.x, z) * sp.mask[:, None]
    mu = jnp.matmul(kstar.T, sp.alpha, precision=precision)
    v = jnp.matmul(sp.w, kstar, precision=precision)
    cov = kzz - jnp.matmul(v.T, v, precision=precision)
    return mu, cov


def serve_sample(
    gp: GP,
    sp: ServingPosterior,
    z,
    key,
    num_samples: int = 1,
    jitter: float = 1e-8,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> Array:
    """Joint posterior function draws f(z) ~ N(mu, cov) — (num_samples, m).

    The feature the reference's marginal-sigma Produce cannot express:
    coherent sampled trajectories (needed for Thompson sampling, joint
    exceedance probabilities, scenario generation).  O(m^3) for the m x m
    factorization; use batches of moderate m.
    """
    mu, cov = serve_predict_cov(gp, sp, z, precision)
    m = mu.shape[0]
    scale = jnp.mean(jnp.diagonal(cov)) + 1.0
    chol = jnp.linalg.cholesky(
        cov + (jitter * scale) * jnp.eye(m, dtype=cov.dtype)
    )
    eps = jax.random.normal(key, (num_samples, m), dtype=mu.dtype)
    return mu[None, :] + jnp.matmul(eps, chol.T, precision=precision)


class ServingMixture(NamedTuple):
    """S stacked serving posteriors — the compiled form of a sampler chain
    over hyperparameters (every leaf carries a leading draw axis)."""

    theta_simil: Array  # (S, n_theta_simil)
    theta_noise: Array  # (S, n_theta_noise)
    x: Array  # (n, ndim) — shared training inputs
    alpha: Array  # (S, n)
    w: Array  # (S, n, n)
    mask: Array  # (n,)

    @property
    def n_draws(self) -> int:
        return self.alpha.shape[0]


def compile_mixture(gp: GP, vs: Array, x, y, mask=None) -> ServingMixture:
    """Compile S log-scale draws (NUTS/ChEES/SMC output under the reference
    Observe protocol) into a batched serving cache.

    One vmapped absorb (batched covariance + batched Cholesky) and one
    vmapped triangular inversion; O(S n^2) storage.
    """
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    y = jnp.asarray(y)
    vs = jnp.asarray(vs)
    nts = gp.n_theta_simil

    def one(v):
        theta = jnp.exp(v)
        post = absorb(gp, theta[:nts], theta[nts:], x, y, mask)
        return post, linalg.tril_inv(post.chol)

    posts, ws = jax.vmap(one)(vs)
    return ServingMixture(
        posts.theta_simil, posts.theta_noise, x, posts.alpha, ws, posts.mask[0]
    )


def serve_predict_mixture(
    gp: GP, sm: ServingMixture, z, precision: str | None = linalg.ACCURATE_PRECISION
) -> tuple[Array, Array]:
    """Moment-matched posterior predictive from the compiled mixture:
    mu = E_s[mu_s],  var = E_s[sigma_s^2 + mu_s^2] - mu^2  (the same
    moments as gp.core.predict_mixture, served as S-batched matmuls).
    ``precision``: see :func:`serve_predict`."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    prior_var = jax.vmap(lambda ts: gp.simil.diag_matrix(ts, z))(
        sm.theta_simil
    )  # (S, m)
    kstar = jax.vmap(lambda ts: gp.simil.matrix(ts, sm.x, z))(
        sm.theta_simil
    )  # (S, n, m)
    kstar = kstar * sm.mask[None, :, None]
    mus = jnp.einsum("snm,sn->sm", kstar, sm.alpha, precision=precision)
    v = jnp.einsum("snk,skm->snm", sm.w, kstar, precision=precision)  # (S, n, m)
    vars_ = jnp.maximum(prior_var - jnp.sum(v * v, axis=1), 0.0)
    mu = jnp.mean(mus, axis=0)
    var = jnp.mean(vars_ + mus * mus, axis=0) - mu * mu
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


def serve_predict_mixture_y(
    gp: GP, sm: ServingMixture, z, precision: str | None = linalg.ACCURATE_PRECISION
) -> tuple[Array, Array]:
    """Noise-inclusive moment-matched Bayesian predictive:

        var_y = E_s[sigma_s^2 + noise_s(z) + mu_s^2] - mu^2

    Each draw carries its OWN noise hyperparameters, so the observation
    variance must be averaged inside the moment match, not bolted on after
    (adding a single noise term to :func:`serve_predict_mixture`'s sigma
    would be wrong whenever the noise theta posterior has spread)."""
    z = jnp.asarray(z)
    if z.ndim == 1:
        z = z[:, None]
    mu, sigma_f = serve_predict_mixture(gp, sm, z, precision)
    nv = jnp.mean(
        jax.vmap(lambda tn: gp.noise.vector(tn, z))(sm.theta_noise), axis=0
    )
    return mu, jnp.sqrt(sigma_f * sigma_f + nv)


__all__ = [
    "ServingPosterior",
    "ServingMixture",
    "compile_posterior",
    "compile_mixture",
    "fit_serving",
    "serve_predict",
    "serve_predict_y",
    "serve_predict_cov",
    "serve_predict_mixture",
    "serve_predict_mixture_y",
    "serve_sample",
]
