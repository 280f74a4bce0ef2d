"""Expectation propagation for latent-GP models — parallel-update EP.

The second classic non-conjugate inference (GPML §3.6) next to
:mod:`gogp.gp.laplace`: each likelihood factor p(y_i|f_i) is replaced
by an unnormalized Gaussian site t_i(f) = exp(nu_i f - tau_i f^2 / 2) whose
parameters are iterated to match the tilted-distribution moments.  EP is
usually the accuracy reference for probit classification (its predictive
probabilities track MCMC closely where Laplace is biased toward 1/2).

Accelerator-first design: the textbook algorithm updates sites ONE AT A
TIME with a rank-1 posterior downdate (GPML Alg. 3.5) — a serial O(n) sweep
of O(n^2) updates that maps terribly to matrix units.  This module runs *parallel EP*
(Opper-Winther / power-EP with simultaneous updates, damped): every sweep
recomputes all n cavities from one B = I + S^0.5 K S^0.5 Cholesky, updates
every site at once from its tilted moments, and damps the natural
parameters.  Each sweep is one factorization + two matmuls — dense work
batched over all sites — and the sweep loop is a lax.while_loop
on the site-parameter change.  Same masked/static-shape conventions as
gp.core; per-call matmul ``precision`` like laplace/serve.

Tilted moments (Zhat, mu_hat, sigma2_hat) come from the shared
:class:`~gogp.gp.likelihoods.Likelihood` by Gauss-Hermite quadrature —
any pointwise likelihood works — with the analytic probit fast path
(GPML eq. 3.58) when the likelihood is bernoulli_probit.

Hyperparameter gradients: log Z_EP is stationary w.r.t. the site natural
parameters at an EP fixed point (Seeger 2005), so wrapping the converged
sites in stop_gradient and re-evaluating log Z_EP with a differentiable K
yields the exact theta-gradient — the same fixed-point trick as
laplace.laplace_lml, verified by finite differences in tests/test_ep.py.
With the Gaussian likelihood EP is exact after one sweep and ep_lml equals
the exact gp.lml — the validation anchor.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.stats import norm

from gogp.gp.core import GP, _as_xy, masked_cov
from gogp.gp.likelihoods import Likelihood, bernoulli_probit, gaussian
from gogp.ops import linalg

Array = jax.Array

_TAU_MIN = 1e-10  # cavity/site precision floor (clip, not error: jit-safe)


def _safe_sqrt(w: Array) -> Array:
    """sqrt with a zero gradient at w == 0 (padded rows / zeroed sites);
    see laplace._safe_sqrt for the inf * 0 = NaN failure this avoids."""
    pos = w > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, w, 1.0)), 0.0)


class EPPosterior(NamedTuple):
    """Converged EP state: sites + the B-factorization at those sites."""

    theta_simil: Array  # (n_theta_simil,) natural scale
    theta_noise: Array  # (n_theta_noise,) natural scale
    theta_lik: Array  # (lik.n_theta,) natural scale
    x: Array  # (n, ndim)
    y: Array  # (n,)
    tau_site: Array  # (n,) site precisions (>= 0)
    nu_site: Array  # (n,) site precision-means
    chol_b: Array  # (n, n) lower Cholesky of B = I + S^0.5 K S^0.5
    alpha: Array  # (n,) (K + S^{-1})^{-1} S^{-1} nu = posterior K^{-1}-mean weights
    mask: Array  # (n,) 1.0 real / 0.0 padding


def _gh_nodes(order: int, dtype):
    xs, ws = np.polynomial.hermite.hermgauss(order)
    return jnp.asarray(xs, dtype), jnp.asarray(ws / np.sqrt(np.pi), dtype)


def _tilted_moments(lik: Likelihood, tl, y, mu_c, s2_c, order: int):
    """(log Zhat, mu_hat, sigma2_hat) of Z^-1 p(y|f) N(f; mu_c, s2_c).

    Analytic for probit (GPML eq. 3.58) and Gaussian (conjugate — exact,
    which makes the Gaussian-equivalence oracle exact rather than
    quadrature-limited); Gauss-Hermite otherwise.  All vectorized over
    sites.
    """
    if lik is gaussian:
        s2_l = tl[0] * tl[0]
        tot = s2_l + s2_c
        r = y - mu_c
        logZ = -0.5 * (r * r / tot + jnp.log(2.0 * jnp.pi * tot))
        mu_hat = mu_c + s2_c * r / tot
        s2_hat = s2_c * s2_l / tot
        return logZ, mu_hat, s2_hat
    if lik is bernoulli_probit:
        sgn = 2.0 * y - 1.0
        denom = jnp.sqrt(1.0 + s2_c)
        z = sgn * mu_c / denom
        logZ = norm.logcdf(z)
        ratio = jnp.exp(norm.logpdf(z) - logZ)  # N(z)/Phi(z), stable
        mu_hat = mu_c + sgn * s2_c * ratio / denom
        s2_hat = s2_c - s2_c * s2_c * ratio * (z + ratio) / (1.0 + s2_c)
        return logZ, mu_hat, s2_hat
    xs, ws = _gh_nodes(order, mu_c.dtype)
    sd = jnp.sqrt(2.0 * s2_c)
    f = mu_c[:, None] + sd[:, None] * xs[None, :]  # (n, order)
    ll = jax.vmap(
        jax.vmap(lambda fi, yi: lik.logp(tl, fi, yi), in_axes=(0, None)),
        in_axes=(0, 0),
    )(f, y)  # (n, order)
    # log-sum-exp against the GH weights for Zhat, then moment ratios.
    mx = jnp.max(ll, axis=1, keepdims=True)
    p = jnp.exp(ll - mx) * ws[None, :]
    Z = jnp.sum(p, axis=1)
    logZ = jnp.log(Z) + mx[:, 0]
    mu_hat = jnp.sum(p * f, axis=1) / Z
    ex2 = jnp.sum(p * f * f, axis=1) / Z
    return logZ, mu_hat, jnp.maximum(ex2 - mu_hat * mu_hat, _TAU_MIN)


def _posterior_marginals(K, tau, nu, precision):
    """diag(Sigma), mu, chol(B), alpha for Sigma = (K^{-1} + S)^{-1}.

    Sigma = K - K sW B^{-1} sW K with sW = sqrt(tau) (all matmuls);
    mu = Sigma nu; alpha are the weights with K*^T alpha = predictive mean.
    """
    n = K.shape[0]
    sw = _safe_sqrt(tau)
    eye = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0) == jax.lax.broadcasted_iota(
        jnp.int32, (n, n), 1
    )
    B = jnp.where(eye, 1.0 + sw * sw * jnp.diag(K), sw[:, None] * K * sw[None, :])
    L = linalg.cholesky(B)
    V = linalg.trsm_lower(L, sw[:, None] * K)  # (n, n): L^{-1} sW K
    sigma_diag = jnp.diag(K) - jnp.sum(V * V, axis=0)
    Knu = jnp.matmul(K, nu, precision=precision)
    alpha = nu - sw * linalg.cho_solve_vec(L, sw * Knu)  # (K+S^{-1})^{-1} S^{-1} nu
    mu = jnp.matmul(K, alpha, precision=precision)
    return sigma_diag, mu, L, alpha


def _ep_sweeps(lik, tl, K, y, mask, max_sweeps, tol, damping, order, precision):
    """Damped parallel-EP fixed-point iteration (not differentiable)."""
    n = y.shape[0]
    zeros = jnp.zeros((n,), dtype=K.dtype)

    def cond(state):
        _, _, delta, it = state
        return jnp.logical_and(it < max_sweeps, delta > tol)

    def body(state):
        tau, nu, _, it = state
        sigma_diag, mu, _, _ = _posterior_marginals(K, tau, nu, precision)
        tau_c = jnp.maximum(1.0 / jnp.maximum(sigma_diag, _TAU_MIN) - tau, _TAU_MIN)
        nu_c = mu / jnp.maximum(sigma_diag, _TAU_MIN) - nu
        s2_c = 1.0 / tau_c
        mu_c = nu_c * s2_c
        _, mu_hat, s2_hat = _tilted_moments(lik, tl, y, mu_c, s2_c, order)
        tau_new = jnp.maximum(1.0 / jnp.maximum(s2_hat, _TAU_MIN) - tau_c, 0.0)
        nu_new = mu_hat / jnp.maximum(s2_hat, _TAU_MIN) - nu_c
        tau_d = ((1.0 - damping) * tau + damping * tau_new) * mask
        nu_d = ((1.0 - damping) * nu + damping * nu_new) * mask
        delta = jnp.max(jnp.abs(tau_d - tau) + jnp.abs(nu_d - nu))
        return tau_d, nu_d, delta, it + 1

    big = jnp.asarray(jnp.inf, dtype=K.dtype)
    tau, nu, _, _ = jax.lax.while_loop(cond, body, (zeros, zeros, big, 0))
    return tau, nu


def _prep(gp: GP, lik: Likelihood, theta_simil, theta_noise, theta_lik, x, y, mask):
    x, y = _as_xy(gp, x, y)
    n = x.shape[0]
    ts = jnp.asarray(theta_simil, dtype=x.dtype).reshape(gp.n_theta_simil)
    tn = jnp.asarray(theta_noise, dtype=x.dtype).reshape(gp.n_theta_noise)
    tl = jnp.asarray(theta_lik, dtype=x.dtype).reshape(lik.n_theta)
    if mask is None:
        mask = jnp.ones((n,), dtype=x.dtype)
    else:
        mask = jnp.asarray(mask, dtype=x.dtype)
    return x, y, ts, tn, tl, mask


def ep_fit(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    y,
    theta_noise=None,
    mask=None,
    max_sweeps: int = 60,
    tol: float = 1e-8,
    damping: float = 0.7,
    order: int = 32,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> EPPosterior:
    """Run damped parallel EP to convergence and package the posterior.

    ``gp.noise`` participates only as diagonal jitter on K, like laplace.
    """
    if theta_noise is None:
        theta_noise = jnp.zeros((gp.n_theta_noise,))
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = masked_cov(gp, ts, tn, x, mask)
    tau, nu = _ep_sweeps(lik, tl, K, y, mask, max_sweeps, tol, damping, order, precision)
    _, _, L, alpha = _posterior_marginals(K, tau, nu, precision)
    return EPPosterior(ts, tn, tl, x, y, tau, nu, L, alpha, mask)


def ep_lml(
    gp: GP,
    lik: Likelihood,
    theta_simil,
    theta_lik,
    x,
    y,
    theta_noise=None,
    mask=None,
    max_sweeps: int = 60,
    tol: float = 1e-8,
    damping: float = 0.7,
    order: int = 32,
    precision: str | None = linalg.ACCURATE_PRECISION,
) -> Array:
    """EP approximation of the log marginal likelihood.

    Derivation (equivalent to GPML eq. 3.65, in the unnormalized-site form
    that is padding-safe — tau = nu = 0 sites contribute exactly zero):

        log Z_EP = log ∫ N(f;0,K) prod_i exp(nu_i f_i - tau_i f_i^2/2) df
                 + sum_i [ log Zhat_i - log ∫ N(f; mu_c, s2_c) t_i(f) df ]

    first term = -sum log L_ii + 1/2 nu^T Sigma nu; the per-site correction
    has the closed form below.  Sites (and only sites) are stop_gradient'd:
    log Z_EP is stationary in them at the fixed point, so jax.grad returns
    the exact hyperparameter gradient (module docstring).
    """
    if theta_noise is None:
        theta_noise = jnp.zeros((gp.n_theta_noise,))
    x, y, ts, tn, tl, mask = _prep(gp, lik, theta_simil, theta_noise, theta_lik, x, y, mask)
    K = masked_cov(gp, ts, tn, x, mask)
    sg = jax.lax.stop_gradient
    tau, nu = _ep_sweeps(
        lik, sg(tl), sg(K), y, mask, max_sweeps, tol, damping, order, precision
    )
    sigma_diag, mu, L, alpha = _posterior_marginals(K, tau, nu, precision)
    # cavities from the (differentiable) posterior marginals
    tau_c = jnp.maximum(1.0 / jnp.maximum(sigma_diag, _TAU_MIN) - tau, _TAU_MIN)
    nu_c = mu / jnp.maximum(sigma_diag, _TAU_MIN) - nu
    s2_c = 1.0 / tau_c
    mu_c = nu_c * s2_c
    logZhat, _, _ = _tilted_moments(lik, tl, y, mu_c, s2_c, order)
    # log ∫ N(f; mu_c, s2_c) exp(nu f - tau f^2/2) df, per site:
    prec_t = tau_c + tau
    log_site_int = (
        -0.5 * jnp.log1p(tau * s2_c)
        + 0.5 * (nu_c + nu) ** 2 / prec_t
        - 0.5 * nu_c * nu_c * s2_c
    )
    corr = (logZhat - log_site_int) * mask
    half_quad = 0.5 * jnp.dot(nu, mu)  # nu^T Sigma nu / 2  (mu = Sigma nu)
    logdet_half = jnp.sum(jnp.log(jnp.diagonal(L)))  # padded rows: log 1
    return -logdet_half + half_quad + jnp.sum(corr)


def ep_predict(gp: GP, post: EPPosterior, z) -> tuple[Array, Array]:
    """Latent predictive mean/std at z (GPML Alg. 3.6 prediction):

        mu*      = K*^T alpha
        sigma*^2 = k(z,z) - || L^{-1} (S^0.5 K*) ||^2 per column

    Noise-free latent bands, same semantics as gp.predict / laplace_predict.
    """
    z = jnp.atleast_2d(jnp.asarray(z))
    if z.shape[-1] != gp.ndim:
        z = z.reshape(-1, gp.ndim)
    kstar = gp.simil.matrix(post.theta_simil, post.x, z) * post.mask[:, None]
    mu = kstar.T @ post.alpha
    sw = _safe_sqrt(post.tau_site)
    v = linalg.trsm_lower(post.chol_b, sw[:, None] * kstar)
    prior = gp.simil.diag_matrix(post.theta_simil, z)
    var = prior - jnp.sum(v * v, axis=0)
    return mu, jnp.sqrt(jnp.maximum(var, 0.0))


def ep_predict_prob(
    gp: GP, lik: Likelihood, post: EPPosterior, z, order: int = 32
) -> Array:
    """Predictive p(y=1|z); probit analytic, Gauss-Hermite otherwise."""
    from gogp.gp.laplace import predict_expect

    mu, sd = ep_predict(gp, post, z)
    if lik is bernoulli_probit:
        return norm.cdf(mu / jnp.sqrt(1.0 + sd * sd))
    one = jnp.ones((), dtype=mu.dtype)
    return predict_expect(
        lambda f: jnp.exp(lik.logp(post.theta_lik, f, one)), mu, sd * sd, order
    )


def compile_ep_serving(gp: GP, post: EPPosterior):
    """EPPosterior -> gp.serve.ServingPosterior (same algebra as the
    Laplace serving bridge: alpha stays alpha, W_serve = L_B^{-1} diag(S^0.5))."""
    from gogp.gp.serve import ServingPosterior

    w = linalg.tril_inv(post.chol_b) * _safe_sqrt(post.tau_site)[None, :]
    return ServingPosterior(
        post.theta_simil, post.theta_noise, post.x, post.alpha, w, post.mask
    )


def make_ep_logp(
    gp: GP,
    lik: Likelihood,
    x,
    y,
    mask=None,
    max_sweeps: int = 60,
    tol: float = 1e-8,
    damping: float = 0.7,
    order: int = 32,
    precision: str | None = linalg.ACCURATE_PRECISION,
):
    """Flat-vector hyperparameter log-density (Observe-protocol layout,
    [log theta_simil..., log theta_noise..., log theta_lik...]).  Returns
    (logp, n_params) — plugs into every engine in infer/ unchanged."""
    nts, ntn, ntl = gp.n_theta_simil, gp.n_theta_noise, lik.n_theta

    def logp(v):
        v = jnp.asarray(v)
        theta = jnp.exp(v)
        return ep_lml(
            gp, lik, theta[:nts], theta[nts + ntn :], x, y,
            theta_noise=theta[nts : nts + ntn], mask=mask,
            max_sweeps=max_sweeps, tol=tol, damping=damping, order=order,
            precision=precision,
        )

    return logp, nts + ntn + ntl
