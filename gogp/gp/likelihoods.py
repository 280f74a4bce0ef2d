"""Observation likelihoods for latent-GP models.

The reference handles exactly one non-Gaussian observation model — the
anynoise study's Laplace noise, expressed as an Exponential prior on the
absolute residual between observed and *latent* outputs
(/root/reference/tutorial/anynoise/model/model.go:40-43) with the latent
outputs inferred as free parameters.  That pattern (latent f per data point
+ pointwise log-likelihood logp(theta, f_i, y_i)) generalizes to the whole
non-conjugate GP family: classification, counts, heavy-tailed regression.

A :class:`Likelihood` is the typed version of that pattern: an immutable
spec around a *pure scalar* log-density

    logp(theta, f, y) -> log p(y | f, theta)

with ``theta`` a 1-D array of ``n_theta`` positive parameters (natural
scale — the flat-vector Observe protocol exp-transforms, SURVEY §2.1-1, so
optimizer/sampler parameters are their logs, exactly like kernel thetas).
First and second derivatives w.r.t. ``f`` come from ``jax.grad`` — there is
no hand-derived Hessian table, mirroring how ``jax.grad`` replaced the
reference's AD-codegen kernels (kernel/ad/, SURVEY §2 C5/C6).

Consumers: :mod:`gogp.gp.laplace` (Laplace approximation),
``svgp_elbo(likelihood=lik.for_svgp(theta))`` (variational, Gauss-Hermite),
and the MCMC engines via latent-augmented logps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln
from jax.scipy.stats import norm

Array = jax.Array

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class Likelihood:
    """Pointwise observation model ``logp(theta, f, y) -> scalar``.

    ``log_concave`` declares concavity of logp in ``f`` (given y): the
    Laplace Newton solve is exact for log-concave models, and its implicit
    hyperparameter gradient (one-differentiable-Newton-step trick,
    laplace.py) is exact only there.  Non-log-concave models (student_t)
    clip the negative curvature and document the gradient as approximate.
    """

    n_theta: int
    logp: Callable[[Array, Array, Array], Array]
    name: str = "likelihood"
    log_concave: bool = True

    def __call__(self, theta, f, y):
        return self.logp(jnp.asarray(theta), f, y)

    def sum_logp(self, theta, f, y, mask=None):
        """Masked total log-likelihood over a batch of points."""
        theta = jnp.asarray(theta)
        ll = jax.vmap(lambda fi, yi: self.logp(theta, fi, yi))(f, y)
        if mask is not None:
            ll = ll * mask
        return jnp.sum(ll)

    def grads(self, theta, f, y, mask=None):
        """(d logp/df, -d2 logp/df2) per point, masked.

        The negative curvature W = -logp'' is the Laplace weight matrix
        diagonal (GPML §3.4).  Both come from jax.grad of the scalar logp —
        one fused vmap, no per-point tapes (contrast the reference's O(n^2)
        tape runs for kernel derivatives, gp/gp.go:109-156).
        """
        theta = jnp.asarray(theta)
        g1 = jax.grad(self.logp, argnums=1)
        g2 = jax.grad(g1, argnums=1)
        gll = jax.vmap(lambda fi, yi: g1(theta, fi, yi))(f, y)
        w = jax.vmap(lambda fi, yi: -g2(theta, fi, yi))(f, y)
        if mask is not None:
            gll = gll * mask
            w = w * mask
        return gll, w

    def for_svgp(self, theta) -> Callable[[Array, Array], Array]:
        """Adapt to svgp_elbo's ``likelihood(y, f)`` callable (theta bound)."""
        theta = jnp.asarray(theta)
        return lambda y, f: self.logp(theta, f, y)


# -- built-in families -----------------------------------------------------


def _gaussian_logp(theta, f, y):
    sigma = theta[0]
    z = (y - f) / sigma
    return -0.5 * (z * z + _LOG_2PI) - jnp.log(sigma)


#: Gaussian observation noise, theta = [sigma].  Exists so the Laplace path
#: can be validated against the exact GP: with this likelihood the Laplace
#: approximation is exact and laplace_lml == gp.lml with noise sigma^2.
gaussian = Likelihood(1, _gaussian_logp, "gaussian")


def _bernoulli_logit_logp(theta, f, y):
    # y in {0, 1}; p(y=1|f) = sigmoid(f).  log p = y*f - log(1+e^f),
    # computed via log_sigmoid for stability at |f| >> 1.
    del theta
    return y * f - jnp.logaddexp(0.0, f)


#: Logistic (sigmoid) binary classification, y in {0,1}, no theta.
bernoulli_logit = Likelihood(0, _bernoulli_logit_logp, "bernoulli_logit")


def _bernoulli_probit_logp(theta, f, y):
    # y in {0, 1} mapped to signs: log Phi((2y-1) f).
    del theta
    return norm.logcdf((2.0 * y - 1.0) * f)


#: Probit binary classification, y in {0,1}, no theta.  Predictive class
#: probability is analytic under a Gaussian latent (laplace.predict_prob).
bernoulli_probit = Likelihood(0, _bernoulli_probit_logp, "bernoulli_probit")


def _poisson_logp(theta, f, y):
    # log link: rate = exp(f); y a count.
    del theta
    return y * f - jnp.exp(f) - gammaln(y + 1.0)


#: Poisson counts with log link, no theta.
poisson = Likelihood(0, _poisson_logp, "poisson")


def _laplace_logp(theta, f, y):
    b = theta[0]
    return -jnp.abs(y - f) / b - jnp.log(2.0 * b)


#: Laplace (double-exponential) noise, theta = [scale b] — the anynoise
#: study's observation model (anynoise/model/model.go:40-43 is this plus
#: the constant log 2; SURVEY §2 C11).  Log-concave but not smooth at
#: y == f; the Laplace-approximation Newton solve still converges (the
#: kink has measure zero) but prefer MCMC/SVGP for serious use.
laplace_noise = Likelihood(1, _laplace_logp, "laplace")


def _student_t_logp(theta, f, y):
    sigma, nu = theta[0], theta[1]
    z = (y - f) / sigma
    return (
        gammaln(0.5 * (nu + 1.0))
        - gammaln(0.5 * nu)
        - 0.5 * jnp.log(nu * jnp.pi)
        - jnp.log(sigma)
        - 0.5 * (nu + 1.0) * jnp.log1p(z * z / nu)
    )


#: Student-t observation noise, theta = [sigma, nu].  NOT log-concave in f
#: (curvature flips sign in the tails), so the Laplace path clips W >= 0 and
#: hyperparameter gradients through laplace_lml are approximate there.
student_t = Likelihood(2, _student_t_logp, "student_t", log_concave=False)
