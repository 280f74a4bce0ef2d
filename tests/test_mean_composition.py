"""Mean functions by composition — documentation-by-test.

The reference is zero-mean only (gp/gp.go never subtracts a trend; its
Evaluate loop normalizes Y instead, tutorial/tutorial.go:78-86).  This
framework needs no mean-function machinery either: log-densities are plain
functions of the flat parameter vector, so a parametric mean composes as

    logp(v) = gp_observe(gp, v[k:], x=x, y=y - mean(v[:k], x)) + priors

with the k mean coefficients (signed — they live OUTSIDE the exp-transform
boundary because the user slices them off before gp_observe) leading the
vector, and prediction adds the mean back.  These tests pin that pattern
end-to-end with MLE so it stays working.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core
from gogp.infer import mle
from gogp.kernels import rbf, uniform_noise
from gogp.models.params import gp_observe


def _mean(c, x):
    """Linear trend c0 + c1 * x."""
    return c[0] + c[1] * x[:, 0]


def test_linear_trend_plus_gp_residual():
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    k = 2  # mean coefficients
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 10.0, size=(40, 1)), axis=0))
    true_c = np.array([1.5, -0.7])
    y = jnp.asarray(
        true_c[0] + true_c[1] * np.asarray(x[:, 0])
        + 0.3 * np.sin(2.0 * np.asarray(x[:, 0]))
        + 0.02 * rng.normal(size=40)
    )

    def logp(v):
        resid = y - _mean(v[:k], x)
        return gp_observe(gp, v[k:], x=x, y=resid)

    v0 = jnp.zeros(k + gp.n_theta)
    res = mle.adam(jax.value_and_grad(logp), v0, iters=600, rate=0.05)
    c_hat = np.asarray(res.x[:k])
    # the trend coefficients are identified to ~the GP amplitude scale
    assert abs(c_hat[1] - true_c[1]) < 0.1, c_hat

    # prediction: GP on residuals + mean added back
    theta = jnp.exp(res.x[k:])
    z = jnp.linspace(0.0, 10.0, 21)[:, None]
    mu_r, sigma = core.predict(
        gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil:],
        x, y - _mean(res.x[:k], x), z,
    )
    mu = mu_r + _mean(res.x[:k], z)
    # in-range prediction tracks the true function closely
    truth = true_c[0] + true_c[1] * np.asarray(z[:, 0]) + 0.3 * np.sin(
        2.0 * np.asarray(z[:, 0])
    )
    assert float(jnp.max(jnp.abs(mu - truth))) < 0.15
    assert np.all(np.asarray(sigma) >= 0.0)


def test_mean_coefficients_are_signed():
    # the mean slots pass through NO exp-transform: negative optima are
    # representable directly (unlike kernel thetas, gp/gp.go:377-381)
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(1)
    x = jnp.asarray(np.sort(rng.uniform(0.0, 5.0, size=(20, 1)), axis=0))
    y = jnp.asarray(-2.0 + 0.0 * np.asarray(x[:, 0]) + 0.01 * rng.normal(size=20))

    def logp(v):
        return gp_observe(gp, v[1:], x=x, y=y - v[0])

    res = mle.adam(jax.value_and_grad(logp), jnp.zeros(1 + gp.n_theta),
                   iters=400, rate=0.1)
    assert abs(float(res.x[0]) - (-2.0)) < 0.2
