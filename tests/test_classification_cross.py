"""Cross-engine classification: Laplace vs SVGP on the same task.

Two entirely different approximations (Newton mode-finding vs whitened
variational + Gauss-Hermite) of the same latent-GP Bernoulli model should
broadly agree — the same cross-validation style as tests/test_cross_engine
for samplers (reference analogue: serial-vs-parallel equivalence,
gp/gp_test.go:123-132, re-expressed as independent-implementations
agreement)."""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core, laplace, likelihoods, sparse
from gogp.kernels import normal as rbf


def _data(seed=0, n=48):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    p = 1.0 / (1.0 + np.exp(-3.0 * x[:, 0]))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return jnp.asarray(x), jnp.asarray(y)


def test_laplace_and_svgp_agree_on_latent():
    x, y = _data()
    gp = core.GP(1, rbf.scaled())
    ts = jnp.asarray([2.0, 1.0])
    lik = likelihoods.bernoulli_logit

    post = laplace.laplace_fit(gp, lik, ts, jnp.zeros(0), x, y)
    z = jnp.asarray([[-2.0], [-0.5], [0.5], [2.0]])
    mu_lap, sd_lap = laplace.laplace_predict(gp, post, z)

    # SVGP with inducing points = full data (no sparsity error), fixed theta.
    params, trace = sparse.svgp_fit(
        gp, x, y, m=48, key=jax.random.PRNGKey(0), iters=800, rate=0.05,
        likelihood=lik.for_svgp(jnp.zeros(0)),
        log_theta0=jnp.log(ts), train_theta=False,
    )
    theta = jnp.exp(params.log_theta)
    mu_sv, var_sv = sparse.svgp_predict(
        gp, theta[: gp.n_theta_simil], params.state, z
    )
    assert float(trace[-1]) > float(trace[0])
    # latent means agree to a few tenths; both see the same sign structure
    np.testing.assert_allclose(np.asarray(mu_sv), np.asarray(mu_lap), atol=0.5)
    assert np.all(np.sign(np.asarray(mu_sv)) == np.sign(np.asarray(mu_lap)))
    # predicted class probabilities agree loosely
    p_lap = np.asarray(laplace.laplace_predict_prob(gp, lik, post, z))
    one = jnp.ones(())
    p_sv = np.asarray(laplace.predict_expect(
        lambda f: jnp.exp(lik.logp(jnp.zeros(0), f, one)), mu_sv, var_sv, order=32
    ))
    np.testing.assert_allclose(p_sv, p_lap, atol=0.15)
