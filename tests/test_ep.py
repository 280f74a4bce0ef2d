"""Expectation propagation (parallel-update EP).

Anchors, mirroring test_laplace:
- Gaussian likelihood: EP is exact after one sweep — ep_lml == exact
  gp.lml, ep_predict == gp.predict.
- FD hyperparameter gradients through the stop-gradient-sites fixed-point
  trick (log Z_EP stationarity).
- The generic Gauss-Hermite tilted-moment path must reproduce the analytic
  probit fast path.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core, ep, laplace, likelihoods
from gogp.kernels import normal as rbf
from gogp.kernels.noise import constant_noise


def _class_data(seed=0, n=24):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    p = 1.0 / (1.0 + np.exp(-2.5 * x[:, 0]))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return jnp.asarray(x), jnp.asarray(y)


class TestGaussianExactness:
    def test_lml_and_predict_match_exact_gp(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(0, 6, size=(14, 1)))
        y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=14))
        sigma = 0.3
        gp_lat = core.GP(1, rbf.scaled())
        gp_exact = core.GP(1, rbf.scaled(), noise=constant_noise(sigma))
        ts = jnp.asarray([1.4, 0.9])
        got = ep.ep_lml(gp_lat, likelihoods.gaussian, ts, jnp.asarray([sigma]), x, y)
        want = core.lml(gp_exact, ts, jnp.zeros(0), x, y)
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
        post = ep.ep_fit(gp_lat, likelihoods.gaussian, ts, jnp.asarray([sigma]), x, y)
        z = jnp.asarray([[0.5], [3.3], [7.0]])
        mu, sd = ep.ep_predict(gp_lat, post, z)
        mu_w, sd_w = core.predict(gp_exact, ts, jnp.zeros(0), x, y, z)
        np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_w), atol=1e-6)
        np.testing.assert_allclose(np.asarray(sd), np.asarray(sd_w), atol=1e-6)


class TestProbit:
    def test_agrees_with_laplace_and_is_sane(self):
        x, y = _class_data(seed=2, n=30)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_probit
        ts = jnp.asarray([2.0, 0.9])
        post = ep.ep_fit(gp, lik, ts, jnp.zeros(0), x, y)
        lpost = laplace.laplace_fit(gp, lik, ts, jnp.zeros(0), x, y)
        z = jnp.linspace(-2.5, 2.5, 9).reshape(-1, 1)
        p_ep = np.asarray(ep.ep_predict_prob(gp, lik, post, z))
        p_lap = np.asarray(laplace.laplace_predict_prob(gp, lik, lpost, z))
        assert np.all((p_ep >= 0) & (p_ep <= 1))
        assert np.all(np.diff(p_ep) > -0.05)  # essentially monotone data
        np.testing.assert_allclose(p_ep, p_lap, atol=0.12)
        # EP's latent bands should be at least as wide as Laplace's at the
        # boundary (Laplace underestimates the probit posterior variance).
        _, sd_ep = ep.ep_predict(gp, post, jnp.asarray([[0.0]]))
        _, sd_lap = laplace.laplace_predict(gp, lpost, jnp.asarray([[0.0]]))
        assert float(sd_ep[0]) > 0.5 * float(sd_lap[0])

    def test_gauss_hermite_path_matches_analytic_probit(self):
        x, y = _class_data(seed=3, n=20)
        gp = core.GP(1, rbf.scaled())
        ts = jnp.asarray([1.5, 1.0])
        analytic = likelihoods.bernoulli_probit
        # same logp, but a distinct object: forces the generic GH path
        generic = dataclasses.replace(likelihoods.bernoulli_probit, name="probit_gh")
        p1 = ep.ep_fit(gp, analytic, ts, jnp.zeros(0), x, y)
        p2 = ep.ep_fit(gp, generic, ts, jnp.zeros(0), x, y, order=64)
        np.testing.assert_allclose(
            np.asarray(p1.tau_site), np.asarray(p2.tau_site), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(p1.nu_site), np.asarray(p2.nu_site), atol=1e-5
        )
        l1 = ep.ep_lml(gp, analytic, ts, jnp.zeros(0), x, y)
        l2 = ep.ep_lml(gp, generic, ts, jnp.zeros(0), x, y, order=64)
        np.testing.assert_allclose(float(l1), float(l2), atol=1e-6)


class TestGradientsAndProtocol:
    def _fd(self, lik, y, theta0, atol=5e-5):
        rng = np.random.default_rng(4)
        x = jnp.asarray(np.sort(rng.uniform(-3, 3, size=(10, 1)), axis=0))
        gp = core.GP(1, rbf.scaled())
        logp, n_params = ep.make_ep_logp(gp, lik, x, y, tol=1e-12)
        assert n_params == theta0.shape[0]
        g = jax.grad(logp)(theta0)
        eps = 1e-5
        for i in range(n_params):
            e = jnp.zeros_like(theta0).at[i].set(eps)
            fd = (logp(theta0 + e) - logp(theta0 - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd), atol=atol,
                                       err_msg=f"component {i} of {lik.name}")

    def test_probit_fd(self):
        _, y = _class_data(seed=5, n=10)
        self._fd(likelihoods.bernoulli_probit, y, jnp.asarray([0.3, -0.2]))

    def test_gaussian_fd_includes_lik_theta(self):
        rng = np.random.default_rng(6)
        y = jnp.asarray(rng.normal(size=10))
        self._fd(likelihoods.gaussian, y, jnp.asarray([0.2, 0.1, np.log(0.35)]))

    def test_padding_invariance_and_jit(self):
        x, y = _class_data(seed=7, n=12)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_probit
        ts = jnp.asarray([1.5, 0.7])
        ll = ep.ep_lml(gp, lik, ts, jnp.zeros(0), x, y)
        pad = 6
        xp = jnp.concatenate([x, jnp.full((pad, 1), 99.0)])
        yp = jnp.concatenate([y, jnp.zeros((pad,))])
        m = jnp.concatenate([jnp.ones((12,)), jnp.zeros((pad,))])
        ll_pad = ep.ep_lml(gp, lik, ts, jnp.zeros(0), xp, yp, mask=m)
        np.testing.assert_allclose(float(ll), float(ll_pad), atol=1e-7)
        jitted = jax.jit(lambda t: ep.ep_lml(gp, lik, t, jnp.zeros(0), x, y))
        np.testing.assert_allclose(float(jitted(ts)), float(ll), atol=1e-10)

    def test_serving_bridge(self):
        from gogp.gp.serve import serve_predict

        x, y = _class_data(seed=8, n=16)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_probit
        post = ep.ep_fit(gp, lik, jnp.asarray([2.0, 0.8]), jnp.zeros(0), x, y)
        sp = ep.compile_ep_serving(gp, post)
        z = jnp.linspace(-3, 3, 7).reshape(-1, 1)
        mu_d, sd_d = ep.ep_predict(gp, post, z)
        mu_s, sd_s = serve_predict(gp, sp, z)
        np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_d), atol=1e-9)
        np.testing.assert_allclose(np.asarray(sd_s), np.asarray(sd_d), atol=1e-9)


def test_gradient_finite_under_padding():
    # same regression as laplace: padded sites have tau = 0 and sqrt must
    # not poison the gradient.
    x, y = _class_data(seed=9, n=10)
    gp = core.GP(1, rbf.scaled())
    xp = jnp.concatenate([x, jnp.full((4, 1), 99.0)])
    yp = jnp.concatenate([y, jnp.zeros((4,))])
    mask = jnp.concatenate([jnp.ones((10,)), jnp.zeros((4,))])
    logp, _ = ep.make_ep_logp(gp, likelihoods.bernoulli_probit, xp, yp, mask=mask)
    g = jax.grad(logp)(jnp.asarray([0.3, -0.2]))
    assert np.all(np.isfinite(np.asarray(g)))
    logp_f, _ = ep.make_ep_logp(gp, likelihoods.bernoulli_probit, x, y)
    g_f = jax.grad(logp_f)(jnp.asarray([0.3, -0.2]))
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_f), atol=1e-7)
