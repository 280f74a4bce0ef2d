"""Laplace approximation for non-Gaussian likelihoods.

Anchors:
- With the Gaussian likelihood the approximation is EXACT, so laplace_lml /
  laplace_predict must match the exact gp.lml / gp.predict (the same style
  of oracle the golden suite uses, reference gp/gp_test.go).
- Hyperparameter gradients (implicit one-Newton-step trick) vs central
  finite differences — the reference's own gradient test strategy
  (gp/gp_test.go:168-171, SURVEY §4.2).
- Mode stationarity: at the converged mode, grad_ll == K^{-1} f_hat.
"""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core, laplace, likelihoods
from gogp.kernels import matern32, normal as rbf
from gogp.kernels.noise import constant_noise


def _toy_class_data(seed=0, n=24):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    p = 1.0 / (1.0 + np.exp(-2.5 * x[:, 0]))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return jnp.asarray(x), jnp.asarray(y)


class TestGaussianExactness:
    def test_lml_matches_exact_gp(self):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(0, 6, size=(14, 1)))
        y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.normal(size=14))
        sigma = 0.3
        gp_lat = core.GP(1, rbf.scaled())  # jitter-only noise (1e-10 var)
        gp_exact = core.GP(1, rbf.scaled(), noise=constant_noise(sigma))
        ts = jnp.asarray([1.4, 0.9])
        got = laplace.laplace_lml(gp_lat, likelihoods.gaussian, ts, jnp.asarray([sigma]), x, y)
        want = core.lml(gp_exact, ts, jnp.zeros((0,)), x, y)
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-7)

    def test_predict_matches_exact_gp(self):
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.uniform(0, 6, size=(12, 1)))
        y = jnp.asarray(np.cos(np.asarray(x)[:, 0]))
        sigma = 0.2
        gp_lat = core.GP(1, rbf.scaled())
        gp_exact = core.GP(1, rbf.scaled(), noise=constant_noise(sigma))
        ts = jnp.asarray([1.0, 1.2])
        z = jnp.asarray([[0.5], [3.3], [7.0]])
        post = laplace.laplace_fit(gp_lat, likelihoods.gaussian, ts, jnp.asarray([sigma]), x, y)
        mu, sd = laplace.laplace_predict(gp_lat, post, z)
        mu_w, sd_w = core.predict(gp_exact, ts, jnp.zeros((0,)), x, y, z)
        np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_w), atol=1e-7)
        np.testing.assert_allclose(np.asarray(sd), np.asarray(sd_w), atol=1e-6)


class TestGradients:
    def _fd_check(self, lik, y, theta0, atol=2e-5):
        rng = np.random.default_rng(3)
        x = jnp.asarray(np.sort(rng.uniform(-3, 3, size=(10, 1)), axis=0))
        gp = core.GP(1, rbf.scaled())
        logp, n_params = laplace.make_laplace_logp(gp, lik, x, y)
        assert n_params == theta0.shape[0]
        g = jax.grad(logp)(theta0)
        eps = 1e-5
        for i in range(n_params):
            e = jnp.zeros_like(theta0).at[i].set(eps)
            fd = (logp(theta0 + e) - logp(theta0 - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd), atol=atol,
                                       err_msg=f"component {i} of {lik.name}")

    def test_bernoulli_logit_fd(self):
        x, y = _toy_class_data()
        y = y[:10]
        theta0 = jnp.asarray([0.3, -0.2])
        self._fd_check(likelihoods.bernoulli_logit, y, theta0)

    def test_poisson_fd(self):
        rng = np.random.default_rng(4)
        y = jnp.asarray(rng.poisson(3.0, size=10).astype(np.float64))
        theta0 = jnp.asarray([0.1, 0.4])
        self._fd_check(likelihoods.poisson, y, theta0)

    def test_gaussian_fd_includes_lik_theta(self):
        rng = np.random.default_rng(5)
        y = jnp.asarray(rng.normal(size=10))
        theta0 = jnp.asarray([0.2, 0.1, np.log(0.35)])
        self._fd_check(likelihoods.gaussian, y, theta0)


class TestClassification:
    def test_probit_separable(self):
        x, y = _toy_class_data(seed=6, n=32)
        gp = core.GP(1, rbf.scaled())
        ts = jnp.asarray([3.0, 1.0])
        post = laplace.laplace_fit(gp, likelihoods.bernoulli_probit, ts, jnp.zeros((0,)), x, y)
        z = jnp.asarray([[-2.5], [0.0], [2.5]])
        p = laplace.laplace_predict_prob(gp, likelihoods.bernoulli_probit, post, z)
        p = np.asarray(p)
        assert np.all((p >= 0) & (p <= 1))
        assert p[0] < 0.25 and p[2] > 0.75
        assert p[0] < p[1] < p[2]

    def test_probit_analytic_matches_quadrature(self):
        x, y = _toy_class_data(seed=7, n=20)
        gp = core.GP(1, rbf.scaled())
        ts = jnp.asarray([2.0, 0.8])
        post = laplace.laplace_fit(gp, likelihoods.bernoulli_probit, ts, jnp.zeros((0,)), x, y)
        z = jnp.linspace(-3, 3, 9).reshape(-1, 1)
        p_analytic = laplace.laplace_predict_prob(gp, likelihoods.bernoulli_probit, post, z)
        mu, sd = laplace.laplace_predict(gp, post, z)
        one = jnp.ones(())
        p_quad = laplace.predict_expect(
            lambda f: jnp.exp(likelihoods.bernoulli_probit.logp(post.theta_lik, f, one)),
            mu, sd * sd, order=64,
        )
        np.testing.assert_allclose(np.asarray(p_analytic), np.asarray(p_quad), atol=1e-6)

    def test_logit_mle_improves(self):
        from gogp.infer import mle

        x, y = _toy_class_data(seed=8, n=28)
        gp = core.GP(1, rbf.scaled())
        logp, n_params = laplace.make_laplace_logp(gp, likelihoods.bernoulli_logit, x, y)
        v0 = jnp.asarray([0.0, 0.0])
        res = mle.adam(jax.value_and_grad(logp), v0, iters=150, rate=0.05)
        assert float(res.value) > float(logp(v0))


class TestModeAndMasking:
    def test_poisson_mode_stationarity(self):
        rng = np.random.default_rng(9)
        x = jnp.asarray(np.sort(rng.uniform(0, 5, size=(16, 1)), axis=0))
        y = jnp.asarray(rng.poisson(2.0, size=16).astype(np.float64))
        gp = core.GP(1, matern32.scaled())
        ts = jnp.asarray([1.0, 1.5])
        post = laplace.laplace_fit(gp, likelihoods.poisson, ts, jnp.zeros((0,)), x, y)
        K = core.masked_cov(gp, post.theta_simil, post.theta_noise, post.x, post.mask)
        np.testing.assert_allclose(
            np.asarray(K @ post.grad_ll), np.asarray(post.f_hat), atol=1e-7
        )

    def test_padding_invariance(self):
        x, y = _toy_class_data(seed=10, n=12)
        gp = core.GP(1, rbf.scaled())
        ts = jnp.asarray([1.5, 0.7])
        lik = likelihoods.bernoulli_logit
        tl = jnp.zeros((0,))
        lml_plain = laplace.laplace_lml(gp, lik, ts, tl, x, y)
        pad = 6
        xp = jnp.concatenate([x, jnp.full((pad, 1), 99.0)])
        yp = jnp.concatenate([y, jnp.zeros((pad,))])
        mask = jnp.concatenate([jnp.ones((12,)), jnp.zeros((pad,))])
        lml_pad = laplace.laplace_lml(gp, lik, ts, tl, xp, yp, mask=mask)
        np.testing.assert_allclose(float(lml_plain), float(lml_pad), atol=1e-8)
        post = laplace.laplace_fit(gp, lik, ts, tl, x, y)
        post_p = laplace.laplace_fit(gp, lik, ts, tl, xp, yp, mask=mask)
        z = jnp.asarray([[0.3], [-1.1]])
        mu, sd = laplace.laplace_predict(gp, post, z)
        mu_p, sd_p = laplace.laplace_predict(gp, post_p, z)
        np.testing.assert_allclose(np.asarray(mu), np.asarray(mu_p), atol=1e-8)
        np.testing.assert_allclose(np.asarray(sd), np.asarray(sd_p), atol=1e-8)

    def test_jit_and_vmap(self):
        x, y = _toy_class_data(seed=11, n=10)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_logit
        logp, _ = laplace.make_laplace_logp(gp, lik, x, y)
        v = jnp.asarray([0.2, -0.1])
        np.testing.assert_allclose(float(jax.jit(logp)(v)), float(logp(v)), atol=1e-10)
        vs = jnp.stack([v, v + 0.1, v - 0.1])
        batched = jax.vmap(logp)(vs)
        seq = jnp.stack([logp(vi) for vi in vs])
        np.testing.assert_allclose(np.asarray(batched), np.asarray(seq), atol=1e-8)


class TestStudentT:
    def test_robust_regression_runs_and_downweights_outlier(self):
        rng = np.random.default_rng(12)
        n = 20
        x = np.sort(rng.uniform(0, 6, size=(n, 1)), axis=0)
        y = np.sin(x[:, 0]) + 0.05 * rng.normal(size=n)
        y[7] += 5.0  # gross outlier
        x, y = jnp.asarray(x), jnp.asarray(y)
        gp = core.GP(1, rbf.scaled())
        ts = jnp.asarray([1.0, 1.0])
        tl = jnp.asarray([0.1, 3.0])  # sigma, nu
        post = laplace.laplace_fit(gp, likelihoods.student_t, ts, tl, x, y)
        ll = laplace.laplace_lml(gp, likelihoods.student_t, ts, tl, x, y)
        assert np.isfinite(float(ll))
        # the mode should NOT chase the outlier: compare against an exact
        # Gaussian GP with the same sigma, whose mean is pulled far more.
        gp_g = core.GP(1, rbf.scaled(), noise=constant_noise(0.1))
        mu_g, _ = core.predict(gp_g, ts, jnp.zeros((0,)), x, y, x[7:8])
        mu_t, _ = laplace.laplace_predict(gp, post, x[7:8])
        truth = float(jnp.sin(x[7, 0]))
        assert abs(float(mu_t[0]) - truth) < abs(float(mu_g[0]) - truth)


class TestServing:
    def test_serving_cache_matches_direct_predict(self):
        x, y = _toy_class_data(seed=13, n=20)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_probit
        ts = jnp.asarray([2.0, 0.9])
        post = laplace.laplace_fit(gp, lik, ts, jnp.zeros(0), x, y)
        sp = laplace.compile_laplace_serving(gp, post)
        from gogp.gp.serve import serve_predict

        z = jnp.linspace(-3, 3, 7).reshape(-1, 1)
        mu_d, sd_d = laplace.laplace_predict(gp, post, z)
        mu_s, sd_s = serve_predict(gp, sp, z)
        np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_d), atol=1e-9)
        np.testing.assert_allclose(np.asarray(sd_s), np.asarray(sd_d), atol=1e-9)
        p_d = laplace.laplace_predict_prob(gp, lik, post, z)
        p_s = laplace.serve_predict_prob(gp, lik, sp, post.theta_lik, z)
        np.testing.assert_allclose(np.asarray(p_s), np.asarray(p_d), atol=1e-9)


class TestOneVsRest:
    def _three_class_data(self, seed=14, n=45):
        rng = np.random.default_rng(seed)
        x = np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0)
        labels = np.digitize(x[:, 0], [-1.0, 1.0])  # 0 | 1 | 2 by region
        return jnp.asarray(x), jnp.asarray(labels)

    def test_probs_normalized_and_regions_recovered(self):
        x, labels = self._three_class_data()
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_logit
        ts = jnp.asarray([2.0, 0.8])
        posts = laplace.laplace_fit_ovr(gp, lik, ts, jnp.zeros(0), x, labels, 3)
        z = jnp.asarray([[-2.0], [0.0], [2.0]])
        probs = laplace.laplace_predict_ovr(gp, lik, posts, z)
        probs = np.asarray(probs)
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-12)
        assert list(probs.argmax(axis=1)) == [0, 1, 2]
        assert np.all(probs.max(axis=1) > 0.5)

    def test_batched_fit_matches_sequential(self):
        x, labels = self._three_class_data(seed=15)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_logit
        ts = jnp.asarray([1.5, 1.0])
        posts = laplace.laplace_fit_ovr(gp, lik, ts, jnp.zeros(0), x, labels, 3)
        for c in range(3):
            y_c = (labels == c).astype(jnp.float64)
            p_c = laplace.laplace_fit(gp, lik, ts, jnp.zeros(0), x, y_c)
            np.testing.assert_allclose(
                np.asarray(posts.f_hat[c]), np.asarray(p_c.f_hat), atol=1e-7
            )

    def test_per_class_thetas(self):
        x, labels = self._three_class_data(seed=16)
        gp = core.GP(1, rbf.scaled())
        lik = likelihoods.bernoulli_logit
        ts = jnp.asarray([[1.5, 1.0], [2.0, 0.7], [1.0, 1.2]])
        posts = laplace.laplace_fit_ovr(gp, lik, ts, jnp.zeros((3, 0)), x, labels, 3)
        assert posts.f_hat.shape == (3, x.shape[0])
        p1 = laplace.laplace_fit(gp, lik, ts[1], jnp.zeros(0), x,
                                 (labels == 1).astype(jnp.float64))
        np.testing.assert_allclose(np.asarray(posts.f_hat[1]), np.asarray(p1.f_hat), atol=1e-7)


def test_gradient_finite_under_padding():
    # sqrt(W) at padded rows (W = 0) must carry a ZERO gradient, not NaN —
    # regression for the batched-prefix classify fits (inf * 0 reverse-mode).
    x, y = _toy_class_data(seed=20, n=10)
    gp = core.GP(1, rbf.scaled())
    xp = jnp.concatenate([x, jnp.full((4, 1), 99.0)])
    yp = jnp.concatenate([y, jnp.zeros((4,))])
    mask = jnp.concatenate([jnp.ones((10,)), jnp.zeros((4,))])
    logp, n_params = laplace.make_laplace_logp(
        gp, likelihoods.bernoulli_logit, xp, yp, mask=mask
    )
    g = jax.grad(logp)(jnp.asarray([0.2, -0.1]))
    assert np.all(np.isfinite(np.asarray(g)))
    logp_f, _ = laplace.make_laplace_logp(gp, likelihoods.bernoulli_logit, x, y)
    g_f = jax.grad(logp_f)(jnp.asarray([0.2, -0.1]))
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_f), atol=1e-8)


class TestPrecisionDefaults:
    """Laplace default precision is a tested contract.

    The Newton iteration's K matvecs accumulate product error into the
    mode, so a low-precision product (TF32, JAX's default for float32
    products on the GPU) leaves a stationarity residual at the returned
    mode.  The public entry points therefore default to
    linalg.ACCURATE_PRECISION.
    """

    def test_default_is_accurate_precision(self):
        import inspect

        from gogp.gp import ep as ep_mod
        from gogp.ops import linalg

        for fn in (
            laplace.laplace_fit,
            laplace.laplace_lml,
            laplace.make_laplace_logp,
            laplace.serve_predict_prob,
            ep_mod.ep_fit,
            ep_mod.ep_lml,
            ep_mod.make_ep_logp,
        ):
            default = inspect.signature(fn).parameters["precision"].default
            assert default == linalg.ACCURATE_PRECISION, fn.__name__

    def test_default_mode_is_stationary(self):
        # At the converged mode, f_hat = K grad_ll exactly.  Under the
        # SHIPPED DEFAULT precision this must be tiny (exact on the CPU).
        x, y = _toy_class_data(seed=11, n=48)
        gp = core.GP(1, rbf.scaled())
        post = laplace.laplace_fit(
            gp, likelihoods.bernoulli_logit, jnp.asarray([1.5, 1.0]), jnp.zeros(0), x, y
        )
        K = core.masked_cov(gp, post.theta_simil, post.theta_noise, post.x, post.mask)
        resid = float(jnp.max(jnp.abs(K @ post.grad_ll - post.f_hat)))
        assert resid < 1e-7
