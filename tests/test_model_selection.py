"""Exact LOO-CV (gp/model_selection.py) vs brute-force n-refit LOO, plus
gradient/padding invariants and the information criteria."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import core, model_selection as ms
from gogp.kernels import matern32, rbf, uniform_noise


def _setup(n=14, seed=0):
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    y = np.sin(1.2 * x[:, 0]) + 0.2 * rng.normal(size=n)
    ts, tn = jnp.asarray([1.1, 0.8]), jnp.asarray([0.25])
    return gp, x, y, ts, tn


class TestAgainstBruteForce:
    def test_loo_equals_n_refits(self):
        gp, x, y, ts, tn = _setup()
        n = len(y)
        res = ms.loo(gp, ts, tn, x, y)
        noise_var = float(tn[0]) ** 2
        for i in range(n):
            keep = np.arange(n) != i
            post = core.absorb(gp, ts, tn, x[keep], y[keep])
            mu, sd = core.predict_from_posterior(gp, post, x[i : i + 1])
            # LOO predicts the NOISY y_i: latent band + noise variance
            want_var = float(sd[0]) ** 2 + noise_var
            assert abs(float(res.mu[i]) - float(mu[0])) < 1e-8
            assert abs(float(res.sigma[i]) ** 2 - want_var) < 1e-8

    def test_total_is_sum_of_gaussian_logps(self):
        gp, x, y, ts, tn = _setup()
        res = ms.loo(gp, ts, tn, x, y)
        want = -0.5 * (
            np.log(2 * np.pi * np.asarray(res.sigma) ** 2)
            + (y - np.asarray(res.mu)) ** 2 / np.asarray(res.sigma) ** 2
        )
        np.testing.assert_allclose(np.asarray(res.logp), want, rtol=1e-10)
        assert abs(float(res.total) - want.sum()) < 1e-8


class TestInvariants:
    def test_padding_invariance(self):
        gp, x, y, ts, tn = _setup(12)
        full = ms.loo(gp, ts, tn, x, y)
        xp = np.concatenate([x, np.zeros((4, 1))])
        yp = np.concatenate([y, np.zeros(4)])
        m = np.concatenate([np.ones(12), np.zeros(4)])
        padded = ms.loo(gp, ts, tn, xp, yp, m)
        np.testing.assert_allclose(
            np.asarray(padded.logp[:12]), np.asarray(full.logp), atol=1e-9
        )
        assert np.all(np.asarray(padded.logp[12:]) == 0.0)
        assert abs(float(padded.total) - float(full.total)) < 1e-8

    def test_gradient_matches_finite_differences(self):
        gp, x, y, ts, tn = _setup(10)

        def f(v):
            return ms.loo_score(gp, v[:2], v[2:], x, y)

        v0 = jnp.concatenate([ts, tn])
        g = np.asarray(jax.grad(f)(v0))
        eps = 1e-6
        for i in range(3):
            vp = np.asarray(v0).copy(); vp[i] += eps
            vm = np.asarray(v0).copy(); vm[i] -= eps
            fd = (float(f(jnp.asarray(vp))) - float(f(jnp.asarray(vm)))) / (2 * eps)
            assert abs(g[i] - fd) < 1e-4 * max(1.0, abs(fd)), (i, g[i], fd)

    def test_jit(self):
        gp, x, y, ts, tn = _setup(10)
        a = float(ms.loo_score(gp, ts, tn, x, y))
        b = float(jax.jit(lambda a1, a2: ms.loo_score(gp, a1, a2, x, y))(ts, tn))
        assert abs(a - b) < 1e-10


class TestCriteria:
    def test_bic_aic_prefer_true_structure(self):
        # data from a matern32 GP with moderate noise: the better-fitting
        # kernel at its MLE should win both criteria vs a mismatched one
        rng = np.random.default_rng(3)
        n = 40
        x = np.sort(rng.uniform(0, 10, size=(n, 1)), axis=0)
        gpm = core.GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise)
        K = np.asarray(gpm.simil.matrix(jnp.asarray([1.5, 1.0]), x, x))
        y = np.linalg.cholesky(K + 0.05**2 * np.eye(n)) @ rng.normal(size=n)

        from gogp.infer import mle
        from gogp.models.params import gp_observe

        def fit(gp):
            f = jax.value_and_grad(lambda v: gp_observe(gp, v, x=jnp.asarray(x), y=jnp.asarray(y)))
            res = mle.adam(f, jnp.zeros(gp.n_theta), iters=400, rate=0.05)
            return float(res.value)

        lml_good = fit(gpm)
        gp_per = core.GP(
            ndim=1,
            simil=core.Kernel(2, lambda t, a, b: t[0] * jnp.cos(jnp.sum(a - b) / t[1]), "cos"),
            noise=uniform_noise,
        )
        lml_bad = fit(gp_per)
        assert float(ms.bic(lml_good, 3, n)) < float(ms.bic(lml_bad, 3, n))
        assert float(ms.aic(lml_good, 3)) < float(ms.aic(lml_bad, 3))
