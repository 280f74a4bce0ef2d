"""Student-t process: golden logpdf vs scipy, GP limit, band adaptation."""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core, tprocess
from gogp.kernels import matern32, normal as rbf
from gogp.kernels.noise import constant_noise


def _data(seed=0, n=15):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 6, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return jnp.asarray(x), jnp.asarray(y)


class TestGoldens:
    def test_matches_scipy_multivariate_t(self):
        from scipy import stats

        x, y = _data(1)
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.2))
        ts = jnp.asarray([1.3, 0.9])
        nu = 4.5
        got = float(tprocess.tp_lml(gp, nu, ts, jnp.zeros(0), x, y))
        K = np.asarray(core.masked_cov(gp, ts, jnp.zeros(0), x, jnp.ones(x.shape[0])))
        want = stats.multivariate_t(loc=np.zeros(len(K)), shape=K, df=nu).logpdf(
            np.asarray(y)
        )
        np.testing.assert_allclose(got, want, atol=1e-9)

    def test_gp_limit(self):
        x, y = _data(2)
        gp = core.GP(1, matern32.scaled(), noise=constant_noise(0.15))
        ts = jnp.asarray([0.8, 1.4])
        ll_tp = float(tprocess.tp_lml(gp, 1e7, ts, jnp.zeros(0), x, y))
        ll_gp = float(core.lml(gp, ts, jnp.zeros(0), x, y))
        np.testing.assert_allclose(ll_tp, ll_gp, atol=1e-4)
        post = tprocess.tp_absorb(gp, 1e7, ts, jnp.zeros(0), x, y)
        z = jnp.asarray([[1.1], [6.5]])
        mu_t, sd_t = tprocess.tp_predict(gp, 1e7, post, z)
        mu_g, sd_g = core.predict(gp, ts, jnp.zeros(0), x, y, z)
        np.testing.assert_allclose(np.asarray(mu_t), np.asarray(mu_g), atol=1e-9)
        np.testing.assert_allclose(np.asarray(sd_t), np.asarray(sd_g), atol=1e-5)

    def test_mean_identical_to_gp_any_nu(self):
        x, y = _data(3)
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.1))
        ts = jnp.asarray([1.0, 1.0])
        post = tprocess.tp_absorb(gp, 3.0, ts, jnp.zeros(0), x, y)
        z = jnp.asarray([[2.2], [4.4]])
        mu_t, _ = tprocess.tp_predict(gp, 3.0, post, z)
        mu_g, _ = core.predict(gp, ts, jnp.zeros(0), x, y, z)
        np.testing.assert_allclose(np.asarray(mu_t), np.asarray(mu_g), atol=1e-10)


class TestBandAdaptation:
    def test_surprising_residuals_inflate_bands(self):
        # Same inputs/kernel, y scaled up: beta grows, TP bands inflate while
        # GP bands are y-independent.
        x, y = _data(4)
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.1))
        ts = jnp.asarray([1.0, 1.0])
        nu = 4.0
        z = jnp.asarray([[3.0]])
        post_small = tprocess.tp_absorb(gp, nu, ts, jnp.zeros(0), x, 0.1 * y)
        post_big = tprocess.tp_absorb(gp, nu, ts, jnp.zeros(0), x, 5.0 * y)
        _, sd_small = tprocess.tp_predict(gp, nu, post_small, z)
        _, sd_big = tprocess.tp_predict(gp, nu, post_big, z)
        assert float(sd_big[0]) > float(sd_small[0]) * 2.0
        _, sd_gp = core.predict(gp, ts, jnp.zeros(0), x, y, z)
        assert abs(float(sd_gp[0]) - float(core.predict(gp, ts, jnp.zeros(0), x, 5 * y, z)[1][0])) < 1e-12


class TestProtocol:
    def test_fd_gradients(self):
        x, y = _data(5, n=10)
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.2))
        logp, n_params = tprocess.make_tp_logp(gp, x, y)
        assert n_params == 3
        v0 = jnp.asarray([0.5, 0.2, -0.1])
        g = jax.grad(logp)(v0)
        eps = 1e-6
        for i in range(n_params):
            e = jnp.zeros_like(v0).at[i].set(eps)
            fd = (logp(v0 + e) - logp(v0 - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd), atol=1e-5)

    def test_padding_invariance_and_jit(self):
        x, y = _data(6, n=12)
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.1))
        ts = jnp.asarray([1.2, 0.8])
        nu = 5.0
        ll = tprocess.tp_lml(gp, nu, ts, jnp.zeros(0), x, y)
        pad = 5
        xp = jnp.concatenate([x, jnp.full((pad, 1), 42.0)])
        yp = jnp.concatenate([y, jnp.zeros((pad,))])
        m = jnp.concatenate([jnp.ones((12,)), jnp.zeros((pad,))])
        ll_pad = tprocess.tp_lml(gp, nu, ts, jnp.zeros(0), xp, yp, mask=m)
        np.testing.assert_allclose(float(ll), float(ll_pad), atol=1e-9)
        jitted = jax.jit(lambda t: tprocess.tp_lml(gp, nu, t, jnp.zeros(0), x, y))
        np.testing.assert_allclose(float(jitted(ts)), float(ll), atol=1e-10)

    def test_heavy_tail_preferred_for_surprising_data(self):
        # At FIXED kernel thetas (so amplitude cannot absorb the scale), data
        # whose residuals are far larger than the kernel predicts is more
        # likely under small nu than under the Gaussian limit — the fat tail
        # pays for the surprise.  MLE over v_nu should find that.
        from gogp.infer import mle

        rng = np.random.default_rng(7)
        n = 40
        x = jnp.asarray(np.sort(rng.uniform(0, 8, size=(n, 1)), axis=0))
        gp = core.GP(1, rbf.scaled(), noise=constant_noise(0.1))
        ts = jnp.asarray([1.0, 1.0])
        K = np.asarray(core.masked_cov(gp, ts, jnp.zeros(0), x, jnp.ones(n)))
        Lc = np.linalg.cholesky(K)
        y = jnp.asarray(3.0 * (Lc @ rng.normal(size=n)))  # 3x the kernel's scale
        ll_t = float(tprocess.tp_lml(gp, 3.0, ts, jnp.zeros(0), x, y))
        ll_g = float(tprocess.tp_lml(gp, 1e7, ts, jnp.zeros(0), x, y))
        assert ll_t > ll_g
        # and the one-parameter nu MLE (thetas pinned via the closure) agrees
        logp_nu = lambda v_nu: tprocess.tp_lml(
            gp, 2.0 + jnp.exp(v_nu[0]), ts, jnp.zeros(0), x, y
        )
        res = mle.adam(jax.value_and_grad(logp_nu), jnp.asarray([3.0]), iters=200, rate=0.1)
        nu_fit = 2.0 + float(jnp.exp(res.x[0]))
        assert nu_fit < 30.0
