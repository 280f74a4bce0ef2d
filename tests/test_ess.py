"""Elliptical slice sampling (infer/ess.py): exactness against the
analytic Gaussian case, cross-engine agreement with Laplace on
classification, and the usual determinism/padding invariants."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import core, laplace
from gogp.gp.likelihoods import bernoulli_logit, gaussian
from gogp.infer import elliptical as ess
from gogp.kernels import rbf, uniform_noise


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    f = np.sin(1.4 * x[:, 0])
    return x, f, rng


class TestGaussianExactness:
    """With a Gaussian likelihood the latent posterior is analytic:
    mean = K (K + s^2 I)^-1 y, cov = K - K (K + s^2 I)^-1 K."""

    def _run(self):
        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, rng = _data(16)
        sigma = 0.3
        y = f + sigma * rng.normal(size=16)
        ts = jnp.asarray([1.0, 0.9])
        res = ess.run_ess_gp(
            gp, gaussian, ts, jnp.asarray([sigma]), x, y,
            jax.random.PRNGKey(0), num_chains=16, num_warmup=400,
            num_samples=750, thin=2,
        )
        K = np.asarray(gp.simil.matrix(ts, x, x))
        A = np.linalg.solve(K + sigma**2 * np.eye(16), K)
        mean = (A.T @ y)
        cov = K - K @ np.linalg.solve(K + sigma**2 * np.eye(16), K)
        return res, mean, cov, gp, x, y, sigma, ts

    def test_latent_moments(self):
        res, mean, cov, *_ = self._run()
        draws = np.asarray(res.f).reshape(-1, 16)
        got_mean = draws.mean(axis=0)
        got_var = draws.var(axis=0)
        assert np.max(np.abs(got_mean - mean)) < 0.08
        assert np.max(np.abs(got_var - np.diag(cov))) < 0.05

    def test_predict_matches_exact_gp(self):
        res, *_, gp, x, y, sigma, ts = self._run()
        z = np.linspace(-3.5, 3.5, 9)[:, None]
        mu, sd = ess.ess_predict(gp, res, z)
        # exact GP with the SAME noise in the covariance
        gpn = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        mu_ex, sd_ex = core.predict(gpn, ts, jnp.asarray([sigma]), x, y, z)
        assert np.max(np.abs(np.asarray(mu - mu_ex))) < 0.09
        assert np.max(np.abs(np.asarray(sd - sd_ex))) < 0.07


class TestClassificationCross:
    def test_ess_vs_laplace_probs(self):
        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, rng = _data(24, seed=1)
        y = (rng.uniform(size=24) < 1.0 / (1.0 + np.exp(-2.0 * f))).astype(float)
        ts = jnp.asarray([1.2, 1.0])
        tl = jnp.zeros(0)
        res = ess.run_ess_gp(
            gp, bernoulli_logit, ts, tl, x, y, jax.random.PRNGKey(1),
            num_chains=8, num_warmup=400, num_samples=400, thin=2,
        )
        z = np.linspace(-3.0, 3.0, 7)[:, None]
        p_ess = np.asarray(ess.ess_predict_prob(gp, bernoulli_logit, res, z))
        post = laplace.laplace_fit(gp, bernoulli_logit, ts, tl, x, y)
        p_lap = np.asarray(laplace.laplace_predict_prob(gp, bernoulli_logit, post, z))
        # Laplace is an approximation; agreement within its known bias
        assert np.max(np.abs(p_ess - p_lap)) < 0.08, (p_ess, p_lap)
        assert np.all((p_ess > 0) & (p_ess < 1))


class TestInvariants:
    def test_deterministic_given_key(self):
        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, rng = _data(12)
        y = (f > 0).astype(float)
        args = (gp, bernoulli_logit, jnp.asarray([1.0, 1.0]), jnp.zeros(0), x, y)
        a = ess.run_ess_gp(*args, jax.random.PRNGKey(5), num_chains=2,
                           num_warmup=20, num_samples=10)
        b = ess.run_ess_gp(*args, jax.random.PRNGKey(5), num_chains=2,
                           num_warmup=20, num_samples=10)
        np.testing.assert_array_equal(np.asarray(a.f), np.asarray(b.f))

    def test_padding_invariance_of_prediction(self):
        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, rng = _data(12)
        y = (f > 0).astype(float)
        ts = jnp.asarray([1.0, 1.0])
        z = np.array([[0.4], [-1.3]])
        res = ess.run_ess_gp(gp, bernoulli_logit, ts, jnp.zeros(0), x, y,
                             jax.random.PRNGKey(2), num_chains=4,
                             num_warmup=300, num_samples=300)
        xp = np.concatenate([x, np.zeros((4, 1))])
        yp = np.concatenate([y, np.zeros(4)])
        m = np.concatenate([np.ones(12), np.zeros(4)])
        res_p = ess.run_ess_gp(gp, bernoulli_logit, ts, jnp.zeros(0), xp, yp,
                               jax.random.PRNGKey(2), mask=m, num_chains=4,
                               num_warmup=300, num_samples=300)
        mu, sd = ess.ess_predict(gp, res, z)
        mu_p, sd_p = ess.ess_predict(gp, res_p, z)
        # different RNG stream shapes -> statistical, not bitwise, agreement
        assert np.max(np.abs(np.asarray(mu - mu_p))) < 0.12
        assert np.max(np.abs(np.asarray(sd - sd_p))) < 0.10

    def test_update_terminates_and_moves(self):
        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, _ = _data(10)
        y = (f > 0).astype(float)
        res = ess.run_ess_gp(gp, bernoulli_logit, jnp.asarray([1.0, 1.0]),
                             jnp.zeros(0), x, y, jax.random.PRNGKey(3),
                             num_chains=2, num_warmup=0, num_samples=50)
        shr = np.asarray(res.shrinks)
        assert shr.max() < 64          # never hits the safety bound
        fs = np.asarray(res.f)
        moved = np.abs(np.diff(fs, axis=1)).max(axis=(0, 2))
        assert (moved > 0).all()       # every step accepts (ESS property)


class TestSharded:
    def test_device_count_invariance(self):
        # chains over an 8-device mesh produce BITWISE the single-device
        # draws (per-chain fold_in streams; zero collectives)
        from gogp.parallel import mesh as pmesh
        from gogp.parallel.sample import run_ess_sharded
        from gogp.infer.elliptical import run_ess
        from gogp.gp.core import masked_cov
        from gogp.ops import linalg

        gp = core.GP(ndim=1, simil=rbf.scaled())
        x, f, _ = _data(12)
        y = (f > 0).astype(float)
        ts = jnp.asarray([1.0, 1.0])
        K = masked_cov(gp, ts, jnp.zeros(0), jnp.asarray(x), jnp.ones(12))
        chol = linalg.cholesky(K)
        loglik = lambda fv: bernoulli_logit.sum_logp(jnp.zeros(0), fv, jnp.asarray(y))
        f0 = jnp.zeros((16, 12))
        key = jax.random.PRNGKey(11)
        # mesh layouts with the same per-device batch are bitwise equal
        # (identical executables, identical fold_in streams)
        mesh = pmesh.make_mesh(n_chain=4, n_data=2)
        b = run_ess_sharded(loglik, chol, f0, key, mesh, num_warmup=10, num_samples=5)
        mesh1 = pmesh.make_mesh(n_chain=8, n_data=1)
        c = run_ess_sharded(loglik, chol, f0, key, mesh1, num_warmup=10, num_samples=5)
        np.testing.assert_array_equal(np.asarray(b[0]), np.asarray(c[0]))
        # vs the vmapped single-device run: different batched-matvec fusion
        # puts ULP noise on the ellipse draw and slice acceptance is a
        # threshold event, so chains diverge chaotically — agreement is
        # statistical, not bitwise
        a = run_ess(loglik, chol, f0, key, num_warmup=200, num_samples=300)
        d = run_ess_sharded(loglik, chol, f0, key, mesh, num_warmup=200,
                            num_samples=300)
        mean_a = np.asarray(a[0]).reshape(-1, 12).mean(axis=0)
        mean_d = np.asarray(d[0]).reshape(-1, 12).mean(axis=0)
        assert np.max(np.abs(mean_a - mean_d)) < 0.15, (mean_a, mean_d)
