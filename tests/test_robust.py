"""Failure-detection paths: jitter-escalating Cholesky and RWM-mutation SMC
(SURVEY.md §5 — the reference's only story is a hard error, gp/gp.go:228-230)."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import infer
from gogp.gp.core import GP, absorb, lml_from_posterior
from gogp.kernels import rbf, uniform_noise
from gogp.ops import linalg


class TestCholeskyWithJitter:
    def test_pd_matrix_untouched(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(16, 16))
        K = jnp.asarray(a @ a.T + 16 * np.eye(16))
        L, jitter = linalg.cholesky_with_jitter(K)
        assert float(jitter) == 0.0
        assert np.allclose(np.asarray(L), np.asarray(jnp.linalg.cholesky(K)))

    def test_singular_matrix_recovered(self):
        # rank-deficient PSD matrix: plain cholesky yields NaNs
        v = jnp.asarray(np.random.default_rng(1).normal(size=(16, 3)))
        K = v @ v.T  # rank 3
        assert not bool(jnp.all(jnp.isfinite(jnp.diagonal(jnp.linalg.cholesky(K)))))
        L, jitter = linalg.cholesky_with_jitter(K)
        assert bool(jnp.all(jnp.isfinite(L)))
        assert float(jitter) > 0.0
        # recovered factor reproduces K up to the jitter
        err = np.abs(np.asarray(L @ L.T - K)).max()
        assert err < 10 * float(jitter) + 1e-8

    def test_jit_and_grad_safe(self):
        rng = np.random.default_rng(2)
        a = rng.normal(size=(8, 8))
        K = jnp.asarray(a @ a.T + 8 * np.eye(8))

        @jax.jit
        def f(K):
            L, _ = linalg.cholesky_with_jitter(K)
            return jnp.sum(jnp.log(jnp.diagonal(L)))

        assert np.isfinite(float(f(K)))

    def test_robust_absorb(self):
        gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        # duplicate inputs with ~zero noise: K numerically singular
        x = jnp.asarray([[0.0], [0.0], [1.0], [1.0]])
        y = jnp.asarray([1.0, 1.0, -1.0, -1.0])
        theta_noise = jnp.asarray([1e-12])
        post = absorb(gp, jnp.ones(2), theta_noise, x, y, robust=True)
        assert np.isfinite(float(lml_from_posterior(post)))


class TestSMCRWM:
    def test_gaussian_moments(self):
        def logp(v):
            return -0.5 * jnp.sum(v * v) - 0.5 * 2 * jnp.log(2 * jnp.pi)

        res = infer.run_smc(
            logp, jnp.zeros(2), jax.random.PRNGKey(0),
            num_particles=1024, sigma0=3.0, num_mcmc_steps=8, mutation="rwm",
        )
        assert bool(res.betas_hit_one)
        parts = np.asarray(res.particles)
        assert np.allclose(parts.mean(axis=0), 0.0, atol=0.2)
        assert np.allclose(parts.std(axis=0), 1.0, atol=0.25)
        assert abs(float(res.log_evidence)) < 0.25

    def test_unknown_mutation_raises(self):
        import pytest

        with pytest.raises(ValueError):
            infer.run_smc(
                lambda v: -jnp.sum(v * v), jnp.zeros(2), jax.random.PRNGKey(0),
                mutation="nope",
            )
