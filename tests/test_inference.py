"""Sampler correctness on analytically known targets + GP smoke tests.

The reference has no sampler tests (its inference is external, SURVEY.md §4);
these establish the new engines' correctness: posterior moments of known
Gaussians within Monte-Carlo error, ADVI exactness on Gaussian targets, SMC
evidence ~ 1 for normalized targets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp import infer
from gogp.infer import diagnostics

# 2-D correlated Gaussian target
COV = np.array([[2.0, 1.2], [1.2, 1.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def mvn_logp(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


def std_normal_logp(v):
    # normalized, so SMC's evidence relative to its Gaussian reference is known
    return -0.5 * jnp.sum(v * v) - 0.5 * v.shape[0] * jnp.log(2 * jnp.pi)


class TestNUTS:
    def test_gaussian_moments(self):
        res = jax.jit(
            lambda key: infer.run_nuts(
                mvn_logp, jnp.zeros(2), key, num_warmup=500, num_samples=2000
            )
        )(jax.random.PRNGKey(0))
        s = np.asarray(res.positions)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.15)
        assert np.allclose(np.cov(s.T), COV, atol=0.35)

    def test_multichain_rhat(self):
        keys = jax.random.split(jax.random.PRNGKey(1), 4)
        x0 = jnp.zeros((4, 2))
        run = jax.jit(
            jax.vmap(
                lambda x, k: infer.run_nuts(
                    mvn_logp, x, k, num_warmup=400, num_samples=800
                )
            )
        )
        res = run(x0, keys)
        pos = np.asarray(res.positions)  # (4, 800, 2)
        rhat = np.asarray(diagnostics.split_rhat(jnp.asarray(pos)))
        assert np.all(rhat < 1.05), rhat
        e = np.asarray(diagnostics.ess(jnp.asarray(pos)))
        assert np.all(e > 200), e

    def test_free_mask_pins_coordinates(self):
        free = jnp.array([1.0, 0.0])
        res = infer.run_nuts(
            mvn_logp,
            jnp.array([0.0, 5.0]),
            jax.random.PRNGKey(2),
            num_warmup=200,
            num_samples=300,
            free=free,
        )
        s = np.asarray(res.positions)
        assert np.all(s[:, 1] == 5.0)
        assert s[:, 0].std() > 0.1

    def test_step_size_adapted(self):
        res = infer.run_nuts(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(3),
            num_warmup=500, num_samples=100,
        )
        step = float(res.state.step_size)
        assert 0.05 < step < 5.0
        accept = float(np.mean(np.asarray(res.accept_probs)))
        assert 0.6 < accept <= 1.0

    def test_mass_matrix_adapted(self):
        # scale-separated target: mass should learn the variances
        def scaled_logp(v):
            return -0.5 * (v[0] ** 2 / 100.0 + v[1] ** 2 / 0.01)

        res = infer.run_nuts(
            scaled_logp, jnp.zeros(2), jax.random.PRNGKey(4),
            num_warmup=600, num_samples=400,
        )
        inv_mass = np.asarray(res.state.inv_mass)
        assert inv_mass[0] / inv_mass[1] > 100.0
        s = np.asarray(res.positions)
        assert 5.0 < s[:, 0].std() < 20.0
        assert 0.05 < s[:, 1].std() < 0.2


class TestHMC:
    def test_gaussian_moments(self):
        res = jax.jit(
            lambda key: infer.run_hmc(
                mvn_logp, jnp.zeros(2), key,
                num_warmup=500, num_samples=2000, trajectory_length=2.0,
            )
        )(jax.random.PRNGKey(0))
        s = np.asarray(res.positions)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.2)
        assert np.allclose(np.cov(s.T), COV, atol=0.4)

    def test_leapfrog_energy_conservation(self):
        vg = jax.value_and_grad(mvn_logp)
        q0 = jnp.array([1.0, 0.0])
        r0 = jnp.array([0.5, -0.3])
        v0, g0 = vg(q0)
        state = infer.IntegratorState(q0, r0, v0, g0)
        inv_mass = jnp.ones(2)
        out = infer.leapfrog(vg, state, jnp.asarray(0.01), inv_mass, 1000)
        e0 = -v0 + 0.5 * jnp.dot(r0, r0)
        e1 = -out.logp + 0.5 * jnp.dot(out.momentum, out.momentum)
        assert abs(float(e1 - e0)) < 1e-3

    def test_leapfrog_reversibility(self):
        vg = jax.value_and_grad(mvn_logp)
        q0 = jnp.array([1.0, 0.0])
        r0 = jnp.array([0.5, -0.3])
        v0, g0 = vg(q0)
        inv_mass = jnp.ones(2)
        fwd = infer.leapfrog(
            vg, infer.IntegratorState(q0, r0, v0, g0), jnp.asarray(0.05), inv_mass, 50
        )
        back = infer.leapfrog(
            vg,
            infer.IntegratorState(fwd.position, -fwd.momentum, fwd.logp, fwd.grad),
            jnp.asarray(0.05),
            inv_mass,
            50,
        )
        assert np.allclose(np.asarray(back.position), np.asarray(q0), atol=1e-10)
        assert np.allclose(np.asarray(-back.momentum), np.asarray(r0), atol=1e-10)


class TestADVI:
    def test_gaussian_exact(self):
        # mean-field ADVI on an uncorrelated Gaussian is exact
        def logp(v):
            return -0.5 * ((v[0] - 3.0) ** 2 / 4.0 + (v[1] + 1.0) ** 2 / 0.25)

        res = infer.run_advi(
            logp, jnp.zeros(2), jax.random.PRNGKey(0),
            num_steps=4000, learning_rate=0.02, num_draws=16,
        )
        mu = np.asarray(res.mu)
        sigma = np.exp(np.asarray(res.log_sigma))
        assert np.allclose(mu, [3.0, -1.0], atol=0.15)
        assert np.allclose(sigma, [2.0, 0.5], rtol=0.2)

    def test_elbo_increases(self):
        res = infer.run_advi(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(1), num_steps=1500
        )
        elbos = np.asarray(res.elbos)
        assert np.mean(elbos[-100:]) > np.mean(elbos[:100])

    def test_free_mask(self):
        free = jnp.array([1.0, 0.0])
        res = infer.run_advi(
            mvn_logp, jnp.array([0.0, 7.0]), jax.random.PRNGKey(2),
            num_steps=500, free=free,
        )
        assert float(res.mu[1]) == 7.0


class TestFullRankADVI:
    def test_recovers_correlated_covariance(self):
        """Full-rank q must recover the CORRELATION mean-field cannot:
        on the correlated mvn target, the fitted L L^T matches COV
        including the off-diagonal."""
        res = infer.run_advi_fullrank(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(0),
            num_steps=6000, learning_rate=0.02, num_draws=16,
        )
        from gogp.infer.advi import _chol_of

        L = np.asarray(_chol_of(res.chol_raw))
        cov_hat = L @ L.T
        assert np.allclose(np.asarray(res.mu), MEAN, atol=0.15)
        assert np.allclose(cov_hat, COV, atol=0.35), cov_hat
        # the off-diagonal specifically (corr = 0.69): mean-field's is 0
        assert cov_hat[0, 1] > 0.6

    def test_meanfield_underestimates_what_fullrank_does_not(self):
        mf = infer.run_advi(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(1),
            num_steps=4000, learning_rate=0.02, num_draws=16,
        )
        # mean-field marginal std on a correlated Gaussian shrinks toward
        # the conditional std (1/COV_INV[ii])^0.5 < marginal COV[ii]^0.5
        mf_var = np.exp(2 * np.asarray(mf.log_sigma))
        assert mf_var[0] < 0.8 * COV[0, 0]

    def test_sampling_and_free_mask(self):
        free = jnp.array([1.0, 0.0])
        res = infer.run_advi_fullrank(
            mvn_logp, jnp.array([0.0, 7.0]), jax.random.PRNGKey(2),
            num_steps=500, free=free,
        )
        assert float(res.mu[1]) == 7.0
        draws = infer.sample_posterior_fullrank(
            res, jax.random.PRNGKey(3), 256, free
        )
        d = np.asarray(draws)
        assert np.all(d[:, 1] == 7.0)
        assert d[:, 0].std() > 0.1

    def test_elbo_increases(self):
        res = infer.run_advi_fullrank(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(4), num_steps=1500
        )
        elbos = np.asarray(res.elbos)
        assert np.mean(elbos[-100:]) > np.mean(elbos[:100])


class TestSMC:
    def test_gaussian_moments_and_evidence(self):
        res = jax.jit(
            lambda key: infer.run_smc(
                std_normal_logp, jnp.zeros(3), key,
                num_particles=1024, sigma0=3.0, num_mcmc_steps=5,
            )
        )(jax.random.PRNGKey(0))
        assert bool(res.betas_hit_one)
        parts = np.asarray(res.particles)
        assert np.allclose(parts.mean(axis=0), 0.0, atol=0.2)
        assert np.allclose(parts.std(axis=0), 1.0, atol=0.2)
        # normalized target => log evidence vs the reference ~ 0
        assert abs(float(res.log_evidence)) < 0.2

    def test_shifted_target(self):
        def logp(v):
            return -0.5 * jnp.sum((v - 4.0) ** 2) - 0.5 * 2 * jnp.log(2 * jnp.pi)

        res = infer.run_smc(
            logp, jnp.zeros(2), jax.random.PRNGKey(1),
            num_particles=1024, sigma0=4.0, num_mcmc_steps=5,
        )
        parts = np.asarray(res.particles)
        assert np.allclose(parts.mean(axis=0), 4.0, atol=0.3)


class TestGPPosterior:
    """Samplers drive the flagship GP log-joint (hyperpriors model)."""

    @pytest.fixture(scope="class")
    def gp_logp(self):
        from gogp.models.params import gp_observe
        from gogp.tutorial.hyperpriors import make_priors, make_study

        study = make_study()
        gp = study.gp
        rng = np.random.default_rng(0)
        x = np.linspace(0, 10, 20)[:, None]
        y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=20)
        priors = make_priors(x, y)
        xj, yj, mask = jnp.asarray(x), jnp.asarray(y), jnp.ones(20)

        def logp(v):
            return gp_observe(gp, v, x=xj, y=yj, mask=mask) + priors(v, mask)

        return logp, gp.n_theta

    def test_nuts_on_gp(self, gp_logp):
        logp, dim = gp_logp
        res = jax.jit(
            lambda key: infer.run_nuts(
                logp, jnp.zeros(dim), key, num_warmup=300, num_samples=300
            )
        )(jax.random.PRNGKey(0))
        s = np.asarray(res.positions)
        assert np.all(np.isfinite(s))
        assert np.all(np.isfinite(np.asarray(res.logps)))
        # chain actually moves
        assert s.std(axis=0).min() > 1e-3

    def test_advi_finds_map_barebones(self):
        """Mean-field ADVI is mode-seeking: on the well-identified barebones
        model its mean must sit near the MAP (posterior *means* can
        legitimately differ from NUTS on skewed log-noise marginals)."""
        from gogp.models.params import gp_observe
        from gogp.tutorial.barebones import make_study

        gp = make_study().gp
        rng = np.random.default_rng(1)
        x = np.linspace(0, 6, 20)[:, None]
        y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=20)
        xj, yj, mask = jnp.asarray(x), jnp.asarray(y), jnp.ones(20)

        def logp(v):
            # weak Gaussian prior keeps the MLE-only target integrable
            return gp_observe(gp, v, x=xj, y=yj, mask=mask) - 0.05 * jnp.sum(v * v)

        map_res = infer.lbfgs(logp, jnp.zeros(gp.n_theta), iters=500)
        advi_res = infer.run_advi(
            logp, jnp.zeros(gp.n_theta), jax.random.PRNGKey(1),
            num_steps=4000, learning_rate=0.02, num_draws=16,
        )
        # ADVI mean maximizes E_q[logp]+H, so it sits near but not at the
        # MAP; require the gap in log-density to be small.
        gap = float(logp(map_res.x) - logp(advi_res.mu))
        assert 0.0 <= gap < 1.0, (np.asarray(map_res.x), np.asarray(advi_res.mu), gap)


class TestDiagnostics:
    def test_ess_iid(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 1000))
        e = float(diagnostics.ess(x))
        assert 2500 < e < 6000  # iid: ESS ~ total draws

    def test_ess_correlated(self):
        # AR(1) with rho=0.9: ESS ~ n*(1-rho)/(1+rho) ~ 0.053*n
        key = jax.random.PRNGKey(1)
        n = 4000
        eps = np.asarray(jax.random.normal(key, (n,)))
        x = np.zeros(n)
        for i in range(1, n):
            x[i] = 0.9 * x[i - 1] + eps[i]
        e = float(diagnostics.ess(jnp.asarray(x)))
        assert 100 < e < 500

    def test_rhat_converged_vs_not(self):
        key = jax.random.PRNGKey(2)
        good = jax.random.normal(key, (4, 500))
        assert float(diagnostics.split_rhat(good)) < 1.02
        bad = good + jnp.arange(4)[:, None] * 3.0
        assert float(diagnostics.split_rhat(bad)) > 1.5

    def test_split_ess_catches_drift(self):
        # every chain drifts identically: non-split cross-chain ESS sees
        # zero between-chain variance; splitting makes the drift register
        # as between-half-chain variance (the Vehtari rationale)
        t = jnp.linspace(0.0, 3.0, 1000)
        drift = t[None, :] + 0.1 * jax.random.normal(
            jax.random.PRNGKey(1), (4, 1000)
        )
        e_split = float(diagnostics.ess(drift))
        e_plain = float(diagnostics.ess(drift, split=False))
        assert e_split < 0.6 * e_plain, (e_split, e_plain)
        assert e_split < 20.0

    def test_gated_min_ess_stuck_chain(self):
        # a deliberately stuck chain must trip the (rank-normalized)
        # R-hat gate so benchmarks null the ESS/s instead of reporting a
        # number
        good = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 500, 2)))
        me, mr, ok = diagnostics.gated_min_ess(jnp.asarray(good))
        assert ok and mr < 1.01 and me > 500
        stuck = good.copy()
        stuck[0, :, 0] = 5.0
        me, mr, ok = diagnostics.gated_min_ess(jnp.asarray(stuck))
        assert not ok and mr > 1.01

    def test_bulk_stats_monotone_invariant(self):
        # rank normalization makes bulk ESS/R-hat exactly invariant under
        # strictly monotone transforms — the property that keeps the gate
        # measuring MIXING (not tail heaviness) on heavy-tailed marginals
        x = jax.random.normal(jax.random.PRNGKey(5), (4, 400))
        r1 = float(diagnostics.bulk_rhat(x))
        r2 = float(diagnostics.bulk_rhat(jnp.exp(x)))
        e1 = float(diagnostics.bulk_ess(x))
        e2 = float(diagnostics.bulk_ess(jnp.exp(x)))
        np.testing.assert_allclose(r1, r2, rtol=1e-6)
        np.testing.assert_allclose(e1, e2, rtol=1e-5)
        # raw-scale ESS of the exp'd (lognormal) draws differs
        assert abs(float(diagnostics.ess(jnp.exp(x))) - e2) > 1.0

    def test_diagnose_keys(self):
        x = jax.random.normal(jax.random.PRNGKey(6), (4, 300, 2))
        d = diagnostics.diagnose(x)
        assert set(d) == {"min_ess_raw", "max_rhat_raw",
                          "min_ess_bulk", "max_rhat_bulk"}
        assert d["max_rhat_bulk"] < 1.02
