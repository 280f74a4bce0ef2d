"""Persistent-momentum GHMC (MEADS-style cross-fold adaptation): moments,
adaptation invariants, the momentum-flip correctness requirement, and
agreement with ChEES on the flagship GP posterior.

The reference delegates inference entirely (tutorial/tutorial.go:128-169);
GHMC joins the north-star inference layer as the no-trajectory-knob sampler
(see gogp/infer/ghmc.py docstring for the design and its deviations
from Hoffman & Sountsov 2022).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp import infer
from gogp.infer import diagnostics
from gogp.infer.ghmc import (
    finalize_ghmc_warmup,
    ghmc_init,
    ghmc_sample_chunk,
    ghmc_warm_chunk,
)

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def mvn_logp(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


class TestGHMC:
    def test_gaussian_moments(self):
        chains = 32
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(10), (chains, 2))
        res = jax.jit(
            lambda key: infer.run_ghmc(
                mvn_logp, x0, key, num_warmup=600, num_samples=3000
            )
        )(jax.random.PRNGKey(0))
        s = np.asarray(res.positions).reshape(-1, 2)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.1)
        assert np.allclose(np.cov(s.T), COV, atol=0.3)

    def test_rhat_and_high_accept(self):
        chains = 16
        x0 = jax.random.normal(jax.random.PRNGKey(11), (chains, 2))
        res = infer.run_ghmc(
            mvn_logp, x0, jax.random.PRNGKey(1), num_warmup=600, num_samples=2000
        )
        pos = jnp.moveaxis(res.positions, 1, 0)
        rhat = np.asarray(diagnostics.split_rhat(pos))
        assert np.all(rhat < 1.05), rhat
        # persistent momentum needs high acceptance; dual averaging targets 0.9
        assert 0.8 < float(np.mean(np.asarray(res.accept_probs))) < 1.0

    def test_cross_fold_preconditioner_finds_scales(self):
        # strongly anisotropic Gaussian: the frozen per-fold sigma must
        # recover the 10:1 scale ratio from the complementary fold
        scales = jnp.asarray([10.0, 1.0])

        def logp(v):
            return -0.5 * jnp.sum((v / scales) ** 2)

        x0 = jax.random.normal(jax.random.PRNGKey(12), (32, 2)) * scales
        res = infer.run_ghmc(
            logp, x0, jax.random.PRNGKey(2), num_warmup=800, num_samples=100
        )
        sig = np.asarray(res.state.sigma)  # (2, dim)
        ratio = sig[:, 0] / sig[:, 1]
        assert np.all(ratio > 4.0), sig
        assert np.all(ratio < 25.0), sig

    def test_chunked_equals_monolithic_sampling(self):
        x0 = jnp.zeros((4, 2))
        state = ghmc_init(mvn_logp, x0, jax.random.PRNGKey(5), 0.3)
        _, (p_one, _, _) = jax.jit(
            lambda s: ghmc_sample_chunk(mvn_logp, s, 40)
        )(state)
        s2, (pa, _, _) = jax.jit(lambda s: ghmc_sample_chunk(mvn_logp, s, 20))(state)
        _, (pb, _, _) = jax.jit(lambda s: ghmc_sample_chunk(mvn_logp, s, 20))(s2)
        np.testing.assert_allclose(
            np.asarray(p_one),
            np.concatenate([np.asarray(pa), np.asarray(pb)]),
            rtol=1e-6,
            atol=1e-6,
        )

    def test_jit_invariance(self):
        x0 = jnp.zeros((4, 2))
        k = jax.random.PRNGKey(4)
        run = lambda key: infer.run_ghmc(
            mvn_logp, x0, key, num_warmup=60, num_samples=30
        )
        a = run(k)
        b = jax.jit(run)(k)
        np.testing.assert_allclose(
            np.asarray(a.positions), np.asarray(b.positions), rtol=2e-5, atol=2e-5
        )

    def test_free_mask_pins_coordinates(self):
        """Pinned dims stay put AND the free dim samples the correct
        CONDITIONAL — the r4 advisor showed the pinned dim's floored
        cross-fold std degenerated the damping (sampled std 4.19 vs the
        true 1.02); pinned dims are now excluded from the preconditioner
        and the damping ratio."""
        free = jnp.array([1.0, 0.0])
        x0 = jnp.tile(jnp.array([0.0, 5.0]), (16, 1))
        res = infer.run_ghmc(
            mvn_logp, x0, jax.random.PRNGKey(3),
            num_warmup=600, num_samples=2000, free=free,
        )
        s = np.asarray(res.positions)
        assert np.all(s[:, :, 1] == 5.0)
        # conditional of v0 | v1=5: mean + cov01/cov11*(5-mean1), var
        # cov00 - cov01^2/cov11
        cmean = MEAN[0] + COV[0, 1] / COV[1, 1] * (5.0 - MEAN[1])
        cstd = np.sqrt(COV[0, 0] - COV[0, 1] ** 2 / COV[1, 1])
        v0 = s[:, :, 0].reshape(-1)
        assert abs(v0.mean() - cmean) < 0.3, (v0.mean(), cmean)
        assert abs(v0.std() - cstd) < 0.3, (v0.std(), cstd)

    def test_odd_or_tiny_population_raises(self):
        with pytest.raises(ValueError, match="even population"):
            ghmc_init(mvn_logp, jnp.zeros((5, 2)), jax.random.PRNGKey(0))
        # a 2-chain SLAB is legal (sharded folds are global); the
        # single-device driver still demands >= 4
        with pytest.raises(ValueError, match=">= 4"):
            infer.run_ghmc(mvn_logp, jnp.zeros((2, 2)), jax.random.PRNGKey(0))

    def test_divergences_do_not_stick(self):
        # absurd init step: early divergences must flip momentum, stay
        # finite, and dual averaging must recover a working step size
        x0 = jnp.zeros((8, 2))
        res = infer.run_ghmc(
            mvn_logp, x0, jax.random.PRNGKey(7),
            num_warmup=400, num_samples=100, init_step_size=50.0,
        )
        assert np.isfinite(np.asarray(res.positions)).all()
        assert float(res.state.step_size) < 5.0
        assert float(np.mean(np.asarray(res.accept_probs))) > 0.5


class TestGHMCOnGP:
    def test_barebones_posterior_agrees_with_chees(self):
        """Cross-engine agreement on a real GP posterior.  Barebones (2
        thetas + noise, N(0,1) priors) is unimodal, so finite-sample
        engine comparisons are stable; the multimodal hyperpriors
        posterior makes any finite-run mean comparison a mode-weight
        lottery (ChEES itself varies by that much across seeds)."""
        from gogp import dists
        from gogp.models.params import gp_observe
        from gogp.tutorial import io as tio
        from gogp.tutorial.barebones import make_study, selfcheck_data

        study = make_study()
        gp = study.gp
        x, y = tio.load_csv(selfcheck_data())
        y_norm, _, _ = tio.normalize(y)
        xj = jnp.asarray(x)
        yj = jnp.asarray(y_norm)
        mask = jnp.ones(x.shape[0])

        def logp(v):
            return gp_observe(gp, v, x=xj, y=yj, mask=mask) + jnp.sum(
                dists.normal_logp(0.0, 1.0, v)
            )

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(20), (16, gp.n_theta))
        g = infer.run_ghmc(
            logp, x0, jax.random.PRNGKey(0), num_warmup=800, num_samples=4000
        )
        c = infer.run_chees(
            logp, x0, jax.random.PRNGKey(1), num_warmup=500, num_samples=500
        )
        sg = np.asarray(g.positions).reshape(-1, gp.n_theta)
        sc = np.asarray(c.positions).reshape(-1, gp.n_theta)
        assert np.all(np.isfinite(sg))
        assert np.allclose(sg.mean(axis=0), sc.mean(axis=0), atol=0.25), (
            sg.mean(axis=0), sc.mean(axis=0),
        )
        assert np.allclose(sg.std(axis=0), sc.std(axis=0), atol=0.3), (
            sg.std(axis=0), sc.std(axis=0),
        )
