"""Parallel-tempered NUTS: must mix across modes plain NUTS cannot."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import infer
from gogp.infer import tempering


def bimodal_logp(v):
    """Two well-separated Gaussians at +-4 (std 0.5), symmetric weights."""
    a = -0.5 * jnp.sum((v - 4.0) ** 2) / 0.25
    b = -0.5 * jnp.sum((v + 4.0) ** 2) / 0.25
    return jnp.logaddexp(a, b)


class TestPT:
    def test_mixes_bimodal(self):
        res = tempering.run_pt_nuts(
            bimodal_logp, jnp.full((1,), 4.0), jax.random.PRNGKey(0),
            n_replicas=8, beta_min=0.02,
            num_warmup=400, num_samples=1500, max_tree_depth=6,
        )
        s = np.asarray(res.positions)[:, 0]
        frac_neg = float(np.mean(s < 0))
        # symmetric target: both modes visited substantially
        assert 0.2 < frac_neg < 0.8, frac_neg
        assert float(res.swap_rate) > 0.2

    def test_plain_nuts_stuck_for_contrast(self):
        res = infer.run_nuts(
            bimodal_logp, jnp.full((1,), 4.0), jax.random.PRNGKey(0),
            num_warmup=400, num_samples=1500,
        )
        s = np.asarray(res.positions)[:, 0]
        frac_neg = float(np.mean(s < 0))
        # plain NUTS cannot cross the barrier
        assert frac_neg < 0.05 or frac_neg > 0.95, frac_neg

    def test_moments_on_unimodal(self):
        """PT on an easy target must still be exactly correct."""
        cov = np.array([[2.0, 1.2], [1.2, 1.5]])
        cov_inv = np.linalg.inv(cov)
        mean = np.array([1.0, -2.0])

        def logp(v):
            d = v - jnp.asarray(mean)
            return -0.5 * d @ jnp.asarray(cov_inv) @ d

        res = tempering.run_pt_nuts(
            logp, jnp.zeros(2), jax.random.PRNGKey(1),
            n_replicas=4, num_warmup=400, num_samples=2000,
        )
        s = np.asarray(res.positions)
        assert np.allclose(s.mean(axis=0), mean, atol=0.2)
        assert np.allclose(np.cov(s.T), cov, atol=0.4)

    def test_ladder(self):
        b = np.asarray(tempering.geometric_ladder(5, 0.1))
        assert np.isclose(b[0], 1.0) and np.isclose(b[-1], 0.1)
        assert np.all(np.diff(b) < 0)
        b1 = np.asarray(tempering.geometric_ladder(1))
        assert b1.shape == (1,) and b1[0] == 1.0


class TestLadderDepth:
    def test_place_rungs_resizes_and_pins_endpoints(self):
        betas = tempering.geometric_ladder(4, 0.1, jnp.float64)
        rej = jnp.asarray([0.3, 0.3, 0.3], jnp.float64)  # equalized barrier
        out = np.asarray(tempering.place_rungs(betas, rej, 7))
        assert out.shape == (7,)
        assert np.isclose(out[0], 1.0) and np.isclose(out[-1], 0.1)
        assert np.all(np.diff(out) < 0)
        # shrink too
        out3 = np.asarray(tempering.place_rungs(betas, rej, 3))
        assert out3.shape == (3,) and np.isclose(out3[0], 1.0)

    def test_place_rungs_concentrates_where_barrier_is(self):
        """All rejection in the first pair -> new interior rungs crowd the
        high-beta end of the ladder."""
        betas = jnp.asarray([1.0, 0.7, 0.4, 0.1], jnp.float64)
        rej = jnp.asarray([0.9, 0.01, 0.01], jnp.float64)
        out = np.asarray(tempering.place_rungs(betas, rej, 4))
        # interior rungs pulled toward [0.7, 1.0] where the barrier lives
        assert out[1] > 0.7 and out[2] > 0.55

    def test_barrier_and_flow_tracked(self):
        res = tempering.run_pt_nuts(
            bimodal_logp, jnp.full((1,), 4.0), jax.random.PRNGKey(2),
            n_replicas=6, beta_min=0.02, num_warmup=200, num_samples=300,
        )
        assert res.barrier is not None and float(res.barrier) > 0.0
        assert res.pair_rej.shape == (5,)
        # expected rejections are probabilities
        pr = np.asarray(res.pair_rej)
        assert np.all(pr >= 0.0) and np.all(pr <= 1.0)
        assert int(res.round_trips) >= 0

    def test_tune_ladder_easy_target_shallow(self):
        """A unimodal Gaussian with a mild beta range has a small barrier:
        the tuner must recommend a SHALLOWER ladder than the pilot's 8."""

        def logp(v):
            return -0.5 * jnp.sum(v * v)

        betas, pilot = tempering.tune_ladder(
            logp, jnp.zeros(2), jax.random.PRNGKey(3),
            beta_min=0.5, pilot_replicas=8,
            pilot_warmup=150, pilot_samples=100,
        )
        b = np.asarray(betas)
        assert b.shape[0] < 8, b
        assert np.isclose(b[0], 1.0) and np.isclose(b[-1], 0.5)
        assert float(pilot.barrier) < 1.5
