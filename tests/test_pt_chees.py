"""PT with ChEES rung populations: mixing, moments, flow, invariants.

Mirrors tests/test_tempering.py's correctness targets (bimodal mixing that
plain samplers cannot achieve; exact moments on an easy target) plus the
scheme's own contracts: rung-shared adaptation, per-ladder swap decisions,
chunked driving.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import infer
from gogp.infer import pt_chees

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def mvn_logp(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


def bimodal_logp(v):
    a = -0.5 * jnp.sum((v - 4.0) ** 2) / 0.25
    b = -0.5 * jnp.sum((v + 4.0) ** 2) / 0.25
    return jnp.logaddexp(a, b)


class TestPTChEES:
    def test_moments_on_unimodal(self):
        res = infer.run_pt_chees(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(0),
            n_ladders=8, n_replicas=4, beta_min=0.2,
            num_warmup=300, num_samples=500,
        )
        pos = np.asarray(res.positions)  # (500, 8, 2)
        assert pos.shape == (500, 8, 2)
        flat = pos.reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.2)
        assert np.allclose(np.cov(flat.T), COV, atol=0.4)
        assert 0.0 < float(res.swap_rate) <= 1.0

    def test_mixes_bimodal(self):
        res = infer.run_pt_chees(
            bimodal_logp, jnp.full((1,), 4.0), jax.random.PRNGKey(1),
            n_ladders=8, n_replicas=8, beta_min=0.02,
            num_warmup=400, num_samples=600,
        )
        s = np.asarray(res.positions)[:, :, 0].ravel()
        frac_neg = float(np.mean(s < 0))
        assert 0.2 < frac_neg < 0.8, frac_neg
        assert float(res.swap_rate) > 0.2
        assert int(res.round_trips) > 0

    def test_plain_chees_stuck_for_contrast(self):
        res = infer.run_chees(
            bimodal_logp, jnp.full((4, 1), 4.0), jax.random.PRNGKey(1),
            num_warmup=400, num_samples=600,
        )
        s = np.asarray(res.positions).ravel()
        frac_neg = float(np.mean(s < 0))
        assert frac_neg < 0.05 or frac_neg > 0.95, frac_neg

    def test_rung_shared_adaptation_shapes(self):
        """Every rung owns ONE shared step size / trajectory / mass vector,
        adapted from its cross-ladder population."""
        res = infer.run_pt_chees(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(2),
            n_ladders=4, n_replicas=3, num_warmup=150, num_samples=50,
        )
        st = res.state
        assert st.step_size.shape == (3,)
        assert st.log_traj.shape == (3,)
        assert st.inv_mass.shape == (3, 2)
        assert st.positions.shape == (3, 4, 2)
        # hotter rungs see a wider target: step sizes must not be identical
        ss = np.asarray(st.step_size)
        assert np.ptp(ss) > 1e-5, ss
        assert np.all(np.isfinite(np.asarray(st.log_traj)))

    def test_ladder_adapts_and_stays_pinned(self):
        res = infer.run_pt_chees(
            bimodal_logp, jnp.full((1,), 4.0), jax.random.PRNGKey(3),
            n_ladders=4, n_replicas=6, beta_min=0.05,
            num_warmup=300, num_samples=100,
        )
        betas = np.asarray(res.betas)
        assert np.isclose(betas[0], 1.0) and np.isclose(betas[-1], 0.05)
        assert np.all(np.diff(betas) < 0), betas
        geo = np.asarray(pt_chees.geometric_ladder(6, 0.05, jnp.float64))
        assert not np.allclose(betas, geo, atol=1e-6)

    def test_chunked_equals_monolithic_sampling(self):
        state = pt_chees.pt_chees_init(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(4),
            pt_chees.geometric_ladder(3, 0.3, jnp.float64), 4, 0.3, 1.0,
        )
        betas = pt_chees.geometric_ladder(3, 0.3, jnp.float64)
        key = jax.random.PRNGKey(5)
        t0 = jnp.asarray(0)
        _, _, p_one, _, _, _ = jax.jit(
            lambda s, k: pt_chees.pt_chees_sample_chunk(mvn_logp, s, k, betas, 40, t0)
        )(state, key)
        s2, k2, pa, _, _, fl = jax.jit(
            lambda s, k: pt_chees.pt_chees_sample_chunk(mvn_logp, s, k, betas, 20, t0)
        )(state, key)
        _, _, pb, _, _, _ = jax.jit(
            lambda s, k, fl: pt_chees.pt_chees_sample_chunk(
                mvn_logp, s, k, betas, 20, t0 + 20, flow=fl
            )
        )(s2, k2, fl)
        np.testing.assert_allclose(
            np.asarray(p_one),
            np.concatenate([np.asarray(pa), np.asarray(pb)]),
            rtol=1e-6, atol=1e-6,
        )

    def test_flow_statistics(self):
        res = infer.run_pt_chees(
            mvn_logp, jnp.zeros(2), jax.random.PRNGKey(6),
            n_ladders=8, n_replicas=4, beta_min=0.3,
            num_warmup=200, num_samples=300,
        )
        assert float(res.barrier) >= 0.0
        pr = np.asarray(res.pair_rej)
        assert pr.shape == (3,)
        assert np.all(pr >= 0.0) and np.all(pr <= 1.0)
        # easy target, shallow ladder: states must actually round-trip
        assert int(res.round_trips) > 8
