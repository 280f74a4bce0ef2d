"""Sharded-inference tests on the virtual 8-device CPU mesh.

Replaces the reference's serial-vs-parallel equivalence invariant
(gp/gp_test.go:123-132) with the multi-device equivalents: sharded-vs-single-device
consistency and cross-device adaptation correctness (SURVEY.md §4 test plan).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp import parallel
from gogp.infer import diagnostics

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def mvn_logp(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh(n_chain=4, n_data=2)


@pytest.fixture(scope="module")
def mesh1():
    return parallel.make_mesh(n_chain=1, n_data=1)


class TestShardedNUTS:
    def test_moments_8dev(self, mesh8):
        x0 = jnp.zeros((16, 2))
        res = parallel.run_nuts_sharded(
            mvn_logp, x0, jax.random.PRNGKey(0), mesh8,
            num_warmup=400, num_samples=500,
        )
        pos = np.asarray(res.positions)  # (16, 500, 2)
        assert pos.shape == (16, 500, 2)
        flat = pos.reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.15)
        assert np.allclose(np.cov(flat.T), COV, atol=0.35)
        rhat = np.asarray(diagnostics.split_rhat(jnp.asarray(pos)))
        assert np.all(rhat < 1.05)

    def test_device_count_invariance(self, mesh8, mesh1):
        """Same chains, same keys -> bitwise-identical samples on 1 vs 8
        devices (collectives are deterministic sums of the same terms)."""
        x0 = jnp.zeros((8, 2))
        kwargs = dict(num_warmup=100, num_samples=50)
        r8 = parallel.run_nuts_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh8, **kwargs
        )
        r1 = parallel.run_nuts_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-8
        )

    def test_shared_mass_matrix(self, mesh8):
        """Each device sees only 1-2 chains — too few to adapt alone; the
        psum-combined mass must still learn the scale separation."""

        def scaled_logp(v):
            return -0.5 * (v[0] ** 2 / 100.0 + v[1] ** 2 / 0.01)

        x0 = jnp.zeros((8, 2))
        res = parallel.run_nuts_sharded(
            scaled_logp, x0, jax.random.PRNGKey(1), mesh8,
            num_warmup=600, num_samples=200,
        )
        inv_mass = np.asarray(res.state.inv_mass)  # (8, 2) per local chain
        assert np.all(inv_mass[:, 0] / inv_mass[:, 1] > 100.0)


class TestShardedHMC:
    def test_moments(self, mesh8):
        x0 = jnp.zeros((8, 2))
        res = parallel.run_hmc_sharded(
            mvn_logp, x0, jax.random.PRNGKey(0), mesh8,
            num_warmup=400, num_samples=800, trajectory_length=2.0,
        )
        flat = np.asarray(res.positions).reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.2)


class TestShardedSMC:
    def test_moments_and_evidence(self, mesh8):
        def logp(v):
            return -0.5 * jnp.sum(v * v) - 0.5 * 3 * jnp.log(2 * jnp.pi)

        res = parallel.run_smc_sharded(
            logp, jnp.zeros(3), jax.random.PRNGKey(0), mesh8,
            num_particles=1024, sigma0=3.0, num_mcmc_steps=5,
        )
        assert bool(res.betas_hit_one)
        parts = np.asarray(res.particles)
        assert parts.shape == (1024, 3)
        assert np.allclose(parts.mean(axis=0), 0.0, atol=0.2)
        assert np.allclose(parts.std(axis=0), 1.0, atol=0.2)
        assert abs(float(res.log_evidence)) < 0.2

    def test_device_count_invariance(self, mesh8, mesh1):
        def logp(v):
            return -0.5 * jnp.sum((v - 2.0) ** 2)

        kwargs = dict(num_particles=256, sigma0=2.0, num_mcmc_steps=2)
        r8 = parallel.run_smc_sharded(
            logp, jnp.zeros(2), jax.random.PRNGKey(5), mesh8, **kwargs
        )
        r1 = parallel.run_smc_sharded(
            logp, jnp.zeros(2), jax.random.PRNGKey(5), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.particles), np.asarray(r1.particles), atol=1e-8
        )
        assert np.allclose(
            float(r8.log_evidence), float(r1.log_evidence), atol=1e-8
        )


class TestMesh:
    def test_make_mesh_shapes(self):
        m = parallel.make_mesh(n_chain=8, n_data=1)
        assert m.devices.shape == (8, 1)
        m2 = parallel.make_mesh(n_chain=2, n_data=4)
        assert m2.devices.shape == (2, 4)

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError):
            parallel.make_mesh(n_chain=16, n_data=1)


class TestShardedPT:
    def test_bimodal_mixing_sharded(self, mesh8):
        """Chain-sharded PT ladders: every cold chain must visit both modes
        of a target plain NUTS cannot cross."""

        def bimodal(v):
            a = -0.5 * jnp.sum((v - 4.0) ** 2) / 0.25
            b = -0.5 * jnp.sum((v + 4.0) ** 2) / 0.25
            return jnp.logaddexp(a, b)

        x0 = jnp.full((8, 1), 4.0)
        res = parallel.run_pt_sharded(
            bimodal, x0, jax.random.PRNGKey(0), mesh8,
            n_replicas=6, beta_min=0.02, num_warmup=300, num_samples=800,
        )
        pos = np.asarray(res.positions)  # (8, 800, 1)
        frac_neg = (pos[:, :, 0] < 0).mean(axis=1)
        assert np.all(frac_neg > 0.1) and np.all(frac_neg < 0.9), frac_neg

    def test_device_count_invariance(self, mesh8, mesh1):
        def logp(v):
            return -0.5 * jnp.sum(v * v)

        x0 = jnp.zeros((8, 2))
        kwargs = dict(n_replicas=3, num_warmup=50, num_samples=40)
        r8 = parallel.run_pt_sharded(logp, x0, jax.random.PRNGKey(1), mesh8, **kwargs)
        r1 = parallel.run_pt_sharded(logp, x0, jax.random.PRNGKey(1), mesh1, **kwargs)
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-8
        )


class TestDistributedPT:
    """One PT ladder spanning the mesh (parallel.run_pt_distributed)."""

    def test_device_count_invariance(self, mesh8, mesh1):
        """K=8 replicas on 8 devices vs 1 device: identical PRNG streams
        must produce identical cold-chain draws and adapted ladder."""

        def logp(v):
            return -0.5 * jnp.sum(v * v)

        x0 = jnp.zeros(2)
        kwargs = dict(n_replicas=8, num_warmup=60, num_samples=40, beta_min=0.1)
        r8 = parallel.run_pt_distributed(logp, x0, jax.random.PRNGKey(1), mesh8, **kwargs)
        r1 = parallel.run_pt_distributed(logp, x0, jax.random.PRNGKey(1), mesh1, **kwargs)
        assert np.allclose(np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-8)
        assert np.allclose(np.asarray(r8.betas), np.asarray(r1.betas), atol=1e-8)

    def test_bimodal_mixing_distributed(self, mesh8):
        def bimodal(v):
            a = -0.5 * jnp.sum((v - 4.0) ** 2) / 0.25
            b = -0.5 * jnp.sum((v + 4.0) ** 2) / 0.25
            return jnp.logaddexp(a, b)

        res = parallel.run_pt_distributed(
            bimodal, jnp.full((1,), 4.0), jax.random.PRNGKey(0), mesh8,
            n_replicas=8, beta_min=0.02, num_warmup=300, num_samples=800,
        )
        pos = np.asarray(res.positions)[:, 0]
        frac_neg = float(np.mean(pos < 0))
        assert 0.1 < frac_neg < 0.9, frac_neg
        assert float(res.swap_rate) > 0.2

    def test_ladder_adaptation_monotone_and_pinned(self, mesh8):
        """Adapted ladder: endpoints pinned, strictly decreasing."""

        def logp(v):
            return -0.5 * jnp.sum(v * v) * 50.0  # sharp: forces nontrivial barrier

        res = parallel.run_pt_distributed(
            logp, jnp.zeros(2), jax.random.PRNGKey(3), mesh8,
            n_replicas=8, beta_min=0.05, num_warmup=200, num_samples=20,
        )
        betas = np.asarray(res.betas)
        assert np.isclose(betas[0], 1.0) and np.isclose(betas[-1], 0.05)
        assert np.all(np.diff(betas) < 0), betas


class TestDistributedPTChEES:
    """One ChEES ladder spanning the mesh (parallel.run_pt_chees_distributed):
    each device owns adjacent rungs, each rung a full local cross-ladder
    population."""

    def test_matches_local_runner_and_device_count(self, mesh8, mesh1):
        """Same PRNG stream as infer.run_pt_chees: the 8-device and
        1-device distributed runs and the plain local runner must all
        produce the same draws and adapted ladder."""
        from gogp.infer.pt_chees import run_pt_chees

        def logp(v):
            return -0.5 * jnp.sum(v * v)

        x0 = jnp.zeros((4, 2))  # 4 ladders
        kwargs = dict(n_replicas=8, beta_min=0.1, num_warmup=60, num_samples=40)
        r8 = parallel.run_pt_chees_distributed(
            logp, x0, jax.random.PRNGKey(5), mesh8, n_ladders=4, **kwargs
        )
        r1 = parallel.run_pt_chees_distributed(
            logp, x0, jax.random.PRNGKey(5), mesh1, n_ladders=4, **kwargs
        )
        rl = run_pt_chees(logp, x0, jax.random.PRNGKey(5), n_ladders=4, **kwargs)
        np.testing.assert_allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-8
        )
        np.testing.assert_allclose(
            np.asarray(r8.positions), np.asarray(rl.positions), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(r8.betas), np.asarray(rl.betas), atol=1e-8
        )
        assert int(r8.round_trips) == int(rl.round_trips)

    def test_bimodal_mixing_distributed(self, mesh8):
        def bimodal(v):
            a = -0.5 * jnp.sum((v - 4.0) ** 2) / 0.25
            b = -0.5 * jnp.sum((v + 4.0) ** 2) / 0.25
            return jnp.logaddexp(a, b)

        res = parallel.run_pt_chees_distributed(
            bimodal, jnp.full((8, 1), 4.0), jax.random.PRNGKey(0), mesh8,
            n_ladders=8, n_replicas=8, beta_min=0.02,
            num_warmup=300, num_samples=600,
        )
        pos = np.asarray(res.positions)  # (600, 8, 1)
        frac_neg = float(np.mean(pos[:, :, 0] < 0))
        assert 0.1 < frac_neg < 0.9, frac_neg
        assert float(res.swap_rate) > 0.2
        assert int(res.round_trips) > 0


class TestShardedPTChEES:
    def test_moments_8dev(self, mesh8):
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(30), (8, 2))
        res = parallel.run_pt_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(0), mesh8,
            n_replicas=4, beta_min=0.2, num_warmup=300, num_samples=400,
        )
        pos = np.asarray(res.positions)  # (400, 8, 2)
        assert pos.shape == (400, 8, 2)
        flat = pos.reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.2)
        assert np.allclose(np.cov(flat.T), COV, atol=0.4)
        assert int(res.round_trips) > 0

    def test_device_count_invariance(self, mesh8, mesh1):
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(31), (8, 2))
        kwargs = dict(n_replicas=3, beta_min=0.3, num_warmup=100, num_samples=50)
        r8 = parallel.run_pt_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh8, **kwargs
        )
        r1 = parallel.run_pt_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-5
        )
        assert np.allclose(np.asarray(r8.betas), np.asarray(r1.betas), atol=1e-6)
        assert int(r8.round_trips) == int(r1.round_trips)

    def test_matches_local_run_pt_chees(self, mesh1):
        """1x1 mesh must reproduce infer.run_pt_chees exactly (pmean over a
        size-1 axis is the identity; same key schedule)."""
        from gogp import infer

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(32), (4, 2))
        kwargs = dict(n_replicas=3, beta_min=0.3, num_warmup=80, num_samples=40)
        rs = parallel.run_pt_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(5), mesh1, **kwargs
        )
        rl = infer.run_pt_chees(
            mvn_logp, x0, jax.random.PRNGKey(5), n_ladders=4, **kwargs
        )
        assert np.allclose(
            np.asarray(rs.positions), np.asarray(rl.positions), atol=1e-6
        )
        assert np.allclose(np.asarray(rs.betas), np.asarray(rl.betas), atol=1e-6)


class TestShardedGHMC:
    def test_moments_8dev(self, mesh8):
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(40), (16, 2))
        res = parallel.run_ghmc_sharded(
            mvn_logp, x0, jax.random.PRNGKey(0), mesh8,
            num_warmup=600, num_samples=3000,
        )
        pos = np.asarray(res.positions)  # (3000, 16, 2)
        assert pos.shape == (3000, 16, 2)
        flat = pos.reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.15)
        assert np.allclose(np.cov(flat.T), COV, atol=0.35)

    def test_device_count_invariance(self, mesh8, mesh1):
        """Global-parity folds + pmean'd fold moments + fold_in(key, global
        chain index): 1-device and 8-device populations draw the same
        chains up to float reduction order."""
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(41), (16, 2))
        kwargs = dict(num_warmup=100, num_samples=50)
        r8 = parallel.run_ghmc_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh8, **kwargs
        )
        r1 = parallel.run_ghmc_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-5
        )

    def test_matches_local_run_ghmc(self, mesh1):
        from gogp import infer

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(42), (8, 2))
        kwargs = dict(num_warmup=80, num_samples=40)
        rs = parallel.run_ghmc_sharded(
            mvn_logp, x0, jax.random.PRNGKey(5), mesh1, **kwargs
        )
        rl = infer.run_ghmc(mvn_logp, x0, jax.random.PRNGKey(5), **kwargs)
        assert np.allclose(
            np.asarray(rs.positions), np.asarray(rl.positions), atol=1e-6
        )

    def test_odd_local_slab_raises(self, mesh8):
        with np.testing.assert_raises(ValueError):
            parallel.run_ghmc_sharded(
                mvn_logp, jnp.zeros((8, 2)), jax.random.PRNGKey(0),
                mesh8, num_warmup=4, num_samples=4,
            )


class TestShardedChEES:
    def test_moments_8dev(self, mesh8):
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(20), (16, 2))
        res = parallel.run_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(0), mesh8,
            num_warmup=400, num_samples=500,
        )
        pos = np.asarray(res.positions)  # (500, 16, 2)
        assert pos.shape == (500, 16, 2)
        flat = pos.reshape(-1, 2)
        assert np.allclose(flat.mean(axis=0), MEAN, atol=0.15)
        assert np.allclose(np.cov(flat.T), COV, atol=0.35)
        rhat = np.asarray(
            diagnostics.split_rhat(jnp.moveaxis(jnp.asarray(pos), 1, 0))
        )
        assert np.all(rhat < 1.05)

    def test_device_count_invariance(self, mesh8, mesh1):
        """fold_in(key, global chain index) randomness + pmean'd adaptation:
        1-device and 8-device populations draw the same chains (up to float
        reduction order in the cross-device means)."""
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(21), (8, 2))
        kwargs = dict(num_warmup=100, num_samples=50)
        r8 = parallel.run_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh8, **kwargs
        )
        r1 = parallel.run_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(3), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-5
        )

    def test_matches_single_device_run_chees(self, mesh1):
        """The sharded driver on a 1x1 mesh must reproduce infer.run_chees
        exactly — same transitions, same adaptation, pmean over a size-1
        axis is the identity."""
        from gogp import infer

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(22), (4, 2))
        kwargs = dict(num_warmup=80, num_samples=40)
        rs = parallel.run_chees_sharded(
            mvn_logp, x0, jax.random.PRNGKey(5), mesh1, **kwargs
        )
        rl = infer.run_chees(mvn_logp, x0, jax.random.PRNGKey(5), **kwargs)
        assert np.allclose(
            np.asarray(rs.positions), np.asarray(rl.positions), atol=1e-6
        )

    def test_pops_device_count_invariance(self, mesh8, mesh1):
        """Zero-collective layout: populations laid over devices draw what
        the single-device run draws (per-population rng is fold_in(rng,
        global pop index); no cross-device reduction exists to even
        reorder floats — residual risk is only XLA fusion differences
        between per-device batch sizes)."""
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(23), (16, 2))
        kwargs = dict(n_pops=8, num_warmup=100, num_samples=50)
        r8 = parallel.run_chees_pops_sharded(
            mvn_logp, x0, jax.random.PRNGKey(6), mesh8, **kwargs
        )
        r1 = parallel.run_chees_pops_sharded(
            mvn_logp, x0, jax.random.PRNGKey(6), mesh1, **kwargs
        )
        assert np.allclose(
            np.asarray(r8.positions), np.asarray(r1.positions), atol=1e-6
        )

    def test_pops_matches_local(self, mesh8):
        """Sharded populations must equal infer.run_chees_pops exactly."""
        from gogp import infer

        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(24), (16, 2))
        kwargs = dict(n_pops=8, num_warmup=80, num_samples=40)
        rs = parallel.run_chees_pops_sharded(
            mvn_logp, x0, jax.random.PRNGKey(7), mesh8, **kwargs
        )
        rl = infer.run_chees_pops(mvn_logp, x0, jax.random.PRNGKey(7), **kwargs)
        assert np.allclose(
            np.asarray(rs.positions), np.asarray(rl.positions), atol=1e-6
        )
        # per-population scalars survive the shard_map boundary
        assert np.asarray(rs.state.step_size).shape == (8,)

    def test_shared_mass_matrix(self, mesh8):
        def scaled_logp(v):
            return -0.5 * (v[0] ** 2 / 100.0 + v[1] ** 2 / 0.01)

        x0 = jnp.zeros((8, 2))
        res = parallel.run_chees_sharded(
            scaled_logp, x0, jax.random.PRNGKey(1), mesh8,
            num_warmup=600, num_samples=200,
        )
        inv_mass = np.asarray(res.state.inv_mass)  # (2,) shared
        assert inv_mass[0] / inv_mass[1] > 100.0
