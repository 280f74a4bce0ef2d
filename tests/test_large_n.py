"""Large-N sharded SMC: row-sharded log-density vs the dense oracle, and
posterior agreement with the serial sampler (BASELINE.json large-N config,
scaled down to the fake 8-device CPU mesh)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from gogp import infer, parallel
from gogp.gp.core import GP
from gogp.kernels import rbf, uniform_noise
from gogp.models.params import gp_observe
from gogp.parallel import DATA_AXIS
from gogp.parallel.large_n import make_rowsharded_logp


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(n_chain=1, n_data=8)


@pytest.fixture(scope="module")
def problem():
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    n = 64
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return gp, jnp.asarray(x), jnp.asarray(y)


class TestRowShardedLogp:
    def test_matches_dense(self, mesh, problem):
        gp, x, y = problem
        n = x.shape[0]
        mask = jnp.ones(n)

        def device_fn(x_local, y_local, m_local, v):
            x_full = jax.lax.all_gather(x_local, DATA_AXIS, tiled=True)
            logp = make_rowsharded_logp(
                gp, x_local, x_full, y_local, m_local, DATA_AXIS, block=8
            )
            return logp(v)

        f = jax.jit(
            jax.shard_map(
                device_fn,
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        for v in [jnp.zeros(3), jnp.array([0.3, -0.5, -1.0])]:
            got = float(f(x, y, mask, v))
            want = float(gp_observe(gp, v, x=x, y=y, mask=mask))
            assert np.isclose(got, want, atol=1e-8), (got, want)

    def test_padding_correction(self, mesh, problem):
        gp, x, y = problem
        n = x.shape[0]
        mask = jnp.concatenate([jnp.ones(n - 16), jnp.zeros(16)])

        def device_fn(x_local, y_local, m_local, v):
            x_full = jax.lax.all_gather(x_local, DATA_AXIS, tiled=True)
            logp = make_rowsharded_logp(
                gp, x_local, x_full, y_local, m_local, DATA_AXIS, block=8
            )
            return logp(v)

        f = jax.jit(
            jax.shard_map(
                device_fn,
                mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        v = jnp.zeros(3)
        got = float(f(x, y, mask, v))
        want = float(gp_observe(gp, v, x=x, y=y, mask=mask))
        assert np.isclose(got, want, atol=1e-8), (got, want)


class TestRowShardedIterative:
    def test_matches_dense_iterative(self, mesh, problem):
        """make_rowsharded_logp(method='iterative') on the 8-device data
        mesh must reproduce the dense lml_core_iterative with the same
        probe key — value and psum-completed theta gradient — up to float
        reassociation of the gathered matvecs."""
        from gogp.gp.core import lml_iterative, masked_cov
        from gogp.parallel.large_n import psum_grads

        gp, x, y = problem
        n = x.shape[0]
        mask = jnp.ones(n)
        key = jax.random.PRNGKey(11)
        kwargs = dict(num_probes=16, cg_iters=300, lanczos_iters=32)
        v = jnp.asarray([0.2, -0.1, -1.0])

        def dense(v):
            th = jnp.exp(v)
            return lml_iterative(gp, th[:2], th[2:], x, y, key, **kwargs)

        ve, ge = jax.value_and_grad(dense)(v)

        def device_fn(x_local, y_local, m_local):
            logp = psum_grads(
                make_rowsharded_logp(
                    gp, x_local,
                    jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
                    y_local, m_local, DATA_AXIS, block=8,
                    method="iterative", key=key, **kwargs,
                ),
                DATA_AXIS,
            )
            return jax.value_and_grad(logp)(v)

        fn = jax.jit(
            jax.shard_map(
                device_fn, mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )
        vs, gs = fn(x, y, jnp.ones(n))
        assert abs(float(vs - ve)) < 1e-5 * abs(float(ve)), (float(vs), float(ve))
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ge), rtol=1e-4, atol=1e-4)

    def test_precond_matches_dense_precond(self, mesh, problem):
        """precond_rank on the row-sharded path: the pivoted-Cholesky
        preconditioner built from all_gathered column slices must
        reproduce the dense PCG + preconditioned-SLQ estimate with the
        same key — value and psum-completed theta gradient."""
        from gogp.gp.core import lml_iterative
        from gogp.parallel.large_n import psum_grads

        gp, x, y = problem
        n = x.shape[0]
        key = jax.random.PRNGKey(17)
        kwargs = dict(num_probes=16, cg_iters=200, lanczos_iters=24,
                      precond_rank=16)
        v = jnp.asarray([0.2, -0.1, -1.0])

        def dense(v):
            th = jnp.exp(v)
            return lml_iterative(gp, th[:2], th[2:], x, y, key, **kwargs)

        ve, ge = jax.value_and_grad(dense)(v)

        def device_fn(x_local, y_local, m_local):
            logp = psum_grads(
                make_rowsharded_logp(
                    gp, x_local,
                    jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
                    y_local, m_local, DATA_AXIS, block=8,
                    method="iterative", key=key, **kwargs,
                ),
                DATA_AXIS,
            )
            return jax.value_and_grad(logp)(v)

        fn = jax.jit(
            jax.shard_map(
                device_fn, mesh=mesh,
                in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )
        vs, gs = fn(x, y, jnp.ones(n))
        assert abs(float(vs - ve)) < 1e-5 * abs(float(ve)), (float(vs), float(ve))
        np.testing.assert_allclose(np.asarray(gs), np.asarray(ge), rtol=1e-4, atol=1e-4)


class TestLargeNSMC:
    def test_mesh_composition_invariance(self, problem):
        """2x4 / 4x2 / 1x8 meshes: particles shard over the chain axis and
        each particle's LML collectives ride the data axis; identical
        global PRNG streams must give the same posterior up to float
        reassociation of the data-axis psums."""
        gp, x, y = problem
        results = []
        for c, d in [(1, 8), (2, 4), (4, 2)]:
            mesh = parallel.make_mesh(n_chain=c, n_data=d)
            res = parallel.run_smc_large_n(
                gp, x, y, jax.random.PRNGKey(0), mesh,
                num_particles=64, sigma0=1.5, num_mcmc_steps=3, block=8,
            )
            assert bool(res.betas_hit_one), (c, d)
            parts = np.asarray(res.particles)
            assert np.all(np.isfinite(parts)), (c, d)
            results.append(parts)
        for r in results[1:]:
            assert np.allclose(results[0].mean(axis=0), r.mean(axis=0), atol=5e-2)
            assert np.allclose(results[0].std(axis=0), r.std(axis=0), atol=5e-2)

    def test_chees_large_n_matches_dense_chees(self, problem):
        """Full-posterior ChEES with the covariance row-sharded (2 chain x
        4 data mesh) must sample the same posterior as dense single-program
        ChEES on the same logp, within Monte-Carlo error."""
        gp, x, y = problem
        mesh = parallel.make_mesh(n_chain=2, n_data=4)
        res = parallel.run_chees_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh,
            num_chains=8, num_warmup=200, num_samples=300, block=8,
            sigma0=0.5, init_step_size=0.05, init_traj_length=0.5,
        )
        pos = np.asarray(res.positions)  # (300, 8, 3)
        assert pos.shape == (300, 8, 3)
        assert np.all(np.isfinite(pos))
        assert float(np.mean(np.asarray(res.accept_probs))) > 0.4

        mask = jnp.ones(x.shape[0])

        def dense_logp(v):
            return gp_observe(gp, v, x=x, y=y, mask=mask)

        dense = infer.run_chees(
            dense_logp,
            0.5 * jax.random.normal(jax.random.PRNGKey(5), (8, 3)),
            jax.random.PRNGKey(1), num_warmup=200, num_samples=300,
            init_step_size=0.05, init_traj_length=0.5,
        )
        dp = np.asarray(dense.positions).reshape(-1, 3)
        sp = pos.reshape(-1, 3)
        assert np.allclose(sp.mean(axis=0), dp.mean(axis=0), atol=0.3), (
            sp.mean(axis=0), dp.mean(axis=0),
        )
        assert np.allclose(sp.std(axis=0), dp.std(axis=0), atol=0.3)

    def test_chees_large_n_iterative_surrogate(self, problem):
        """method='iterative' (fixed-probe CG/SLQ surrogate target) must
        sample the same posterior as the exact row-sharded path within
        MC + estimator error."""
        gp, x, y = problem
        mesh = parallel.make_mesh(n_chain=2, n_data=4)
        kwargs = dict(
            num_chains=8, num_warmup=150, num_samples=200, block=8,
            sigma0=0.5, init_step_size=0.05, init_traj_length=0.5,
        )
        ri = parallel.run_chees_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh, method="iterative",
            num_probes=32, cg_iters=300, lanczos_iters=48, **kwargs,
        )
        re = parallel.run_chees_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh, **kwargs,
        )
        pi = np.asarray(ri.positions).reshape(-1, 3)
        pe = np.asarray(re.positions).reshape(-1, 3)
        assert np.all(np.isfinite(pi))
        assert np.allclose(pi.mean(axis=0), pe.mean(axis=0), atol=0.3), (
            pi.mean(axis=0), pe.mean(axis=0),
        )
        assert np.allclose(pi.std(axis=0), pe.std(axis=0), atol=0.3)

    def test_chees_large_n_ski_surrogate(self, problem):
        """method='ski' (fixed-probe SKI O(N log N) surrogate; chains
        sharded over EVERY mesh axis, x/y replicated) must sample the same
        posterior as the exact row-sharded path within MC + estimator +
        interpolation error."""
        gp, x, y = problem
        mesh = parallel.make_mesh(n_chain=2, n_data=4)
        kwargs = dict(
            num_chains=8, num_warmup=150, num_samples=200,
            sigma0=0.5, init_step_size=0.05, init_traj_length=0.5,
        )
        rs = parallel.run_chees_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh, method="ski",
            grid_size=256, num_probes=32, cg_iters=200, lanczos_iters=48,
            **kwargs,
        )
        re = parallel.run_chees_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh, block=8, **kwargs,
        )
        ps = np.asarray(rs.positions).reshape(-1, 3)
        pe = np.asarray(re.positions).reshape(-1, 3)
        assert np.all(np.isfinite(ps))
        assert np.allclose(ps.mean(axis=0), pe.mean(axis=0), atol=0.3), (
            ps.mean(axis=0), pe.mean(axis=0),
        )
        assert np.allclose(ps.std(axis=0), pe.std(axis=0), atol=0.3)

    def test_chees_large_n_ski_rejects_mask(self, problem):
        gp, x, y = problem
        mesh = parallel.make_mesh(n_chain=2, n_data=4)
        with pytest.raises(ValueError, match="padding mask"):
            parallel.run_chees_large_n(
                gp, x, y, jax.random.PRNGKey(0), mesh, method="ski",
                mask=jnp.ones(x.shape[0]),
            )

    def test_chees_large_n_mesh_invariance(self, problem):
        """1x8 / 2x4 / 4x2 meshes agree on the sampled posterior moments
        (global-chain-index randomness; data-axis psums reassociate)."""
        gp, x, y = problem
        results = []
        for c, d in [(1, 8), (2, 4), (4, 2)]:
            mesh = parallel.make_mesh(n_chain=c, n_data=d)
            res = parallel.run_chees_large_n(
                gp, x, y, jax.random.PRNGKey(0), mesh,
                num_chains=8, num_warmup=150, num_samples=200, block=8,
                sigma0=0.5, init_step_size=0.05, init_traj_length=0.5,
            )
            pos = np.asarray(res.positions).reshape(-1, 3)
            assert np.all(np.isfinite(pos)), (c, d)
            results.append(pos)
        for r in results[1:]:
            assert np.allclose(results[0].mean(axis=0), r.mean(axis=0), atol=0.25)
            assert np.allclose(results[0].std(axis=0), r.std(axis=0), atol=0.25)

    def test_posterior_moments_match_serial(self, mesh, problem):
        gp, x, y = problem
        res = parallel.run_smc_large_n(
            gp, x, y, jax.random.PRNGKey(0), mesh,
            num_particles=256, sigma0=1.5, num_mcmc_steps=5, block=8,
        )
        assert bool(res.betas_hit_one)
        parts = np.asarray(res.particles)
        assert np.all(np.isfinite(parts))

        # serial oracle on the dense logp
        mask = jnp.ones(x.shape[0])

        def dense_logp(v):
            return gp_observe(gp, v, x=x, y=y, mask=mask)

        serial = infer.run_smc(
            dense_logp, jnp.zeros(3), jax.random.PRNGKey(1),
            num_particles=256, sigma0=1.5, num_mcmc_steps=5, mutation="rwm",
        )
        sp = np.asarray(serial.particles)
        # same posterior within Monte-Carlo error
        assert np.allclose(parts.mean(axis=0), sp.mean(axis=0), atol=0.3), (
            parts.mean(axis=0), sp.mean(axis=0),
        )
