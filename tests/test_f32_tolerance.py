"""Device-dtype (float32) accuracy: measured bounds, not anecdotes.

The reference runs entirely in Go float64; the accelerator path is f32.
This file pins what f32 actually costs:

- **Well-noised models** (uniform noise at theta ~ 1 — every tutorial
  study fits here after normalization): LML relative error <= 1e-6 and
  log-theta gradient error <= 1e-5 up to n=1024.  f32 is simply fine.
- **Reference unit goldens** reproduce at f32 to ~1e-5 (the 1e-6 contract
  itself needs f64, which tests/test_gp_golden.py keeps).
- **Jitter-only noise** (the reference default: std 1e-5, variance 1e-10,
  gp/gp.go:43-47) makes K numerically singular at f32 (condition ~1e10 vs
  f32 eps ~1e-7): the factorization NaNs.  That is NOT a bug to paper
  over — the same matrix is near-singular in f64 too (lml ~ -4e8) — but
  the failure must degrade, not crash: ``absorb(robust=True)`` rescues a
  finite factor via escalating jitter, and the NaN log-density is mapped
  to a rejected proposal by every sampler (DESIGN.md §7).  f32 users
  should give models a learnable/representable noise floor (std >= ~1e-3)
  as all five tutorial studies do.

These run on CPU in f32 (x64 disabled per-test); the arithmetic is
IEEE-identical to the GPU's at "highest" matmul precision except for
fused-multiply-add scheduling, which the tolerance margins absorb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp.gp.core import GP, absorb, lml_from_posterior, predict_from_posterior
from gogp.kernels import matern52_ref, normal, rbf, uniform_noise
from gogp.models.params import gp_observe


@pytest.fixture
def f32():
    with jax.enable_x64(False):
        yield


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, n / 6, (n, 1)), axis=0)
    y = np.sin(x[:, 0] / 3.0) + 0.1 * rng.normal(size=n)
    return x, y


class TestWellNoisedF32:
    @pytest.mark.parametrize("n", [33, 128, 512, 1024])
    def test_lml_and_grad_match_f64(self, n, f32):
        gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _problem(n)
        # f64 oracle computed OUTSIDE the f32 context via numpy/scipy-free
        # double precision: rebuild with x64 enabled
        with jax.enable_x64(True):
            l64, g64 = jax.value_and_grad(
                lambda v: gp_observe(
                    gp, v, x=jnp.asarray(x, jnp.float64), y=jnp.asarray(y, jnp.float64)
                )
            )(jnp.zeros(3, jnp.float64))
            l64, g64 = float(l64), np.asarray(g64)
        l32, g32 = jax.value_and_grad(
            lambda v: gp_observe(
                gp, v, x=jnp.asarray(x, jnp.float32), y=jnp.asarray(y, jnp.float32)
            )
        )(jnp.zeros(3, jnp.float32))
        rel_l = abs(float(l32) - l64) / abs(l64)
        rel_g = np.max(np.abs(np.asarray(g32) - g64) / (np.abs(g64) + 1.0))
        # measured: <= 5.2e-8 / 4.0e-7 across n; margin 20x
        assert rel_l <= 1e-6, (n, rel_l)
        assert rel_g <= 1e-5, (n, rel_g)


class TestGoldensF32:
    """Reference gp_test.go golden cases at device dtype."""

    def test_predict_golden_inter(self, f32):
        # gp_test.go "inter": x={0,1}, y={1,-1}, sigma(0.5)=0.174518
        from gogp.kernels import constant_noise

        gp = GP(ndim=1, simil=normal, noise=constant_noise(0.0))
        x = jnp.asarray([[0.0], [1.0]], jnp.float32)
        y = jnp.asarray([1.0, -1.0], jnp.float32)
        post = absorb(gp, jnp.ones(1, jnp.float32), jnp.zeros(0, jnp.float32), x, y)
        mu, sigma = predict_from_posterior(gp, post, jnp.asarray([[0.5]], jnp.float32))
        assert abs(float(mu[0]) - 0.0) < 1e-5
        assert abs(float(sigma[0]) - 0.174518) < 1e-4

    def test_lml_goldens(self, f32):
        # gp_test.go "withnoise"/"uninoise" through the flat-vector
        # protocol at f32; the f64 contract is 1e-6 (test_gp_golden.py)
        from gogp.kernels import constant_noise

        for noise, v, want in [
            (constant_noise(0.1), [1.0, -2.0, -1.0, 1.0, 0.0], -4.321055),
            (uniform_noise, [1.0, 1.0, -1.0, -1.0, 1.0, 0.0], -4.018110),
        ]:
            gp = GP(ndim=1, simil=normal, noise=noise)
            got = float(gp_observe(gp, jnp.asarray(v, jnp.float32)))
            assert abs(got - want) < 1e-4, (got, want)


class TestIllConditionedF32:
    """Jitter-only noise (reference default, variance 1e-10) at f32."""

    def test_plain_factorization_nans(self, f32):
        gp = GP(ndim=1, simil=rbf.scaled())  # constant_noise(1e-5)
        x, y = _problem(33)
        l32 = gp_observe(
            gp, jnp.zeros(2, jnp.float32),
            x=jnp.asarray(x, jnp.float32), y=jnp.asarray(y, jnp.float32),
        )
        # documents the failure mode: near-singular K at f32 -> non-finite
        assert not bool(jnp.isfinite(l32))

    def test_robust_absorb_rescues_finite(self, f32):
        gp = GP(ndim=1, simil=rbf.scaled())
        x, y = _problem(33)
        post = absorb(
            gp, jnp.ones(2, jnp.float32), jnp.zeros(0, jnp.float32),
            jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32), robust=True,
        )
        lml = lml_from_posterior(post)
        assert bool(jnp.isfinite(lml)), float(lml)
        mu, sigma = predict_from_posterior(gp, post, jnp.asarray(x[:3], jnp.float32))
        assert bool(jnp.all(jnp.isfinite(mu))) and bool(jnp.all(jnp.isfinite(sigma)))

    def test_sampler_degrades_not_crashes(self, f32):
        """A NaN log-density becomes a rejected proposal, not a crash."""
        from gogp.infer import run_smc

        gp = GP(ndim=1, simil=matern52_ref.scaled())  # jitter-only noise
        x, y = _problem(16)
        xj = jnp.asarray(x, jnp.float32)
        yj = jnp.asarray(y, jnp.float32)

        def logp(v):
            return gp_observe(gp, v, x=xj, y=yj)

        res = run_smc(
            logp, jnp.zeros(2, jnp.float32), jax.random.PRNGKey(0),
            num_particles=32, num_mcmc_steps=2, max_stages=10, mutation="rwm",
        )
        assert bool(jnp.all(jnp.isfinite(res.particles)))


class TestIterativeF32:
    """f32 behavior of the matrix-free path (ops/iterative) on CPU: the
    arithmetic is IEEE-f32 like the GPU's "highest" matmul precision (a
    reduced-precision matvec failure — NaN at cond ~1e6 — is below what
    CPU f32 can reproduce; the CG curvature guard covering it is
    unit-tested in test_iterative.py)."""

    def test_well_noised_matches_f64(self, f32):
        from gogp.gp.core import lml_iterative

        gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        x, y = _problem(256)
        key = jax.random.PRNGKey(3)
        kw = dict(num_probes=32, cg_iters=300, lanczos_iters=48)
        with jax.enable_x64(True):
            l64 = float(
                lml_iterative(
                    gp, jnp.ones(2, jnp.float64), jnp.ones(1, jnp.float64),
                    jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                    key, **kw,
                )
            )
        l32 = float(
            lml_iterative(
                gp, jnp.ones(2, jnp.float32), jnp.ones(1, jnp.float32),
                jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                key, **kw,
            )
        )
        # same probes, same estimator: f32 shifts the Lanczos/CG
        # trajectories at roundoff, moving the quadrature by ~1e-3
        # relative (measured 8e-4 here) — an order below the estimator's
        # own ~1/sqrt(p) error, so f32 costs nothing that matters
        assert abs(l32 - l64) <= 2e-3 * abs(l64), (l32, l64)

    def test_pcg_ill_conditioned_f32(self, f32):
        """The dense-data/small-noise covariance at f32: preconditioned
        CG still reaches the direct solution (cond ~1e2 here; the guard
        keeps harder cases finite rather than exact)."""
        from gogp.ops.iterative import cg_solve, pivoted_precond

        rng = np.random.default_rng(5)
        n = 256
        xs = np.sort(rng.uniform(0, 10, n))
        K = np.exp(-0.5 * (xs[:, None] - xs[None, :]) ** 2 / 4.0)
        Kj = jnp.asarray(K + 1e-2 * np.eye(n), jnp.float32)
        yv = jnp.asarray(rng.normal(size=n), jnp.float32)
        pc = pivoted_precond(Kj, 32, 1e-2)
        xsol, _ = cg_solve(Kj, yv, max_iters=500, tol=1e-6, precond=pc)
        with jax.enable_x64(True):
            direct = np.linalg.solve(np.asarray(Kj, np.float64), np.asarray(yv, np.float64))
        rel = float(np.linalg.norm(np.asarray(xsol) - direct) / np.linalg.norm(direct))
        assert rel < 5e-4, rel

    def test_matfree_precond_f32(self, f32):
        """The matrix-free preconditioned LML at f32 (an ill-conditioned
        stress configuration, scaled down): finite
        and within the estimator contract of the f64 exact value."""
        from gogp.gp.core import lml, lml_iterative_matfree

        gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
        rng = np.random.default_rng(11)
        n = 256
        x = np.sort(rng.uniform(0, 10, (n, 1)), axis=0)
        y = np.sin(x[:, 0]) + 0.05 * rng.normal(size=n)
        ts = jnp.asarray([1.0, 2.0], jnp.float32)
        tn = jnp.asarray([0.05], jnp.float32)
        key = jax.random.PRNGKey(9)

        def f(v_ts, v_tn):
            return lml_iterative_matfree(
                gp, v_ts, v_tn, jnp.asarray(x, jnp.float32),
                jnp.asarray(y, jnp.float32), key, panel=64,
                num_probes=16, cg_iters=300, lanczos_iters=24,
                precond_rank=32,
            )

        val, grads = jax.value_and_grad(f, argnums=(0, 1))(ts, tn)
        assert np.isfinite(float(val))
        assert all(np.isfinite(np.asarray(g)).all() for g in grads)
        with jax.enable_x64(True):
            exact = float(
                lml(gp, jnp.asarray(ts, jnp.float64), jnp.asarray(tn, jnp.float64),
                    jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
            )
        assert abs(float(val) - exact) <= 5e-3 * abs(exact), (float(val), exact)
