"""Serving caches (gp/serve.py) vs the exact predict path.

The serving layer must be *semantically invisible*: compile_posterior +
serve_predict is the same function as predict_from_posterior (reference
Produce, gp/gp.go:258-360), just restructured for matmul serving; the mixture
cache must reproduce gp.core.predict_mixture's moments.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gogp.gp import core, serve
from gogp.kernels import matern32, rbf, uniform_noise


def _problem(n=40, seed=0):
    gp = core.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return gp, jnp.asarray(x), jnp.asarray(y)


class TestServePredict:
    def test_matches_exact_predict(self):
        gp, x, y = _problem()
        post = core.absorb(gp, jnp.array([1.0, 0.7]), jnp.array([0.3]), x, y)
        sp = serve.compile_posterior(gp, post)
        z = jnp.linspace(-1.0, 11.0, 33)[:, None]
        mu1, s1 = serve.serve_predict(gp, sp, z)
        mu2, s2 = core.predict_from_posterior(gp, post, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-8)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-7)

    def test_fit_serving_one_shot(self):
        gp, x, y = _problem(seed=1)
        sp = serve.fit_serving(gp, jnp.array([1.0, 1.0]), jnp.array([0.2]), x, y)
        mu1, s1 = serve.serve_predict(gp, sp, x[:5])
        mu2, s2 = core.predict(gp, jnp.array([1.0, 1.0]), jnp.array([0.2]), x, y, x[:5])
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-8)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-7)

    def test_padding_invisible(self):
        # padded rows must not leak into served predictions
        gp, x, y = _problem(n=24, seed=2)
        n_pad = 8
        xp = jnp.concatenate([x, jnp.zeros((n_pad, 1))])
        yp = jnp.concatenate([y, jnp.zeros(n_pad)])
        mask = jnp.concatenate([jnp.ones(24), jnp.zeros(n_pad)])
        z = jnp.linspace(0.0, 10.0, 17)[:, None]
        sp = serve.fit_serving(gp, jnp.array([0.8, 1.2]), jnp.array([0.3]), xp, yp, mask)
        mu1, s1 = serve.serve_predict(gp, sp, z)
        sp0 = serve.fit_serving(gp, jnp.array([0.8, 1.2]), jnp.array([0.3]), x, y)
        mu2, s2 = serve.serve_predict(gp, sp0, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-7)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-7)

    def test_no_observations_prior_fallback(self):
        # all-padding: mu = 0, sigma = prior std (gp/gp.go:343-347)
        gp, x, y = _problem(n=8, seed=3)
        mask = jnp.zeros(8)
        sp = serve.fit_serving(gp, jnp.array([0.5, 0.9]), jnp.array([0.1]), x, y, mask)
        z = jnp.linspace(0.0, 5.0, 9)[:, None]
        mu, s = serve.serve_predict(gp, sp, z)
        mu0, s0 = core.predict_prior(gp, jnp.array([0.5, 0.9]), z)
        assert np.allclose(np.asarray(mu), 0.0, atol=1e-9)
        assert np.allclose(np.asarray(s), np.asarray(s0), atol=1e-8)

    def test_jit_and_checkpoint_roundtrip(self, tmp_path):
        from gogp.utils import checkpoint

        gp, x, y = _problem(seed=4)
        sp = serve.fit_serving(gp, jnp.array([1.0, 0.5]), jnp.array([0.4]), x, y)
        z = jnp.linspace(0.0, 10.0, 16)[:, None]
        mu1, s1 = jax.jit(lambda sp, z: serve.serve_predict(gp, sp, z))(sp, z)
        checkpoint.save(tmp_path / "sp", sp)
        sp2 = checkpoint.restore(tmp_path / "sp", like=sp)
        mu2, s2 = serve.serve_predict(gp, sp2, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-12)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-12)


class TestServeMixture:
    def test_matches_predict_mixture(self):
        gp, x, y = _problem(n=28, seed=5)
        rng = np.random.default_rng(6)
        vs = jnp.asarray(0.3 * rng.normal(size=(7, gp.n_theta)))
        z = jnp.linspace(-0.5, 10.5, 21)[:, None]
        sm = serve.compile_mixture(gp, vs, x, y)
        mu1, s1 = serve.serve_predict_mixture(gp, sm, z)
        mu2, s2 = core.predict_mixture(gp, vs, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-7)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)

    def test_different_kernel(self):
        gp = core.GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise)
        rng = np.random.default_rng(7)
        x = jnp.asarray(np.sort(rng.uniform(0, 6, (20, 1)), axis=0))
        y = jnp.asarray(np.cos(np.asarray(x[:, 0])))
        vs = jnp.asarray(0.2 * rng.normal(size=(4, gp.n_theta)))
        sm = serve.compile_mixture(gp, vs, x, y)
        z = x[::3]
        mu1, s1 = serve.serve_predict_mixture(gp, sm, z)
        mu2, s2 = core.predict_mixture(gp, vs, x, y, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-7)
        assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)


class TestJointServing:
    """Joint predictive covariance + posterior function draws — the
    reference computes the full m x m internally and keeps only the
    diagonal (gp/gp.go:337-342); serving exposes it."""

    def test_cov_diag_matches_marginal_sigma(self):
        gp, x, y = _problem(seed=8)
        sp = serve.fit_serving(gp, jnp.array([1.0, 0.8]), jnp.array([0.2]), x, y)
        z = jnp.linspace(0.0, 10.0, 14)[:, None]
        mu1, cov = serve.serve_predict_cov(gp, sp, z)
        mu2, s2 = serve.serve_predict(gp, sp, z)
        assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-12)
        d = np.sqrt(np.maximum(np.diagonal(np.asarray(cov)), 0.0))
        assert np.allclose(d, np.asarray(s2), atol=1e-10)

    def test_cov_psd_and_symmetric(self):
        gp, x, y = _problem(seed=9)
        sp = serve.fit_serving(gp, jnp.array([0.7, 1.1]), jnp.array([0.3]), x, y)
        z = jnp.linspace(-2.0, 12.0, 20)[:, None]
        _, cov = serve.serve_predict_cov(gp, sp, z)
        cov = np.asarray(cov)
        assert np.allclose(cov, cov.T, atol=1e-10)
        assert np.linalg.eigvalsh(cov + 1e-9 * np.eye(20)).min() > -1e-8

    def test_sample_moments(self):
        gp, x, y = _problem(seed=10)
        sp = serve.fit_serving(gp, jnp.array([1.0, 0.8]), jnp.array([0.2]), x, y)
        z = jnp.linspace(0.0, 10.0, 9)[:, None]
        mu, s = serve.serve_predict(gp, sp, z)
        draws = serve.serve_sample(gp, sp, z, jax.random.PRNGKey(1), 20000)
        assert draws.shape == (20000, 9)
        assert np.allclose(np.asarray(jnp.mean(draws, 0)), np.asarray(mu), atol=0.02)
        assert np.allclose(np.asarray(jnp.std(draws, 0)), np.asarray(s), atol=0.02)

    def test_samples_interpolate_observations(self):
        # at an observed point with tiny noise, every draw passes through y
        # (well-spaced points: a dense near-singular K would put the
        # interpolation residual at cond(K)*eps instead)
        from gogp.kernels import constant_noise, rbf as _rbf

        gp0 = core.GP(ndim=1, simil=_rbf.scaled(), noise=constant_noise(1e-5))
        x = jnp.linspace(0.0, 10.0, 8)[:, None]
        y = jnp.sin(x[:, 0])
        sp = serve.fit_serving(gp0, jnp.array([1.0, 0.8]), jnp.zeros(0), x, y)
        draws = serve.serve_sample(gp0, sp, x[:4], jax.random.PRNGKey(2), 64)
        spread = float(jnp.max(jnp.abs(draws - y[None, :4])))
        assert spread < 1e-3, spread


class TestNoiseInclusiveBands:
    """predict_y / serve_predict_y: sigma_y^2 = sigma_f^2 + noise_var(z).

    The reference's Produce excludes observation noise by contract
    (gp/gp.go:270-278) and the plain predict paths keep that bit-for-bit;
    these are the additive forecast-interval variants."""

    def test_serve_predict_y_matches_manual(self):
        gp, x, y = _problem(n=48, seed=3)
        ts, tn = jnp.array([1.0, 0.7]), jnp.array([0.3])
        sp = serve.fit_serving(gp, ts, tn, x, y)
        z = jnp.linspace(-1.0, 11.0, 33)[:, None]
        mu_f, s_f = serve.serve_predict(gp, sp, z)
        mu_y, s_y = serve.serve_predict_y(gp, sp, z)
        np.testing.assert_allclose(np.asarray(mu_y), np.asarray(mu_f), atol=1e-12)
        want = np.sqrt(np.asarray(s_f) ** 2 + float(tn[0]) ** 2)
        np.testing.assert_allclose(np.asarray(s_y), want, atol=1e-10)
        # y-bands strictly dominate latent bands under positive noise
        assert np.all(np.asarray(s_y) > np.asarray(s_f))

    def test_core_predict_y_agrees_with_serve(self):
        from gogp.gp.core import absorb as _absorb, predict_y_from_posterior

        gp, x, y = _problem(n=32, seed=4)
        ts, tn = jnp.array([0.8, 1.1]), jnp.array([0.2])
        post = _absorb(gp, ts, tn, x, y)
        z = jnp.linspace(0.0, 10.0, 17)[:, None]
        mu_c, s_c = predict_y_from_posterior(gp, post, z)
        sp = serve.compile_posterior(gp, post)
        mu_s, s_s = serve.serve_predict_y(gp, sp, z)
        np.testing.assert_allclose(np.asarray(mu_c), np.asarray(mu_s), atol=1e-9)
        np.testing.assert_allclose(np.asarray(s_c), np.asarray(s_s), atol=1e-9)

    def test_mixture_y_averages_per_draw_noise(self):
        # two draws with DIFFERENT noise thetas: the observation variance
        # must enter as E_s[noise_s], not any single draw's value
        gp, x, y = _problem(n=24, seed=6)
        vs = jnp.log(
            jnp.asarray([[1.0, 0.8, 0.1], [1.2, 0.9, 0.4]])
        )  # log-scale Observe layout
        sm = serve.compile_mixture(gp, vs, x, y)
        z = jnp.linspace(0.0, 10.0, 11)[:, None]
        mu, s_f = serve.serve_predict_mixture(gp, sm, z)
        mu_y, s_y = serve.serve_predict_mixture_y(gp, sm, z)
        np.testing.assert_allclose(np.asarray(mu_y), np.asarray(mu), atol=1e-12)
        mean_nv = 0.5 * (0.1**2 + 0.4**2)
        want = np.sqrt(np.asarray(s_f) ** 2 + mean_nv)
        np.testing.assert_allclose(np.asarray(s_y), want, atol=1e-9)

    def test_zero_noise_reduces_to_latent_bands(self):
        from gogp.gp.core import absorb as _absorb, predict_y_from_posterior
        from gogp.kernels import constant_noise, rbf

        gp0 = core.GP(1, rbf.scaled(), noise=constant_noise(0.0))
        rng = np.random.default_rng(0)
        x = np.sort(rng.uniform(0, 10, (24, 1)), axis=0)
        y = np.sin(x[:, 0])
        post = _absorb(gp0, jnp.array([1.0, 1.0]), jnp.zeros(0), x, y)
        z = jnp.linspace(0.0, 10.0, 9)[:, None]
        _, s_f = core.predict_from_posterior(gp0, post, z)
        _, s_y = predict_y_from_posterior(gp0, post, z)
        np.testing.assert_allclose(np.asarray(s_y), np.asarray(s_f), atol=1e-12)


class TestPrecisionDefaults:
    """The serving default precision is a tested contract.

    The predictive variance is prior - explained, a near cancellation: at
    TF32 (JAX's default for float32 products on the GPU) served sigma
    measured 2.4e-3 max abs error at n=4096 on an H100 at 400 W, against
    1.8e-6 at "highest".  Every sigma-producing serve entry point therefore defaults
    to linalg.ACCURATE_PRECISION; this pins that contract so a silent
    default-regression to the fast-wrong choice fails loudly.  The on-card
    error is re-measured by chip_smoke.py's serving phase.
    """

    def test_default_is_accurate_precision(self):
        import inspect

        from gogp.ops import linalg

        assert linalg.ACCURATE_PRECISION == "highest"
        for fn in (
            serve.serve_predict,
            serve.serve_predict_cov,
            serve.serve_sample,
            serve.serve_predict_mixture,
        ):
            default = inspect.signature(fn).parameters["precision"].default
            assert default == linalg.ACCURATE_PRECISION, fn.__name__

    def test_sharded_serving_inherits_default(self):
        import inspect

        from gogp.ops import linalg
        from gogp.parallel import serving as pserving

        for name in ("serve_predict_sharded", "serve_predict_mixture_sharded"):
            fn = getattr(pserving, name, None)
            if fn is None:
                continue
            default = inspect.signature(fn).parameters["precision"].default
            assert default == linalg.ACCURATE_PRECISION, name

    def test_default_sigma_matches_oracle(self):
        # Under the shipped default the served sigma must agree with the
        # exact-path oracle (on the CPU the precision hint is exact; on the
        # GPU chip_smoke.py asserts the float32 bound).
        gp, x, y = _problem(n=64, seed=5)
        post = core.absorb(gp, jnp.array([1.0, 0.7]), jnp.array([0.3]), x, y)
        sp = serve.compile_posterior(gp, post)
        z = jnp.linspace(-1.0, 11.0, 65)[:, None]
        _, s_served = serve.serve_predict(gp, sp, z)
        _, s_exact = core.predict_from_posterior(gp, post, z)
        assert float(jnp.max(jnp.abs(s_served - s_exact))) < 1e-7
