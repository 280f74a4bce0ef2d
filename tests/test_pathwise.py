"""Pathwise (decoupled) posterior sampling: random-feature priors +
Matheron conditioning (gp/pathwise.py).

Validates the three layers independently:
- the sampled feature expansion reproduces each supported kernel
  (Bochner: E[Phi Phi^T] -> K as F -> inf);
- prior paths have the GP prior's moments;
- conditioned paths have the exact posterior's moments (mean is exact in
  expectation for ANY feature count; covariance converges in F) — checked
  against the core predict path (reference Produce semantics,
  gp/gp.go:258-360).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gogp.gp import pathwise
from gogp.gp.core import GP, absorb, predict_from_posterior
from gogp.gp.serve import compile_posterior, serve_predict_cov
from gogp.kernels import (
    matern12,
    matern32,
    matern52,
    matern52_ref,
    normal,
    periodic,
    rational_quadratic,
    spectral_mixture,
    uniform_noise,
)

KEY = jax.random.PRNGKey(7)


def _khat(kernel, theta, pts, f=16384, ndim=1, key=KEY):
    feat = pathwise.sample_features(kernel, jnp.asarray(theta, jnp.float64), key, f, ndim)
    phi = pathwise.eval_features(feat, pts)
    return phi @ phi.T


CASES = [
    ("rbf", normal, [1.3], 1),
    ("matern12", matern12, [0.8], 1),
    ("matern32", matern32, [0.8], 1),
    ("matern52", matern52, [1.1], 1),
    ("matern52_ref", matern52_ref, [1.1], 1),
    ("matern52_ref_2d", matern52_ref, [0.9], 2),
    ("periodic", periodic, [1.1, 2.3], 1),
    ("rq", rational_quadratic, [1.0, 1.5], 1),
    ("scaled_rbf", normal.scaled(), [1.7, 0.9], 1),
    ("sum", normal.scaled() + matern32.scaled(), [0.8, 1.2, 1.4, 0.7], 1),
    ("prod", normal * matern32, [1.5, 0.9], 1),
    ("sm", spectral_mixture(2), [0.6, 0.9, 0.3, 1.1, 0.05, 0.2], 1),
    ("rbf2d", normal, [1.0], 2),
    ("ard", normal.ard(2), [0.7, 1.9, 1.0], 2),
    ("matern32_2d", matern32, [1.2], 2),
]


@pytest.mark.parametrize("name,kernel,theta,ndim", CASES, ids=[c[0] for c in CASES])
def test_feature_expansion_matches_kernel(name, kernel, theta, ndim):
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(-2.0, 2.0, size=(7, ndim)))
    k_true = kernel.matrix(jnp.asarray(theta, jnp.float64), pts, pts)
    k_hat = _khat(kernel, theta, pts, ndim=ndim)
    assert np.max(np.abs(np.asarray(k_hat - k_true))) < 0.07


def test_periodic_discrete_spectrum_is_exactly_periodic():
    # harmonic frequencies are multiples of 2 pi / p: a sampled expansion
    # is exactly p-periodic, not just approximately
    theta = jnp.asarray([1.4, 2.0], jnp.float64)
    feat = pathwise.sample_features(periodic, theta, KEY, 512, 1)
    z = jnp.asarray([[0.3], [0.7]])
    phi1 = pathwise.eval_features(feat, z)
    phi2 = pathwise.eval_features(feat, z + 2.0)
    np.testing.assert_allclose(np.asarray(phi1), np.asarray(phi2), atol=1e-9)


def test_prior_path_moments():
    kernel = normal.scaled()
    theta = jnp.asarray([1.5, 0.9], jnp.float64)
    pts = jnp.asarray(np.linspace(-1.5, 1.5, 6)[:, None])
    feat, w = pathwise.prior_paths(kernel, theta, KEY, 8192, 8192, 1)
    fs = pathwise.eval_prior_paths(feat, w, pts)  # (S, m)
    k_true = np.asarray(kernel.matrix(theta, pts, pts))
    mean = np.mean(np.asarray(fs), axis=0)
    cov = np.cov(np.asarray(fs).T)
    assert np.max(np.abs(mean)) < 0.08
    assert np.max(np.abs(cov - k_true)) < 0.12


def _toy_posterior(n=24, noise=0.15):
    gp = GP(ndim=1, simil=normal.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(n, 1)), axis=0)
    y = np.sin(1.3 * x[:, 0]) + noise * rng.normal(size=n)
    post = absorb(gp, jnp.asarray([1.1, 0.8]), jnp.asarray([noise]), x, y)
    return gp, post, x, y


def test_posterior_path_mean_matches_predict():
    # Matheron mean is exact in expectation at ANY feature count — only MC
    # error over the S paths remains.  F small on purpose.
    gp, post, _, _ = _toy_posterior()
    z = jnp.asarray(np.linspace(-3.5, 3.5, 9)[:, None])
    ps = pathwise.sample_paths(gp, post, jax.random.PRNGKey(1), 8192, num_features=256)
    fs = np.asarray(pathwise.eval_paths(gp, ps, z))
    mu, _ = predict_from_posterior(gp, post, z)
    assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu))) < 0.06


def test_posterior_path_covariance_matches_joint():
    gp, post, _, _ = _toy_posterior()
    z = jnp.asarray(np.linspace(-3.0, 3.0, 8)[:, None])
    ps = pathwise.sample_paths(gp, post, jax.random.PRNGKey(2), 8192, num_features=8192)
    fs = np.asarray(pathwise.eval_paths(gp, ps, z))
    sp = compile_posterior(gp, post)
    _, cov = serve_predict_cov(gp, sp, z)
    err = np.abs(np.cov(fs.T) - np.asarray(cov))
    assert err.max() < 0.08


def test_paths_are_coherent_functions():
    # the same PathState evaluated twice (and through jit) gives the SAME
    # function values — a trajectory, not a per-call draw
    gp, post, _, _ = _toy_posterior()
    ps = pathwise.sample_paths(gp, post, jax.random.PRNGKey(3), 4, num_features=128)
    z1 = jnp.asarray([[0.1], [1.2], [2.5]])
    a = pathwise.eval_paths(gp, ps, z1)
    b = jax.jit(lambda p, z: pathwise.eval_paths(gp, p, z))(ps, z1)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)
    # overlapping grids agree pointwise
    c = pathwise.eval_paths(gp, ps, jnp.asarray([[1.2]]))
    np.testing.assert_allclose(np.asarray(a[:, 1]), np.asarray(c[:, 0]), rtol=1e-12)


def test_padding_invariance():
    gp, post, x, y = _toy_posterior(n=16)
    z = jnp.asarray([[0.5], [-1.0]])
    ps = pathwise.sample_paths(gp, post, jax.random.PRNGKey(5), 64, num_features=512)
    fs = pathwise.eval_paths(gp, ps, z)
    # same data padded to 24 rows: identical paths (same key -> the padded
    # rows carry zero residual and masked kstar)
    xp = np.concatenate([x, np.zeros((8, 1))])
    yp = np.concatenate([y, np.zeros(8)])
    mask = np.concatenate([np.ones(16), np.zeros(8)])
    post_p = absorb(gp, post.theta_simil, post.theta_noise, xp, yp, mask)
    ps_p = pathwise.sample_paths(gp, post_p, jax.random.PRNGKey(5), 64, num_features=512)
    fs_p = pathwise.eval_paths(gp, ps_p, z)
    # different eps draws for padded shape -> compare moments, not bits
    np.testing.assert_allclose(
        np.asarray(fs).mean(axis=0), np.asarray(fs_p).mean(axis=0), atol=0.35
    )
    # exactness of the masked update: padded-state paths at padded rows add
    # nothing — v is zero there
    assert np.max(np.abs(np.asarray(ps_p.v)[16:, :])) < 1e-9


def test_unsupported_kernel_raises():
    warped = normal.warp_inputs(lambda x: x * 2.0)
    with pytest.raises(ValueError, match="spectral structure"):
        pathwise.sample_features(warped, jnp.asarray([1.0]), KEY, 64, 1)


class TestMultiOutputPathwise:
    """ICM/LMC random features: khat((x,t),(x',t')) -> B[t,t'] k_base."""

    def _theta_icm(self, w, kappa, base_theta):
        # protocol layout: [base | exp(W) slots | kappa]
        return jnp.asarray(
            list(base_theta) + [np.exp(v) for v in w] + list(kappa),
            jnp.float64,
        )

    def test_icm_feature_covariance_matches_kernel(self):
        from gogp.kernels import icm

        k = icm(normal, n_tasks=2, rank=1)
        theta = self._theta_icm([0.9, -0.6], [0.3, 0.5], [1.1])
        rng = np.random.default_rng(5)
        pts = np.concatenate(
            [rng.uniform(-2, 2, size=(8, 1)), rng.integers(0, 2, size=(8, 1))],
            axis=1,
        )
        pts = jnp.asarray(pts)
        k_true = k.matrix(theta, pts, pts)
        k_hat = _khat(k, theta, pts, f=16384, ndim=2)
        assert np.max(np.abs(np.asarray(k_hat - k_true))) < 0.08

    def test_lmc_feature_covariance_matches_kernel(self):
        from gogp.kernels import lmc

        k = lmc([normal, matern32], n_tasks=2, rank=1)
        th1 = self._theta_icm([0.8, 0.4], [0.2, 0.3], [1.0])
        th2 = self._theta_icm([-0.5, 0.7], [0.4, 0.1], [0.7])
        theta = jnp.concatenate([th1, th2])
        rng = np.random.default_rng(6)
        pts = jnp.asarray(
            np.concatenate(
                [rng.uniform(-2, 2, size=(7, 1)), rng.integers(0, 2, size=(7, 1))],
                axis=1,
            )
        )
        k_true = k.matrix(theta, pts, pts)
        k_hat = _khat(k, theta, pts, f=32768, ndim=2)
        assert np.max(np.abs(np.asarray(k_hat - k_true))) < 0.1

    def test_multitask_matheron_mean_exact(self):
        """Posterior path mean over BOTH tasks matches the exact predict
        at any feature count — multi-task Thompson rides unchanged."""
        from gogp.kernels import icm, stack_tasks, task_inputs

        k = icm(normal, n_tasks=2, rank=1)
        gp = GP(ndim=2, simil=k, noise=uniform_noise)
        rng = np.random.default_rng(2)
        x1 = np.sort(rng.uniform(-3, 3, size=(12, 1)), axis=0)
        x2 = np.sort(rng.uniform(-3, 3, size=(10, 1)), axis=0)
        X, Y = stack_tasks(
            [x1, x2], [np.sin(x1[:, 0]), 0.5 * np.sin(x2[:, 0]) + 0.1]
        )
        theta = self._theta_icm([0.9, 0.5], [0.3, 0.4], [1.0])
        post = absorb(gp, theta, jnp.asarray([0.2]), X, Y)
        z = task_inputs(jnp.asarray(np.linspace(-3, 3, 6)[:, None]), 1)
        z = jnp.concatenate(
            [task_inputs(jnp.asarray(np.linspace(-3, 3, 6)[:, None]), 0), z]
        )
        ps = pathwise.sample_paths(
            gp, post, jax.random.PRNGKey(8), 8192, num_features=256
        )
        fs = np.asarray(pathwise.eval_paths(gp, ps, z))
        mu, _ = predict_from_posterior(gp, post, z)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu))) < 0.08

    def test_icm_under_product_raises(self):
        from gogp.kernels import icm

        k = icm(normal, n_tasks=2, rank=1) * matern32
        theta = jnp.ones(k.n_theta)
        with pytest.raises(ValueError, match="icm"):
            pathwise.sample_features(k, theta, KEY, 64, 2)


def test_matern52_ref_decomposition_identity():
    """The spectral-measure derivation rests on the exact pointwise identity
    matern52_ref(l) = 0.4 matern32(l sqrt(3/5)) + 0.6 matern52(l)
    (kernels/stationary.py) — pin it directly at f64."""
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(-3.0, 3.0, size=(9, 1)))
    l = 1.3
    k_ref = matern52_ref.matrix(jnp.asarray([l], jnp.float64), pts, pts)
    k_mix = 0.4 * matern32.matrix(
        jnp.asarray([l * np.sqrt(3.0 / 5.0)], jnp.float64), pts, pts
    ) + 0.6 * matern52.matrix(jnp.asarray([l], jnp.float64), pts, pts)
    np.testing.assert_allclose(np.asarray(k_ref), np.asarray(k_mix), atol=1e-14)


def test_matern52_ref_tutorial_composite_thompson_path():
    """The four reference-parity tutorials' composite kernels can now ride
    the pathwise Thompson engine: scaled matern52_ref + periodic posterior
    paths have the exact Matheron mean."""
    gp = GP(ndim=1, simil=matern52_ref.scaled() + periodic, noise=uniform_noise)
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(-3.0, 3.0, size=(20, 1)), axis=0)
    y = np.sin(1.1 * x[:, 0]) + 0.1 * rng.normal(size=20)
    post = absorb(gp, jnp.asarray([1.0, 0.9, 1.2, 2.0]), jnp.asarray([0.15]), x, y)
    z = jnp.asarray(np.linspace(-3.5, 3.5, 9)[:, None])
    ps = pathwise.sample_paths(gp, post, jax.random.PRNGKey(4), 8192, num_features=512)
    fs = np.asarray(pathwise.eval_paths(gp, ps, z))
    mu, _ = predict_from_posterior(gp, post, z)
    assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu))) < 0.06


class TestSparsePathwise:
    def _fit(self):
        from gogp.gp import sparse
        gp = GP(ndim=1, simil=normal.scaled(), noise=uniform_noise)
        rng = np.random.default_rng(2)
        x = np.sort(rng.uniform(-3, 3, (120, 1)), axis=0)
        y = np.sin(1.2 * x[:, 0]) + 0.1 * rng.normal(size=120)
        z = np.linspace(-3, 3, 16)[:, None]
        ts, tn = jnp.asarray([1.0, 0.9]), jnp.asarray([0.1])
        state = sparse.svgp_optimal_state(gp, ts, tn, x, y, z)
        return gp, ts, state, x, y

    def test_moments_match_svgp_predict(self):
        from gogp.gp import sparse
        gp, ts, state, _, _ = self._fit()
        t = jnp.asarray(np.linspace(-3.5, 3.5, 9)[:, None])
        ps = pathwise.sample_paths_svgp(gp, ts, state, jax.random.PRNGKey(0),
                                        8192, num_features=8192)
        fs = np.asarray(pathwise.eval_paths_sparse(gp, ps, t))
        mu, sd = sparse.svgp_predict(gp, ts, state, t)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu))) < 0.06
        assert np.max(np.abs(fs.std(axis=0) - np.asarray(sd))) < 0.06

    def test_sgpr_paths_track_exact_posterior(self):
        # the optimal whitened q reproduces the SGPR (collapsed) posterior;
        # with many inducing points that is close to the exact GP
        gp, ts, state, x, y = self._fit()
        ps = pathwise.sample_paths_svgp(gp, ts, state, jax.random.PRNGKey(1),
                                        4096, num_features=4096)
        t = jnp.asarray(np.linspace(-2.5, 2.5, 7)[:, None])
        fs = np.asarray(pathwise.eval_paths_sparse(gp, ps, t))
        post = absorb(gp, ts, jnp.asarray([0.1]), x, y)
        mu_ex, _ = predict_from_posterior(gp, post, t)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu_ex))) < 0.08

    def test_coherent_functions(self):
        gp, ts, state, _, _ = self._fit()
        ps = pathwise.sample_paths_svgp(gp, ts, state, jax.random.PRNGKey(2),
                                        4, num_features=256)
        a = pathwise.eval_paths_sparse(gp, ps, jnp.asarray([[0.3], [1.1]]))
        b = pathwise.eval_paths_sparse(gp, ps, jnp.asarray([[1.1]]))
        np.testing.assert_allclose(np.asarray(a[:, 1]), np.asarray(b[:, 0]), rtol=1e-12)


class TestLaplacePathwise:
    def test_gaussian_likelihood_reduces_to_exact(self):
        # with a Gaussian likelihood the Laplace posterior IS the exact GP
        # posterior: path moments must match the exact latent predictive
        from gogp.gp import laplace
        from gogp.gp.likelihoods import gaussian

        gp = GP(ndim=1, simil=normal.scaled())
        rng = np.random.default_rng(4)
        x = np.sort(rng.uniform(-3, 3, (20, 1)), axis=0)
        sigma = 0.3
        y = np.sin(1.3 * x[:, 0]) + sigma * rng.normal(size=20)
        ts = jnp.asarray([1.0, 0.9])
        post = laplace.laplace_fit(gp, gaussian, ts, jnp.asarray([sigma]), x, y)
        ps = pathwise.sample_paths_laplace(gp, post, jax.random.PRNGKey(0),
                                           8192, num_features=4096)
        z = jnp.asarray(np.linspace(-3, 3, 7)[:, None])
        fs = np.asarray(pathwise.eval_paths(gp, ps, z))
        gpn = GP(ndim=1, simil=normal.scaled(), noise=uniform_noise)
        mu_ex, sd_ex = __import__("gogp.gp.core", fromlist=["predict"]).predict(
            gpn, ts, jnp.asarray([sigma]), x, y, z)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu_ex))) < 0.06
        assert np.max(np.abs(fs.std(axis=0) - np.asarray(sd_ex))) < 0.06

    def test_classification_path_moments(self):
        from gogp.gp import laplace
        from gogp.gp.likelihoods import bernoulli_logit

        gp = GP(ndim=1, simil=normal.scaled())
        rng = np.random.default_rng(5)
        x = np.sort(rng.uniform(-3, 3, (24, 1)), axis=0)
        y = (rng.uniform(size=24) < 1 / (1 + np.exp(-2 * np.sin(1.4 * x[:, 0])))).astype(float)
        ts = jnp.asarray([1.2, 1.0])
        post = laplace.laplace_fit(gp, bernoulli_logit, ts, jnp.zeros(0), x, y)
        ps = pathwise.sample_paths_laplace(gp, post, jax.random.PRNGKey(1),
                                           8192, num_features=4096)
        z = jnp.asarray(np.linspace(-3, 3, 7)[:, None])
        fs = np.asarray(pathwise.eval_paths(gp, ps, z))
        mu, sd = laplace.laplace_predict(gp, post, z)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu))) < 0.07
        assert np.max(np.abs(fs.std(axis=0) - np.asarray(sd))) < 0.07

    def test_padded_rows_drop_out(self):
        from gogp.gp import laplace
        from gogp.gp.likelihoods import bernoulli_logit

        gp = GP(ndim=1, simil=normal.scaled())
        rng = np.random.default_rng(6)
        x = np.sort(rng.uniform(-2, 2, (10, 1)), axis=0)
        y = (np.sin(x[:, 0]) > 0).astype(float)
        xp = np.concatenate([x, np.zeros((4, 1))])
        yp = np.concatenate([y, np.zeros(4)])
        m = np.concatenate([np.ones(10), np.zeros(4)])
        post = laplace.laplace_fit(gp, bernoulli_logit, jnp.asarray([1.0, 1.0]),
                                   jnp.zeros(0), xp, yp, mask=m)
        ps = pathwise.sample_paths_laplace(gp, post, jax.random.PRNGKey(2), 32,
                                           num_features=256)
        v = np.asarray(ps.v)
        assert np.isfinite(v).all()
        assert np.max(np.abs(v[10:, :])) < 1e-12


class TestSKIPathwise:
    def test_moments_match_dense_pathwise(self):
        # SKI-conditioned paths vs the exact-factor paths on the same
        # problem: same posterior, so moments agree within MC error
        from gogp.gp.pathwise import sample_paths_ski

        gp, post, x, y = _toy_posterior(n=64, noise=0.2)
        z = jnp.asarray(np.linspace(-3, 3, 7)[:, None])
        ps = sample_paths_ski(
            gp, post.theta_simil, post.theta_noise, x, y,
            jax.random.PRNGKey(0), 4096, num_features=4096, grid_size=512,
        )
        fs = np.asarray(pathwise.eval_paths(gp, ps, z))
        mu_ex, sd_ex = predict_from_posterior(gp, post, z)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu_ex))) < 0.07
        assert np.max(np.abs(fs.std(axis=0) - np.asarray(sd_ex))) < 0.07

    def test_2d(self):
        from gogp.gp.pathwise import sample_paths_ski
        from gogp.gp.core import predict

        gp = GP(ndim=2, simil=normal.scaled(), noise=uniform_noise)
        rng = np.random.default_rng(3)
        x = rng.uniform(0, 4, (200, 2))
        y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=200)
        ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.1])
        ps = sample_paths_ski(gp, ts, tn, x, y, jax.random.PRNGKey(1),
                              2048, num_features=4096, grid_size=(48, 48))
        z = jnp.asarray(rng.uniform(0.5, 3.5, (5, 2)))
        fs = np.asarray(pathwise.eval_paths(gp, ps, z))
        mu_ex, _ = predict(gp, ts, tn, x, y, z)
        assert np.max(np.abs(fs.mean(axis=0) - np.asarray(mu_ex))) < 0.08
