"""Deep kernel learning (MLP feature warp)."""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core
from gogp.kernels import deep as dk, normal as rbf, uniform_noise
from gogp.models.params import gp_observe


class TestStructure:
    def test_identity_warp_reproduces_base(self):
        # hidden=() -> single linear layer; identity weights = base kernel.
        k = dk.deep(rbf.scaled(), ndim=2, hidden=())
        w_raw = dk.identity_weights(2, hidden=())
        theta = jnp.concatenate([jnp.exp(jnp.asarray(w_raw)), jnp.asarray([1.3, 0.8])])
        rng = np.random.default_rng(0)
        xa, xb = jnp.asarray(rng.normal(size=(2, 2)))
        got = float(k(theta, xa, xb))
        want = float(rbf.scaled()(jnp.asarray([1.3, 0.8]), xa, xb))
        assert abs(got - want) < 1e-12

    def test_n_theta_accounting(self):
        k = dk.deep(rbf.scaled(), ndim=1, hidden=(4, 4), out_dim=2)
        assert k.n_theta == dk.n_weights(1, (4, 4), 2) + 2
        assert dk.n_weights(1, (4, 4), 2) == (1 * 4 + 4) + (4 * 4 + 4) + (4 * 2 + 2)

    def test_warp_features_matches_pair_path(self):
        rng = np.random.default_rng(1)
        base = rbf.scaled()
        k = dk.deep(base, ndim=1, hidden=(4,), out_dim=2)
        v = dk.init_deep_v(rng, [0.2, -0.1], 1, hidden=(4,), out_dim=2)
        theta = jnp.exp(v)
        x = jnp.asarray(rng.normal(size=(6, 1)))
        K_pair = k.matrix(theta, x, x)
        feats = dk.warp_features(v, x, 1, hidden=(4,), out_dim=2)
        K_feat = base.matrix(theta[-2:], feats, feats)
        np.testing.assert_allclose(np.asarray(K_pair), np.asarray(K_feat), atol=1e-12)


class TestLearning:
    def test_fd_gradient_through_gp(self):
        rng = np.random.default_rng(2)
        k = dk.deep(rbf.scaled(), ndim=1, hidden=(3,))
        gp = core.GP(ndim=1, simil=k, noise=uniform_noise)
        x = jnp.asarray(rng.uniform(0, 3, size=(10, 1)))
        y = jnp.asarray(np.sin(np.asarray(x)[:, 0]))
        v0 = dk.init_deep_v(rng, [0.1, 0.1], 1, hidden=(3,))
        v0 = jnp.concatenate([v0, jnp.asarray([-1.0])])  # noise theta
        val, grad = jax.value_and_grad(lambda v: gp_observe(gp, v, x=x, y=y))(v0)
        eps = 1e-6
        for i in range(v0.shape[0]):
            fd = (float(gp_observe(gp, v0.at[i].add(eps), x=x, y=y)) - float(val)) / eps
            assert abs(fd - float(grad[i])) < 2e-3, f"component {i}"

    def test_deep_kernel_fits_nonstationary_step(self):
        # A step function defeats a stationary RBF at any single lengthscale;
        # the MLP warp can stretch the axis around the step.
        from gogp.infer import mle
        from gogp.models.params import make_gp_logp

        rng = np.random.default_rng(3)
        n = 48
        x = np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0)
        y = np.tanh(12 * x[:, 0]) + 0.05 * rng.normal(size=n)
        x, y = jnp.asarray(x), jnp.asarray(y)

        gp_flat = core.GP(1, rbf.scaled(), noise=uniform_noise)
        logp_flat = make_gp_logp(gp_flat, x, y)
        res_flat = mle.adam(
            jax.value_and_grad(logp_flat), jnp.zeros(3), iters=400, rate=0.05
        )

        k = dk.deep(rbf.scaled(), ndim=1, hidden=(6,))
        gp_deep = core.GP(1, simil=k, noise=uniform_noise)
        logp_deep = make_gp_logp(gp_deep, x, y)
        v0 = jnp.concatenate(
            [dk.init_deep_v(rng, [0.0, 0.0], 1, hidden=(6,), scale=0.8),
             jnp.asarray([0.0])]
        )
        res_deep = mle.adam(
            jax.value_and_grad(logp_deep), v0, iters=400, rate=0.05
        )
        assert float(res_deep.value) > float(res_flat.value) + 5.0
