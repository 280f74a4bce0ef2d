"""Posterior-predictive mixture over hyperparameter draws."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp.gp import GP, predict, predict_mixture
from gogp.kernels import rbf, uniform_noise


def setup():
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 6, (20, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.05 * rng.normal(size=20)
    return gp, jnp.asarray(x), jnp.asarray(y)


def test_degenerate_mixture_equals_plugin():
    """S identical draws == plug-in prediction at that theta."""
    gp, x, y = setup()
    v = jnp.array([0.1, -0.3, -2.0])
    z = jnp.linspace(0, 7, 9)[:, None]
    mu1, s1 = predict(gp, jnp.exp(v)[:2], jnp.exp(v)[2:], x, y, z)
    vs = jnp.broadcast_to(v, (5, 3))
    mu2, s2 = predict_mixture(gp, vs, x, y, z)
    assert np.allclose(np.asarray(mu1), np.asarray(mu2), atol=1e-10)
    assert np.allclose(np.asarray(s1), np.asarray(s2), atol=1e-8)


def test_mixture_widens_bands():
    """Hyperparameter uncertainty can only add predictive variance at points
    where the component means disagree."""
    gp, x, y = setup()
    z = jnp.array([[7.5]])  # extrapolation: thetas disagree most
    vs = jnp.asarray(
        [[0.0, -0.5, -2.0], [0.4, 0.3, -1.5], [-0.3, 0.1, -2.5]]
    )
    mu_mix, s_mix = predict_mixture(gp, vs, x, y, z)
    # mixture variance >= mean of component variances
    comp = [
        predict(gp, jnp.exp(v)[:2], jnp.exp(v)[2:], x, y, z) for v in vs
    ]
    mean_var = np.mean([float(s[0]) ** 2 for _, s in comp])
    assert float(s_mix[0]) ** 2 >= mean_var - 1e-12
    assert np.isfinite(float(mu_mix[0]))


def test_jit_and_shapes():
    gp, x, y = setup()
    vs = 0.1 * jax.random.normal(jax.random.PRNGKey(0), (32, 3))
    z = jnp.linspace(0, 6, 11)[:, None]
    f = jax.jit(lambda vs: predict_mixture(gp, vs, x, y, z))
    mu, s = f(vs)
    assert mu.shape == (11,) and s.shape == (11,)
    assert bool(jnp.all(jnp.isfinite(mu))) and bool(jnp.all(s >= 0))
