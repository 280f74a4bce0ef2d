"""Natural-gradient SVGP training."""

import numpy as np
import jax
import jax.numpy as jnp

from gogp.gp import core, sparse
from gogp.kernels import normal as rbf, uniform_noise


def _data(seed=0, n=96):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 6, size=(n, 1)), axis=0)
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)
    return jnp.asarray(x), jnp.asarray(y)


def test_gaussian_one_step_is_optimal():
    # gamma = 1, full batch, Gaussian likelihood: ONE natural-gradient step
    # from the KL-zero init must land on the optimal q (svgp_optimal_state).
    x, y = _data(1)
    gp = core.GP(1, rbf.scaled(), noise=uniform_noise)
    ts, tn = jnp.asarray([1.0, 1.0]), jnp.asarray([0.1])
    z = x[::8]
    state0 = sparse.svgp_init(gp, z, dtype=x.dtype)
    stepped = sparse.svgp_natgrad_step(gp, ts, tn, state0, x, y, gamma=1.0)
    opt = sparse.svgp_optimal_state(gp, ts, tn, x, y, z)
    e_step = float(sparse.svgp_elbo(gp, ts, tn, stepped, x, y))
    e_opt = float(sparse.svgp_elbo(gp, ts, tn, opt, x, y))
    np.testing.assert_allclose(e_step, e_opt, atol=1e-6)
    # and a second step stays put (fixed point)
    stepped2 = sparse.svgp_natgrad_step(gp, ts, tn, stepped, x, y, gamma=1.0)
    e2 = float(sparse.svgp_elbo(gp, ts, tn, stepped2, x, y))
    np.testing.assert_allclose(e2, e_opt, atol=1e-6)


def test_natgrad_beats_adam_on_variational_params():
    # Bernoulli likelihood, theta fixed: K natgrad steps reach a higher
    # ELBO than K Adam steps on (q_mu, q_sqrt) from the same init.
    import optax

    rng = np.random.default_rng(2)
    n = 64
    x = jnp.asarray(np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0))
    y = jnp.asarray((rng.uniform(size=n) < 1 / (1 + np.exp(-3 * np.asarray(x)[:, 0]))).astype(np.float64))
    gp = core.GP(1, rbf.scaled())
    ts, tn = jnp.asarray([2.0, 1.0]), jnp.zeros(0)
    lik = lambda yy, ff: yy * ff - jnp.logaddexp(0.0, ff)
    z = x[::4]
    state = sparse.svgp_init(gp, z, dtype=x.dtype)

    K = 25
    s_ng = state
    for _ in range(K):
        s_ng = sparse.svgp_natgrad_step(gp, ts, tn, s_ng, x, y, gamma=0.5, likelihood=lik)
    e_ng = float(sparse.svgp_elbo(gp, ts, tn, s_ng, x, y, likelihood=lik))

    opt = optax.adam(0.05)
    params = (state.q_mu, state.q_sqrt)
    opt_state = opt.init(params)
    def neg_elbo(p):
        return -sparse.svgp_elbo(
            gp, ts, tn, sparse.SVGPState(z, p[0], p[1]), x, y, likelihood=lik
        )
    for _ in range(K):
        g = jax.grad(neg_elbo)(params)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    e_adam = -float(neg_elbo(params))
    assert e_ng > e_adam + 1.0, (e_ng, e_adam)


def test_fit_natgrad_end_to_end():
    x, y = _data(3, n=128)
    gp = core.GP(1, rbf.scaled(), noise=uniform_noise)
    params, trace = sparse.svgp_fit_natgrad(
        gp, x, y, m=16, key=jax.random.PRNGKey(0), iters=120, gamma=0.8, rate=0.05
    )
    assert float(trace[-1]) > float(trace[0])
    theta = jnp.exp(params.log_theta)
    mu, _ = sparse.svgp_predict(gp, theta[: gp.n_theta_simil], params.state, x[:40])
    rmse = float(jnp.sqrt(jnp.mean((mu - jnp.sin(x[:40, 0])) ** 2)))
    assert rmse < 0.12

    # natgrad reaches a near-optimal ELBO much faster than plain adam
    params_a, trace_a = sparse.svgp_fit(
        gp, x, y, m=16, key=jax.random.PRNGKey(0), iters=120, rate=0.05
    )
    assert float(trace[-1]) > float(trace_a[-1]) - 1e-6
