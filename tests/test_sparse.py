"""Sparse GP (SGPR/SVGP) correctness.

Pinned contracts:
- SGPR collapsed bound == exact LML when Z = X (Titsias 2009 exactness);
  < LML for m < n (it is a lower bound).
- SGPR predictive == exact predict at Z = X (same noise-free-band
  semantics as reference gp/gp.go:270-278).
- SVGP at the closed-form optimal whitened q == SGPR bound; Gauss-Hermite
  path == analytic Gaussian path; minibatch rescaling is exactly unbiased.
- Data-sharded ELBO over the 8-device mesh equals the single-device value.
- FD gradient check through the flat-vector adapter (thetas AND Z).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from gogp.gp import core as gpcore
from gogp.gp import sparse
from gogp.kernels import rbf, uniform_noise
from gogp.parallel import mesh as meshmod


def _problem(n=24, seed=0, noise_log=-1.0):
    gp = gpcore.GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(np.sort(rng.uniform(0, 10, (n, 1)), axis=0))
    y = jnp.asarray(np.sin(np.asarray(x[:, 0])) + 0.1 * rng.normal(size=n))
    ts = jnp.exp(jnp.asarray([0.3, -0.2]))
    tn = jnp.exp(jnp.asarray([noise_log]))
    return gp, x, y, ts, tn


def test_sgpr_equals_exact_at_z_eq_x():
    gp, x, y, ts, tn = _problem()
    exact = gpcore.lml(gp, ts, tn, x, y)
    elbo = sparse.sgpr_elbo(gp, ts, tn, x, y, x, jitter=1e-12)
    assert np.isclose(float(elbo), float(exact), rtol=1e-8)


def test_sgpr_is_a_lower_bound():
    gp, x, y, ts, tn = _problem(n=40)
    z = x[::4]
    exact = float(gpcore.lml(gp, ts, tn, x, y))
    elbo = float(sparse.sgpr_elbo(gp, ts, tn, x, y, z))
    assert elbo < exact
    # and tightens as m grows
    elbo2 = float(sparse.sgpr_elbo(gp, ts, tn, x, y, x[::2]))
    assert elbo < elbo2 <= exact + 1e-9


def test_sgpr_predict_matches_exact_at_z_eq_x():
    gp, x, y, ts, tn = _problem()
    t = jnp.linspace(-1.0, 11.0, 17)[:, None]
    mu_e, sd_e = gpcore.predict(gp, ts, tn, x, y, t)
    post = sparse.sgpr_fit(gp, ts, tn, x, y, x, jitter=1e-12)
    mu_s, sd_s = sparse.sgpr_predict(gp, post, t)
    np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_e), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sd_s), np.asarray(sd_e), atol=1e-6)


def test_sgpr_mask_padding_invariance():
    gp, x, y, ts, tn = _problem(n=20)
    z = x[::3]
    ref = sparse.sgpr_elbo(gp, ts, tn, x, y, z)
    xp = jnp.concatenate([x, jnp.full((4, 1), 99.0)])
    yp = jnp.concatenate([y, jnp.full((4,), -7.0)])
    mask = jnp.concatenate([jnp.ones(20), jnp.zeros(4)])
    padded = sparse.sgpr_elbo(gp, ts, tn, xp, yp, z, mask=mask)
    assert np.isclose(float(padded), float(ref), rtol=1e-10)


def test_svgp_optimal_state_recovers_sgpr_bound():
    gp, x, y, ts, tn = _problem(n=30)
    z = x[::3]
    state = sparse.svgp_optimal_state(gp, ts, tn, x, y, z)
    elbo_svgp = sparse.svgp_elbo(gp, ts, tn, state, x, y)
    elbo_sgpr = sparse.sgpr_elbo(gp, ts, tn, x, y, z)
    assert np.isclose(float(elbo_svgp), float(elbo_sgpr), rtol=1e-8)
    # any other q is worse (it's the maximizer)
    other = state._replace(q_mu=state.q_mu + 0.1)
    assert float(sparse.svgp_elbo(gp, ts, tn, other, x, y)) < float(elbo_svgp)


def test_svgp_predict_matches_exact_at_optimum_z_eq_x():
    gp, x, y, ts, tn = _problem()
    t = jnp.linspace(0.0, 10.0, 13)[:, None]
    state = sparse.svgp_optimal_state(gp, ts, tn, x, y, x, jitter=1e-12)
    mu_v, sd_v = sparse.svgp_predict(gp, ts, state, t, jitter=1e-12)
    mu_e, sd_e = gpcore.predict(gp, ts, tn, x, y, t)
    np.testing.assert_allclose(np.asarray(mu_v), np.asarray(mu_e), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sd_v), np.asarray(sd_e), atol=1e-6)


def test_svgp_gauss_hermite_matches_analytic_gaussian():
    gp, x, y, ts, tn = _problem(n=18)
    state = sparse.svgp_init(gp, x[::2])
    state = state._replace(q_mu=jnp.linspace(-1, 1, state.q_mu.shape[0]))
    analytic = sparse.svgp_elbo(gp, ts, tn, state, x, y)
    s = float(tn[0]) ** 2  # uniform_noise: variance = std^2

    def gauss_lik(yi, fi):
        return -0.5 * (jnp.log(2 * jnp.pi * s) + (yi - fi) ** 2 / s)

    quad = sparse.svgp_elbo(
        gp, ts, tn, state, x, y, likelihood=gauss_lik, quad_order=30
    )
    assert np.isclose(float(quad), float(analytic), rtol=1e-9)


def test_svgp_minibatch_rescaling_is_unbiased():
    gp, x, y, ts, tn = _problem(n=32)
    state = sparse.svgp_init(gp, x[::4])
    state = state._replace(q_mu=jnp.ones_like(state.q_mu) * 0.3)
    full = sparse.svgp_elbo(gp, ts, tn, state, x, y)
    b1 = sparse.svgp_elbo(gp, ts, tn, state, x[:16], y[:16], n_total=32)
    b2 = sparse.svgp_elbo(gp, ts, tn, state, x[16:], y[16:], n_total=32)
    # each batch term scales its data sum by 2 and subtracts one KL:
    # b1 + b2 = 2*data - 2*KL = 2*full
    assert np.isclose(float(b1 + b2), 2 * float(full), rtol=1e-10)


def test_svgp_data_sharded_device_invariance():
    gp, x, y, ts, tn = _problem(n=32)
    state = sparse.svgp_init(gp, x[::4])
    state = state._replace(q_mu=jnp.linspace(0, 1, state.q_mu.shape[0]))
    full = float(sparse.svgp_elbo(gp, ts, tn, state, x, y))
    mesh = meshmod.make_mesh(n_chain=1, n_data=8)
    ndev = 8
    kl = float(sparse.kl_whitened(state.q_mu, state.q_sqrt))

    @jax.jit
    def sharded(x, y):
        def local(xl, yl):
            e = sparse.svgp_elbo(gp, ts, tn, state, xl, yl)
            return jax.lax.psum(e, meshmod.DATA_AXIS)[None]

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(meshmod.DATA_AXIS), P(meshmod.DATA_AXIS)),
            out_specs=P(meshmod.DATA_AXIS),
            check_vma=False,
        )(x, y)

    total = float(sharded(x, y)[0])
    # sum of local elbos = global data term - ndev * KL
    assert np.isclose(total + (ndev - 1) * kl, full, rtol=1e-8)


def test_sgpr_flat_vector_gradient_fd():
    gp, x, y, ts, tn = _problem(n=16)
    m = 4
    z0 = x[::4]
    v = sparse.join_sparse_params(gp, jnp.log(jnp.concatenate([ts, tn])), z0)
    logp = sparse.make_sgpr_logp(gp, x, y, m)
    g = jax.grad(logp)(v)
    eps = 1e-6
    for i in range(v.shape[0]):
        e = jnp.zeros_like(v).at[i].set(eps)
        fd = (float(logp(v + e)) - float(logp(v - e))) / (2 * eps)
        assert np.isclose(float(g[i]), fd, rtol=1e-4, atol=1e-6), i


def test_sgpr_training_improves_and_beats_fixed_z():
    # a short Adam run through the house optimizer moves thetas AND Z
    from gogp.infer import mle

    gp, x, y, ts, tn = _problem(n=40, seed=3)
    m = 6
    z0 = x[:: 40 // m][:m]
    v0 = sparse.join_sparse_params(gp, jnp.zeros(gp.n_theta), z0)
    logp = sparse.make_sgpr_logp(gp, x, y, m)
    res = mle.adam(jax.value_and_grad(logp), v0, iters=200, rate=0.05)
    assert float(res.value) > float(logp(v0))


def test_svgp_jit_and_vmap_safe():
    gp, x, y, ts, tn = _problem(n=20)
    state = sparse.svgp_init(gp, x[::4])
    f = jax.jit(lambda qm: sparse.svgp_elbo(gp, ts, tn, state._replace(q_mu=qm), x, y))
    vals = jax.vmap(f)(jnp.stack([state.q_mu, state.q_mu + 0.1]))
    assert vals.shape == (2,)
    assert bool(jnp.all(jnp.isfinite(vals)))


def test_svgp_fit_end_to_end():
    gp, x, y, ts, tn = _problem(n=48, seed=5)
    key = jax.random.PRNGKey(0)
    params, trace = sparse.svgp_fit(
        gp, x, y, m=8, key=key, iters=400, batch=16, rate=0.05
    )
    # trained minibatch ELBO should be far above the init's
    assert float(trace[-50:].mean()) > float(trace[0])
    theta = jnp.exp(params.log_theta)
    mu, sd = sparse.svgp_predict(gp, theta[: gp.n_theta_simil], params.state, x)
    resid = np.asarray(mu) - np.asarray(y)
    assert np.sqrt(np.mean(resid**2)) < 0.5  # data std is ~0.7 (sine +/- noise)
    assert bool(jnp.all(jnp.isfinite(sd)))


def test_svgp_fit_frozen_theta():
    gp, x, y, ts, tn = _problem(n=32, seed=7)
    lt0 = jnp.log(jnp.concatenate([ts, tn]))
    params, _ = sparse.svgp_fit(
        gp, x, y, m=6, key=jax.random.PRNGKey(1), iters=50,
        log_theta0=lt0, train_theta=False,
    )
    np.testing.assert_allclose(np.asarray(params.log_theta), np.asarray(lt0))
