"""Checkpoint round-trip (the reference's Produce-from-stored-fields contract,
gp/gp.go:255-257, made durable) and profiling helpers."""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import utils
from gogp.gp.core import GP, absorb, predict_from_posterior
from gogp.kernels import rbf, uniform_noise


def test_posterior_checkpoint_roundtrip(tmp_path):
    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    x = jnp.linspace(0, 5, 12).reshape(-1, 1)
    y = jnp.sin(x[:, 0])
    post = absorb(gp, jnp.ones(2), jnp.full(1, 0.1), x, y)
    mu0, s0 = predict_from_posterior(gp, post, jnp.array([[5.5]]))

    path = tmp_path / "post_ckpt"
    utils.save(path, post)
    restored = utils.restore(path, like=post)
    assert type(restored).__name__ == "Posterior"

    mu1, s1 = predict_from_posterior(gp, restored, jnp.array([[5.5]]))
    assert np.allclose(np.asarray(mu0), np.asarray(mu1))
    assert np.allclose(np.asarray(s0), np.asarray(s1))


def test_sampler_state_checkpoint_roundtrip(tmp_path):
    from gogp import infer

    def logp(v):
        return -0.5 * jnp.sum(v * v)

    state = infer.init_state(logp, jnp.zeros(3), jax.random.PRNGKey(0))
    path = tmp_path / "hmc_ckpt"
    utils.save(path, state)
    back = utils.restore(path, like=state)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        assert np.allclose(np.asarray(a), np.asarray(b))
    # restored state resumes sampling
    out = infer.hmc_transition(logp, back)
    assert np.isfinite(float(out.logp))


def test_phase_timer():
    t = utils.PhaseTimer()
    x = jnp.ones((64, 64))
    with t.phase("matmul", sync=None):
        y = x @ x
        jax.block_until_ready(y)
    assert t.totals["matmul"] > 0
    assert "matmul" in t.report()


def test_timed():
    f = jax.jit(lambda x: x @ x)
    ms = utils.timed(f, jnp.ones((128, 128)), reps=3, warmup=1)
    assert ms > 0


def test_pt_checkpoint_resume(tmp_path):
    """Elasticity: a PT run checkpointed mid-stream resumes exactly —
    the sampler-state pytree round-trips through orbax and pt_sample_chunk
    continues from it."""
    from gogp.infer.tempering import geometric_ladder, pt_init, pt_sample_chunk

    def logp(v):
        return -0.5 * jnp.sum(v * v)

    betas = jnp.asarray(geometric_ladder(3, 0.2, jnp.float64))
    states, key = pt_init(logp, jnp.zeros(2), jax.random.PRNGKey(0), betas)

    # run one chunk, checkpoint, run second chunk two ways
    states1, key1, _, _, _, _ = pt_sample_chunk(logp, states, key, betas, 10, jnp.asarray(0))
    path = tmp_path / "pt_ckpt"
    utils.save(path, (states1, key1))
    restored_states, restored_key = utils.restore(path, like=(states1, key1))

    _, _, pos_direct, _, _, _ = pt_sample_chunk(
        logp, states1, key1, betas, 10, jnp.asarray(10)
    )
    _, _, pos_resumed, _, _, _ = pt_sample_chunk(
        logp, restored_states, restored_key, betas, 10, jnp.asarray(10)
    )
    assert np.allclose(np.asarray(pos_direct), np.asarray(pos_resumed))


def test_chees_checkpoint_resume(tmp_path):
    """ChEESState (incl. its Adam/dual-averaging/Welford sub-states and the
    rng) round-trips through orbax and chees_sample_chunk continues exactly
    — the elasticity contract for the flagship sampler."""
    from gogp.infer.chees import chees_init, chees_sample_chunk

    def logp(v):
        return -0.5 * jnp.sum(v * v)

    state = chees_init(logp, jnp.zeros((4, 2)), jax.random.PRNGKey(1), 0.3, 1.0)
    state1, _ = chees_sample_chunk(logp, state, 10)

    path = tmp_path / "chees_ckpt"
    utils.save(path, state1)
    restored = utils.restore(path, like=state1)

    _, (pos_direct, _, _) = chees_sample_chunk(logp, state1, 10)
    _, (pos_resumed, _, _) = chees_sample_chunk(logp, restored, 10)
    assert np.allclose(np.asarray(pos_direct), np.asarray(pos_resumed))


def test_laplace_and_ep_posterior_checkpoint_roundtrip(tmp_path):
    """The non-conjugate posteriors are plain pytrees too — serving caches
    survive a save/restore cycle (round-3 classification surface)."""
    from gogp.gp import ep, laplace, likelihoods

    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(-3, 3, size=(14, 1)), axis=0))
    y = jnp.asarray((np.asarray(x)[:, 0] > 0).astype(float))
    gp = GP(ndim=1, simil=rbf.scaled())
    lik = likelihoods.bernoulli_probit
    ts = jnp.asarray([2.0, 1.0])

    lpost = laplace.laplace_fit(gp, lik, ts, jnp.zeros(0), x, y)
    utils.save(tmp_path / "lap", lpost)
    lrest = utils.restore(tmp_path / "lap", like=lpost)
    z = jnp.asarray([[0.4], [-1.2]])
    p0 = laplace.laplace_predict_prob(gp, lik, lpost, z)
    p1 = laplace.laplace_predict_prob(gp, lik, lrest, z)
    assert np.allclose(np.asarray(p0), np.asarray(p1))

    epost = ep.ep_fit(gp, lik, ts, jnp.zeros(0), x, y)
    utils.save(tmp_path / "ep", epost)
    erest = utils.restore(tmp_path / "ep", like=epost)
    q0 = ep.ep_predict_prob(gp, lik, epost, z)
    q1 = ep.ep_predict_prob(gp, lik, erest, z)
    assert np.allclose(np.asarray(q0), np.asarray(q1))
