"""ChEES-HMC correctness: moments, adaptation, masks, device invariance.

The reference has no samplers (SURVEY.md §4 — inference is Infergo's);
ChEES-HMC (Hoffman et al. 2021) is part of the north-star inference layer.
Correctness targets mirror tests/test_inference.py: posterior moments of a
known correlated Gaussian within Monte-Carlo error, plus the scheme's own
invariants — shared step size/trajectory adapted from cross-chain statistics,
halton-jittered trajectory lengths, free-mask pinning.
"""

import jax
import jax.numpy as jnp
import numpy as np

from gogp import infer
from gogp.infer import diagnostics
from gogp.infer.chees import _halton2

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
COV_INV = np.linalg.inv(COV)
MEAN = np.array([1.0, -2.0])


def mvn_logp(v):
    d = v - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(COV_INV) @ d


class TestChEES:
    def test_gaussian_moments(self):
        chains = 16
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(10), (chains, 2))
        res = jax.jit(
            lambda key: infer.run_chees(
                mvn_logp, x0, key, num_warmup=400, num_samples=600
            )
        )(jax.random.PRNGKey(0))
        s = np.asarray(res.positions).reshape(-1, 2)  # (600*16, 2)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.1)
        assert np.allclose(np.cov(s.T), COV, atol=0.3)

    def test_rhat_and_ess(self):
        chains = 8
        x0 = jax.random.normal(jax.random.PRNGKey(11), (chains, 2))
        res = infer.run_chees(
            mvn_logp, x0, jax.random.PRNGKey(1), num_warmup=400, num_samples=600
        )
        pos = jnp.moveaxis(res.positions, 1, 0)  # (chains, draws, dim)
        rhat = np.asarray(diagnostics.split_rhat(pos))
        assert np.all(rhat < 1.05), rhat
        e = np.asarray(diagnostics.ess(pos))
        assert np.all(e > 400), e

    def test_trajectory_and_step_adapted(self):
        x0 = jnp.zeros((8, 2))
        res = infer.run_chees(
            mvn_logp,
            x0,
            jax.random.PRNGKey(2),
            num_warmup=400,
            num_samples=50,
            init_traj_length=0.1,
            init_step_size=0.05,
        )
        st = res.state
        # trajectory must have moved off its (deliberately bad) init and the
        # clip band must hold
        assert float(jnp.exp(st.log_traj)) > 0.2
        assert float(st.step_size) > 0.01
        assert float(jnp.exp(st.log_traj)) <= 256 * float(st.step_size) + 1e-6
        # healthy acceptance under the frozen step size
        assert float(jnp.mean(res.accept_probs)) > 0.5

    def test_free_mask_pins_coordinates(self):
        free = jnp.array([1.0, 0.0])
        x0 = jnp.tile(jnp.array([0.0, 5.0]), (4, 1))
        res = infer.run_chees(
            mvn_logp,
            x0,
            jax.random.PRNGKey(3),
            num_warmup=200,
            num_samples=200,
            free=free,
        )
        s = np.asarray(res.positions)
        assert np.all(s[:, :, 1] == 5.0)
        assert s[:, :, 0].std() > 0.1

    def test_halton_low_discrepancy(self):
        vals = np.asarray(
            jax.vmap(lambda i: _halton2(i))(jnp.arange(64, dtype=jnp.int32))
        )
        assert np.all((vals >= 0) & (vals < 1))
        # base-2 radical inverse: first 4 values are 0, 1/2, 1/4, 3/4
        assert np.allclose(vals[:4], [0.0, 0.5, 0.25, 0.75])
        # any 8 consecutive values cover all 8 eighths of [0,1)
        eighths = np.sort(np.floor(vals[8:16] * 8).astype(int))
        assert np.array_equal(eighths, np.arange(8))

    def test_jit_invariance(self):
        x0 = jnp.zeros((4, 2))
        k = jax.random.PRNGKey(4)
        run = lambda key: infer.run_chees(
            mvn_logp, x0, key, num_warmup=60, num_samples=30
        )
        a = run(k)
        b = jax.jit(run)(k)
        np.testing.assert_allclose(
            np.asarray(a.positions), np.asarray(b.positions), rtol=2e-5, atol=2e-5
        )

    def test_chunked_equals_monolithic_sampling(self):
        """Driving sampling via two chees_sample_chunk calls must equal one
        (the chunked benchmark pattern must not change the chain)."""
        from gogp.infer.chees import chees_init, chees_sample_chunk

        x0 = jnp.zeros((4, 2))
        state = chees_init(mvn_logp, x0, jax.random.PRNGKey(5), 0.3, 1.0)
        _, (p_one, _, _) = jax.jit(
            lambda s: chees_sample_chunk(mvn_logp, s, 40)
        )(state)
        s2, (pa, _, _) = jax.jit(lambda s: chees_sample_chunk(mvn_logp, s, 20))(state)
        _, (pb, _, _) = jax.jit(lambda s: chees_sample_chunk(mvn_logp, s, 20))(s2)
        np.testing.assert_allclose(
            np.asarray(p_one),
            np.concatenate([np.asarray(pa), np.asarray(pb)]),
            rtol=1e-6,
            atol=1e-6,
        )

    def test_pops_equal_separate_runs(self):
        """run_chees_pops(n_pops=2) must reproduce two separate run_chees
        calls with fold_in(rng, pop) keys: populations share nothing, and
        the vmapped lockstep leapfrog (while-loop runs to the longest
        population's trajectory, masking the rest) must not change any
        lane's arithmetic."""
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(30), (8, 2))
        key = jax.random.PRNGKey(8)
        kwargs = dict(num_warmup=100, num_samples=60)
        rp = infer.run_chees_pops(mvn_logp, x0, key, n_pops=2, **kwargs)
        parts = [
            infer.run_chees(
                mvn_logp, x0[4 * i : 4 * (i + 1)], jax.random.fold_in(key, i),
                **kwargs,
            )
            for i in range(2)
        ]
        want = np.concatenate(
            [np.asarray(p.positions) for p in parts], axis=1
        )
        np.testing.assert_allclose(
            np.asarray(rp.positions), want, rtol=1e-9, atol=1e-9
        )
        # per-population adaptation really is independent
        steps = np.asarray(rp.state.step_size)
        assert steps.shape == (2,)
        assert steps[0] != steps[1]

    def test_pops_moments(self):
        x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(31), (16, 2))
        res = infer.run_chees_pops(
            mvn_logp, x0, jax.random.PRNGKey(9), n_pops=4,
            num_warmup=400, num_samples=600,
        )
        s = np.asarray(res.positions).reshape(-1, 2)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.1)
        assert np.allclose(np.cov(s.T), COV, atol=0.3)

    def test_pops_indivisible_raises(self):
        x0 = jnp.zeros((6, 2))
        try:
            infer.run_chees_pops(mvn_logp, x0, jax.random.PRNGKey(0), n_pops=4)
        except ValueError as e:
            assert "divisible" in str(e)
        else:
            raise AssertionError("expected ValueError")

    def test_divergent_chains_do_not_poison_adaptation(self):
        """Chains that blow up (inf endpoints) must contribute nothing to
        the trajectory/criterion statistics — regression: 0 * inf = NaN in
        the weighted criterion mean permanently NaN'd log_traj."""
        x0 = jnp.zeros((8, 2))
        res = infer.run_chees(
            mvn_logp,
            x0,
            jax.random.PRNGKey(7),
            num_warmup=200,
            num_samples=50,
            init_step_size=50.0,  # guarantees early divergences
            init_traj_length=100.0,
        )
        st = res.state
        assert np.isfinite(float(st.log_traj)), float(st.log_traj)
        assert np.isfinite(float(st.step_size))
        assert np.isfinite(np.asarray(res.positions)).all()
        # and it still recovered into a working sampler
        assert float(jnp.mean(res.accept_probs)) > 0.3


class TestChEESRace:
    """Post-warmup trajectory racing (chees_race): selection, not smoothing
    — the fix direction for ChEES's adaptation-draw variance (EMA
    smoothing of the adaptation path regressed)."""

    def _warm_state(self, seed=0, chains=32, warmup=300, max_steps=64):
        from gogp.infer import adapt
        from gogp.infer.chees import (
            chees_init,
            chees_warm_chunk,
            finalize_chees_warmup,
        )

        x0 = 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1), (chains, 2))
        state = chees_init(mvn_logp, x0, jax.random.PRNGKey(seed), 0.1, 1.0)
        sched = adapt.build_schedule(warmup)
        state = jax.jit(
            lambda s: chees_warm_chunk(
                mvn_logp, s, sched.update_mass, sched.window_end, max_steps
            )
        )(state)
        return finalize_chees_warmup(state)

    def test_race_picks_max_score_and_advances_state(self):
        from gogp.infer.chees import chees_race

        state = self._warm_state()
        win, info = jax.jit(
            lambda s: chees_race(mvn_logp, s, 4, 64, 64)
        )(state)
        score = np.asarray(info["score"])
        k = int(info["winner"])
        assert k == int(np.argmax(score))
        assert float(win.log_traj) == float(info["candidates_log_traj"][k])
        # probe transitions actually ran
        assert int(win.step) == int(state.step) + 64
        # cost is the exact shared-halton leapfrog-step sum: positive,
        # monotone in trajectory length among the grid candidates
        cost = np.asarray(info["leapfrog_cost"])
        grid = np.asarray(info["candidates_log_traj"])[1:]
        assert np.all(cost > 0)
        assert np.all(np.diff(cost[1:][np.argsort(grid)]) >= 0)

    def test_race_dethrones_pathological_trajectory(self):
        # force an absurdly long adapted trajectory: racing must hand the
        # budget to a cheaper candidate (scores are ESS per leapfrog step)
        from gogp.infer.chees import chees_race

        state = self._warm_state()
        state = state._replace(
            log_traj=jnp.log(63.0 * state.step_size)
        )
        win, info = chees_race(mvn_logp, state, 4, 64, 64)
        assert int(info["winner"]) != 0
        assert float(jnp.exp(win.log_traj)) < 0.9 * float(
            jnp.exp(state.log_traj)
        )

    def test_run_chees_with_race_moments(self):
        res = infer.run_chees(
            mvn_logp,
            0.5 * jax.random.normal(jax.random.PRNGKey(3), (32, 2)),
            jax.random.PRNGKey(4),
            num_warmup=300,
            num_samples=800,
            max_num_steps=64,
            race=4,
            race_probe=64,
        )
        s = np.asarray(res.positions).reshape(-1, 2)
        assert np.allclose(s.mean(axis=0), MEAN, atol=0.1)
        assert np.allclose(np.cov(s.T), COV, atol=0.3)

    def test_race_with_free_mask_scores_free_dims(self):
        # pinned dims (zero jumps / zero variance) must not pin every
        # candidate's slow-dim score at 0 and void the race
        from gogp.infer.chees import chees_race

        free = jnp.array([1.0, 0.0])
        from gogp.infer import adapt
        from gogp.infer.chees import (
            chees_init,
            chees_warm_chunk,
            finalize_chees_warmup,
        )

        x0 = jnp.tile(jnp.array([0.0, 5.0]), (16, 1))
        state = chees_init(mvn_logp, x0, jax.random.PRNGKey(8), 0.1, 1.0, free)
        sched = adapt.build_schedule(200)
        state = jax.jit(
            lambda s: chees_warm_chunk(
                mvn_logp, s, sched.update_mass, sched.window_end, 32,
                free=free,
            )
        )(state)
        state = finalize_chees_warmup(state)
        win, info = chees_race(mvn_logp, state, 4, 64, 32, free=free)
        score = np.asarray(info["score"])
        assert np.all(np.isfinite(score)) and score.max() > 0.0
        assert float(np.asarray(info["norm_esjd"]).max()) > 0.0
        # pinned coordinate untouched through the whole race
        assert np.all(np.asarray(win.positions)[:, 1] == 5.0)
