"""North-star benchmark: ESS/s per chip on hyperpriors NUTS (BASELINE.json).

Runs vmapped NUTS chains over the hyperpriors GP posterior (the flagship
model: 6 thetas, Matern52 trend + periodic seasonality + Normal hyperpriors
on the reference's trend_season dataset) and reports effective samples per
second of sampling walltime (min ESS across parameters, aggregated over
chains).

Work is dispatched in fixed-size chunks of transitions (one scan per chunk)
rather than one monolithic program: chunking gives walltime per phase for
free, and a run that extends its draws reuses the compiled chunk.

Usage: python benchmarks/ess_nuts.py [--chains 64] [--samples 512]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gogp.utils.compile_cache import enable_compile_cache  # noqa: E402
from gogp.utils.device import require_gpu  # noqa: E402

# persistent compilation cache: repeat benchmark runs skip the long
# compiles of the nested sampler loops
enable_compile_cache()

CHUNK = 64
RHAT_GATE = 1.01


def gated_summary(pos, walltime: float, warm_total: float) -> dict:
    """Convergence-gated ESS/s fields shared by every engine runner.

    ``pos``: (chains, draws, dim) retained draws.  The reported ESS is the
    min rank-normalized ("bulk", Stan-standard) split-chain ESS across
    parameters; the gate is max bulk split-R-hat <= RHAT_GATE (Vehtari et
    al. 2021 — rank normalization keeps the diagnostics measuring MIXING
    on heavy-tailed marginals like the noise theta's low-noise funnel
    tail, where raw-scale R-hat measures tail heaviness).  Raw-scale
    min-ESS/max-R-hat are carried alongside for the honest side-by-side.
    If the gate fails the headline ``value`` is None with a reason — a
    mixing-collapsed run must not print a number.
    ``ess_per_sec_e2e`` divides by warmup + racing + sampling walltime
    (compile excluded: it is persistent-cached across runs and reported
    separately).
    """
    from gogp.infer import diagnostics

    d = diagnostics.diagnose(jnp.asarray(pos))
    min_ess, max_rhat = d["min_ess_bulk"], d["max_rhat_bulk"]
    ok = max_rhat <= RHAT_GATE
    out = {
        "min_ess": round(min_ess, 1),
        "max_rhat": round(max_rhat, 4),
        "min_ess_raw": round(d["min_ess_raw"], 1),
        "max_rhat_raw": round(d["max_rhat_raw"], 4),
        "converged": ok,
        "walltime_s": round(walltime, 3),
        "warm_total_s": round(warm_total, 3),
    }
    if ok:
        out["value"] = round(min_ess / walltime, 2)
        out["ess_per_sec_e2e"] = round(min_ess / (warm_total + walltime), 2)
    else:
        out["value"] = None
        out["ess_per_sec_e2e"] = None
        out["value_reason"] = (
            f"max bulk split-R-hat {max_rhat:.4f} > {RHAT_GATE}: not converged"
        )
    return out


def build_logp():
    from gogp.models.params import gp_observe
    from gogp.tutorial import io as tio
    from gogp.tutorial.hyperpriors import make_priors, make_study, selfcheck_data

    study = make_study()
    gp = study.gp
    x, y = tio.load_csv(selfcheck_data())
    y_norm, _, _ = tio.normalize(y)
    priors = make_priors(x, y_norm)
    xj = jnp.asarray(x, dtype=jnp.float32)
    yj = jnp.asarray(y_norm, dtype=jnp.float32)
    mask = jnp.ones(x.shape[0], dtype=jnp.float32)

    def logp(v):
        return gp_observe(gp, v, x=xj, y=yj, mask=mask) + priors(v, mask)

    return logp, gp.n_theta


def run_pt(chains: int = 8, n_replicas: int = 8, num_warmup: int = 512,
           num_samples: int = 512, seed: int = 0, max_depth: int = 6,
           beta_min: float = 0.05, betas0=None):
    """Parallel-tempered variant: ``chains`` independent ladders of
    ``n_replicas`` replicas; ESS from the cold (beta=1) chains.  Driven in
    CHUNK-sized dispatches like the plain-NUTS path.
    ``betas0``: explicit ladder (e.g. from tune_ladder) overriding
    n_replicas/beta_min."""
    import functools

    from gogp.infer import adapt, diagnostics
    from gogp.infer.hmc import finalize_warmup
    from gogp.infer.tempering import (
        PTFlow,
        geometric_ladder,
        pt_init,
        pt_sample_chunk,
        pt_warm_chunk,
    )

    logp, dim = build_logp()
    if betas0 is not None:
        betas = jnp.asarray(betas0, jnp.float32)
        n_replicas = betas.shape[0]
    else:
        betas = geometric_ladder(n_replicas, beta_min, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), chains)
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), (chains, dim), dtype=jnp.float32
    )
    sched = adapt.build_schedule(num_warmup)

    init = jax.jit(jax.vmap(lambda q, k: pt_init(logp, q, k, betas)))
    states, loop_keys = init(x0, keys)
    jax.block_until_ready(states)

    # per-chain ladders: warmup adapts each chain's rungs to equal
    # communication-barrier increments (Syed et al.), so betas become
    # (chains, K) after the first chunk
    betas_all = jnp.broadcast_to(betas, (chains, n_replicas))

    @jax.jit
    def warm_chunk(states, loop_keys, betas_all, um, we, t0):
        return jax.vmap(
            lambda s, k, b: pt_warm_chunk(logp, s, k, b, um, we, t0, max_depth)
        )(states, loop_keys, betas_all)

    t0w = time.perf_counter()
    warm_c = warm_chunk.lower(
        states, loop_keys, betas_all, sched.update_mass[:CHUNK],
        sched.window_end[:CHUNK], jnp.asarray(0),
    ).compile()
    compile_s = time.perf_counter() - t0w

    t0w = time.perf_counter()
    for i in range(0, num_warmup, CHUNK):
        um = sched.update_mass[i : i + CHUNK]
        we = sched.window_end[i : i + CHUNK]
        f = warm_c if um.shape[0] == CHUNK else warm_chunk
        states, loop_keys, betas_all = f(
            states, loop_keys, betas_all, um, we, jnp.asarray(i)
        )
    jax.block_until_ready(states)
    warm_time = time.perf_counter() - t0w
    states = jax.jit(jax.vmap(jax.vmap(finalize_warmup)))(states)

    @functools.partial(jax.jit, static_argnums=(3,))
    def sample_chunk(states, loop_keys, betas_all, num, t0, flow):
        def one(s, k, b, fl):
            s, k, pos, raws, sw, fl = pt_sample_chunk(
                logp, s, k, b, num, t0, max_depth, flow=fl
            )
            return s, k, pos, sw, fl

        return jax.vmap(one)(states, loop_keys, betas_all, flow)

    flow0 = PTFlow(
        labels=jnp.zeros((chains, n_replicas), jnp.int32),
        trips=jnp.zeros((chains,), jnp.int32),
        rej_sum=jnp.zeros((chains, n_replicas - 1), jnp.float32),
        prop_count=jnp.zeros((chains, n_replicas - 1), jnp.float32),
    )
    states_c, lk_c, pos_c, _, _ = sample_chunk(
        states, loop_keys, betas_all, CHUNK, jnp.asarray(0), flow0
    )
    np.asarray(pos_c)  # warm the compile, synced

    flow = flow0
    chunks, swaps = [], []
    t0s = time.perf_counter()
    for i in range(0, num_samples, CHUNK):
        states, loop_keys, pos, sw, flow = sample_chunk(
            states, loop_keys, betas_all, CHUNK, jnp.asarray(num_warmup + i),
            flow,
        )
        chunks.append(np.asarray(pos))  # forces device sync per chunk
        swaps.append(sw)
    walltime = time.perf_counter() - t0s
    total_trips = int(np.asarray(flow.trips).sum())
    # mean (over chains) total communication barrier measured at sampling
    barrier = float(
        np.mean(
            np.sum(
                np.asarray(flow.rej_sum) / np.maximum(np.asarray(flow.prop_count), 1.0),
                axis=-1,
            )
        )
    )

    pos = np.concatenate(chunks, axis=1)  # (chains, S, dim)
    ess_per_param = np.asarray(diagnostics.ess(jnp.asarray(pos)))
    out = {
        "metric": "ess_per_sec_pt_nuts_hyperpriors",
        "unit": "ESS/s",
        "warmup_s": round(warm_time, 3),
        "warm_compile_s": round(compile_s, 3),
        "chains": chains,
        "n_replicas": n_replicas,
        "samples_per_chain": num_samples,
        "max_tree_depth": max_depth,
        "seed": seed,
        "ess_per_param": [round(float(e), 1) for e in ess_per_param],
        "swap_rate": round(float(np.mean([np.asarray(s) for s in swaps])), 3),
        # total beta_min -> 1 round trips across all ladders: cold-chain
        # ESS is capped at ~2x this, so it tells ladder- vs chain-limited
        "round_trips": total_trips,
        "barrier": round(barrier, 3),
        "beta_min": beta_min,
        "sampler": "pt-nuts",
        "platform": jax.devices()[0].platform,
        # chain-mean adapted ladder + per-pair rejections: feed these to
        # infer.tempering.place_rungs for depth auto-tuning (--auto-ladder)
        "mean_betas": [round(float(b), 5) for b in np.mean(np.asarray(betas_all), axis=0)],
        "mean_pair_rej": [
            round(float(r), 4)
            for r in np.mean(
                np.asarray(flow.rej_sum) / np.maximum(np.asarray(flow.prop_count), 1.0),
                axis=0,
            )
        ],
    }
    out.update(gated_summary(pos, walltime, warm_time))
    return out


def run_pt_chees_bench(chains: int = 16, n_replicas: int = 8, num_warmup: int = 512,
                       num_samples: int = 512, seed: int = 0,
                       beta_min: float = 0.05, max_steps: int = 256, betas0=None):
    """PT with ChEES rung populations: ``chains`` ladders, the chains at
    each rung forming one cross-ladder ChEES population (infer/pt_chees.py).
    One shared beta ladder (unlike run_pt's per-chain ladders) adapted from
    ladder-averaged pair rejections; ESS from all cold chains."""
    from gogp.infer import adapt, diagnostics
    from gogp.infer.chees import finalize_chees_warmup
    from gogp.infer.pt_chees import (
        _init_flow_ladders,
        geometric_ladder,
        pt_chees_init,
        pt_chees_sample_chunk,
        pt_chees_warm_chunk,
    )

    logp, dim = build_logp()
    if betas0 is not None:
        betas = jnp.asarray(betas0, jnp.float32)
        n_replicas = betas.shape[0]
    else:
        betas = geometric_ladder(n_replicas, beta_min, jnp.float32)
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), (chains, dim), dtype=jnp.float32
    )
    key, key_init = jax.random.split(jax.random.PRNGKey(seed))
    state = pt_chees_init(logp, x0, key_init, betas, chains)
    jax.block_until_ready(state)
    sched = adapt.build_schedule(num_warmup)

    @jax.jit
    def warm_chunk(state, key, betas, um, we, t0):
        return pt_chees_warm_chunk(logp, state, key, betas, um, we, t0, max_steps)

    t0w = time.perf_counter()
    warm_c = warm_chunk.lower(
        state, key, betas, sched.update_mass[:CHUNK], sched.window_end[:CHUNK],
        jnp.asarray(0),
    ).compile()
    compile_s = time.perf_counter() - t0w

    t0w = time.perf_counter()
    for i in range(0, num_warmup, CHUNK):
        um = sched.update_mass[i : i + CHUNK]
        we = sched.window_end[i : i + CHUNK]
        f = warm_c if um.shape[0] == CHUNK else warm_chunk
        state, key, betas = f(state, key, betas, um, we, jnp.asarray(i))
    jax.block_until_ready(state)
    warm_time = time.perf_counter() - t0w
    state = jax.jit(jax.vmap(finalize_chees_warmup))(state)

    import functools

    @functools.partial(jax.jit, static_argnums=(3,))
    def sample_chunk(state, key, betas, num, t0, flow):
        return pt_chees_sample_chunk(
            logp, state, key, betas, num, t0, max_steps, flow=flow
        )

    flow0 = _init_flow_ladders(chains, betas)
    st_c, k_c, pos_c, _, _, _ = sample_chunk(
        state, key, betas, CHUNK, jnp.asarray(0), flow0
    )
    np.asarray(pos_c)  # synced compile warmup

    flow = flow0
    chunks, swaps = [], []
    t0s = time.perf_counter()
    for i in range(0, num_samples, CHUNK):
        state, key, pos, _, sw, flow = sample_chunk(
            state, key, betas, CHUNK, jnp.asarray(num_warmup + i), flow
        )
        chunks.append(np.asarray(pos))  # device sync per chunk
        swaps.append(np.asarray(sw))
    walltime = time.perf_counter() - t0s

    pos = np.concatenate(chunks, axis=0)  # (S, L, dim)
    pos = np.moveaxis(pos, 1, 0)  # (L, S, dim)
    ess_per_param = np.asarray(diagnostics.ess(jnp.asarray(pos)))
    pair_rej = np.asarray(flow.rej_sum) / np.maximum(np.asarray(flow.prop_count), 1.0)
    out = {
        "metric": "ess_per_sec_pt_chees_hyperpriors",
        "unit": "ESS/s",
        "warmup_s": round(warm_time, 3),
        "warm_compile_s": round(compile_s, 3),
        "chains": chains,
        "n_replicas": n_replicas,
        "samples_per_chain": num_samples,
        "seed": seed,
        "ess_per_param": [round(float(e), 1) for e in ess_per_param],
        "swap_rate": round(float(np.mean(swaps)), 3),
        "round_trips": int(np.asarray(flow.trips).sum()),
        "barrier": round(float(np.sum(pair_rej)), 3),
        "beta_min": beta_min,
        "step_sizes": [round(float(s), 4) for s in np.asarray(state.step_size)],
        "traj_lengths": [round(float(t), 3) for t in np.exp(np.asarray(state.log_traj))],
        "sampler": "pt-chees",
        "platform": jax.devices()[0].platform,
    }
    out.update(gated_summary(pos, walltime, warm_time))
    return out


def run_chees_bench(chains: int = 64, num_warmup: int = 512, num_samples: int = 512,
                    seed: int = 0, max_steps: int = 256, n_pops: int = 1,
                    race: int = 0, race_probe: int = 128):
    """ChEES-HMC: one shared adaptively-tuned trajectory for the whole chain
    population — no per-chain tree depth, so a vmapped step is pure lockstep
    batched leapfrog (infer/chees.py).

    ``n_pops > 1`` batches that many INDEPENDENT populations of
    chains//n_pops chains (infer.run_chees_pops): population size is an
    adaptation-quality knob (64 is this posterior's sweet spot) while the
    device's throughput can keep scaling past it — pops decouple the two.

    ``race > 0`` (single-pop only) inserts the post-warmup trajectory-
    length race (infer.chees.chees_race): ``race`` candidate trajectories
    probed ``race_probe`` transitions each in one batched program, budget
    to the best probe-ESS-per-leapfrog-step — the selection fix for the
    adaptation-draw variance."""
    from gogp.infer import adapt, diagnostics
    from gogp.infer.chees import (
        chees_init,
        chees_race,
        chees_sample_chunk,
        chees_warm_chunk,
        finalize_chees_warmup,
    )

    logp, dim = build_logp()
    if chains % n_pops != 0:
        raise ValueError(f"{chains} chains not divisible by {n_pops} pops")
    per = chains // n_pops
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), (chains, dim), dtype=jnp.float32
    )
    sched = adapt.build_schedule(num_warmup)
    base_key = jax.random.PRNGKey(seed)
    if n_pops == 1:
        state = chees_init(logp, x0, base_key, 0.1, 1.0)
    else:
        keys = jax.vmap(lambda i: jax.random.fold_in(base_key, i))(
            jnp.arange(n_pops)
        )
        state = jax.jit(
            jax.vmap(lambda p, k: chees_init(logp, p, k, 0.1, 1.0))
        )(x0.reshape(n_pops, per, dim), keys)
    jax.block_until_ready(state)

    @jax.jit
    def warm_chunk(state, um, we):
        f = lambda s: chees_warm_chunk(logp, s, um, we, max_steps)
        return jax.vmap(f)(state) if n_pops > 1 else f(state)

    # AOT-compile the warm chunk so warm_time measures adaptation compute,
    # not the (cached-across-runs) compile
    t0 = time.perf_counter()
    warm_c = warm_chunk.lower(
        state, sched.update_mass[:CHUNK], sched.window_end[:CHUNK]
    ).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(0, num_warmup, CHUNK):
        um = sched.update_mass[i : i + CHUNK]
        we = sched.window_end[i : i + CHUNK]
        # AOT executable requires exact shapes; ragged tail falls back to jit
        state = warm_c(state, um, we) if um.shape[0] == CHUNK else warm_chunk(state, um, we)
    jax.block_until_ready(state)
    warm_time = time.perf_counter() - t0
    fin = jax.vmap(finalize_chees_warmup) if n_pops > 1 else finalize_chees_warmup
    state = jax.jit(fin)(state)

    race_time = 0.0
    race_info = None
    if race > 0:
        if n_pops != 1:
            raise ValueError("--race supports single-population runs only")
        race_fn = jax.jit(
            lambda s: chees_race(logp, s, race, race_probe, max_steps)
        )
        t0 = time.perf_counter()
        race_c = race_fn.lower(state).compile()
        race_compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, info = race_c(state)
        jax.block_until_ready(state)
        race_time = time.perf_counter() - t0
        race_info = {
            "candidates_traj": [
                round(float(t), 4)
                for t in np.exp(np.asarray(info["candidates_log_traj"]))
            ],
            "probe_min_ess": [
                round(float(e), 1) for e in np.asarray(info["probe_min_ess"])
            ],
            "norm_esjd": [
                round(float(e), 5) for e in np.asarray(info["norm_esjd"])
            ],
            "leapfrog_cost": [int(c) for c in np.asarray(info["leapfrog_cost"])],
            "winner": int(info["winner"]),
            "probe": race_probe,
            "race_s": round(race_time, 3),
            "race_compile_s": round(race_compile_s, 3),
        }

    @jax.jit
    def sample_chunk(state):
        if n_pops > 1:
            state, (pos, _, acc) = jax.vmap(
                lambda s: chees_sample_chunk(logp, s, CHUNK, max_steps)
            )(state)
            # (P, CHUNK, per, dim) -> (P*per, CHUNK, dim), grouped by pop
            pos = jnp.moveaxis(pos, 1, 2).reshape(chains, CHUNK, dim)
            return state, pos, acc
        state, (pos, _, acc) = chees_sample_chunk(logp, state, CHUNK, max_steps)
        return state, jnp.swapaxes(pos, 0, 1), acc  # (chains, CHUNK, dim)

    state_c, pos_c, _ = sample_chunk(state)
    np.asarray(pos_c)  # synced compile warmup

    chunks, accs = [], []
    t0 = time.perf_counter()
    for _ in range(0, num_samples, CHUNK):
        state, pos, acc = sample_chunk(state)
        chunks.append(np.asarray(pos))  # forces device sync per chunk
        accs.append(np.asarray(acc))
    walltime = time.perf_counter() - t0

    pos = np.concatenate(chunks, axis=1)  # (chains, S, dim)
    ess_per_param = np.asarray(diagnostics.ess(jnp.asarray(pos)))
    out = {
        "metric": "ess_per_sec_chees_hyperpriors",
        "unit": "ESS/s",
        "warmup_s": round(warm_time, 3),
        "warm_compile_s": round(compile_s, 3),
        "chains": chains,
        "n_pops": n_pops,
        "samples_per_chain": num_samples,
        "seed": seed,
        "ess_per_param": [round(float(e), 1) for e in ess_per_param],
        "accept_rate": round(float(np.mean(accs)), 3),
        "step_size": [round(float(s), 4) for s in np.atleast_1d(np.asarray(state.step_size))],
        "traj_length": [round(float(t), 4) for t in np.atleast_1d(np.exp(np.asarray(state.log_traj)))],
        "sampler": "chees-hmc" if race == 0 else "chees-hmc+race",
        "platform": jax.devices()[0].platform,
    }
    if race_info is not None:
        out["race"] = race_info
    out.update(gated_summary(pos, walltime, warm_time + race_time))
    return out


def run_ghmc_bench(chains: int = 64, num_warmup: int = 2048,
                   num_samples: int = 16384, seed: int = 0,
                   chunk: int = 2048):
    """Persistent-momentum GHMC (infer/ghmc.py): ONE gradient per
    transition, no trajectory adaptation.  Needs many more (much cheaper)
    transitions than ChEES for the same ESS, so the chunk is large —
    a 64-transition dispatch would be dominated by per-dispatch overhead."""
    from gogp.infer import diagnostics
    from gogp.infer.ghmc import (
        finalize_ghmc_warmup,
        ghmc_init,
        ghmc_sample_chunk,
        ghmc_warm_chunk,
    )

    logp, dim = build_logp()
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), (chains, dim), dtype=jnp.float32
    )
    state = jax.jit(
        lambda p, k: ghmc_init(logp, p, k, 0.05)
    )(x0, jax.random.PRNGKey(seed))
    jax.block_until_ready(state)

    warm_chunk = jax.jit(lambda s: ghmc_warm_chunk(logp, s, chunk))
    t0 = time.perf_counter()
    warm_c = warm_chunk.lower(state).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(0, num_warmup, chunk):
        state = warm_c(state)
        jax.block_until_ready(state)
    warm_time = time.perf_counter() - t0
    state = jax.jit(finalize_ghmc_warmup)(state)

    sample_chunk = jax.jit(lambda s: ghmc_sample_chunk(logp, s, chunk))
    st_c, (pos_c, _, _) = sample_chunk(state)
    np.asarray(pos_c)  # synced compile warmup

    chunks, accs = [], []
    t0 = time.perf_counter()
    for _ in range(0, num_samples, chunk):
        state, (pos, _, acc) = sample_chunk(state)
        chunks.append(np.asarray(pos))  # (chunk, chains, dim), device sync
        accs.append(np.asarray(acc))
    walltime = time.perf_counter() - t0

    pos = np.moveaxis(np.concatenate(chunks, axis=0), 1, 0)  # (chains, S, dim)
    ess_per_param = np.asarray(diagnostics.ess(jnp.asarray(pos)))
    out = {
        "metric": "ess_per_sec_ghmc_hyperpriors",
        "unit": "ESS/s",
        "warmup_s": round(warm_time, 3),
        "warm_compile_s": round(compile_s, 3),
        "chains": chains,
        "samples_per_chain": num_samples,
        "chunk": chunk,
        "seed": seed,
        "ess_per_param": [round(float(e), 1) for e in ess_per_param],
        "accept_rate": round(float(np.mean(accs)), 3),
        "step_size": round(float(state.step_size), 5),
        "sigma_ratio": round(
            float(np.max(np.asarray(state.sigma)) / np.min(np.asarray(state.sigma))), 3
        ),
        "sampler": "ghmc",
        "platform": jax.devices()[0].platform,
    }
    out.update(gated_summary(pos, walltime, warm_time))
    return out


def run(chains: int = 64, num_warmup: int = 512, num_samples: int = 512, seed: int = 0, max_depth: int = 8):
    from gogp.infer import adapt, diagnostics
    from gogp.infer.hmc import finalize_warmup, init_state, warmup_step
    from gogp.infer.nuts import nuts_transition

    logp, dim = build_logp()
    keys = jax.random.split(jax.random.PRNGKey(seed), chains)
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(seed + 1), (chains, dim), dtype=jnp.float32
    )
    sched = adapt.build_schedule(num_warmup)

    init = jax.jit(jax.vmap(lambda q, k: init_state(logp, q, k, 0.1)))
    states = init(x0, keys)
    jax.block_until_ready(states)

    @jax.jit
    def warm_chunk(states, um, we):
        def step(states, flags):
            u, w = flags
            states = jax.vmap(lambda s: nuts_transition(logp, s, max_depth))(states)
            states = jax.vmap(lambda s: warmup_step(s, u, w))(states)
            return states, None

        states, _ = jax.lax.scan(step, states, (um, we))
        return states

    # AOT-compile so warm_time measures adaptation compute (chees parity)
    t0 = time.perf_counter()
    warm_c = warm_chunk.lower(
        states, sched.update_mass[:CHUNK], sched.window_end[:CHUNK]
    ).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(0, num_warmup, CHUNK):
        um = sched.update_mass[i : i + CHUNK]
        we = sched.window_end[i : i + CHUNK]
        states = warm_c(states, um, we) if um.shape[0] == CHUNK else warm_chunk(states, um, we)
    jax.block_until_ready(states)
    warm_time = time.perf_counter() - t0
    states = jax.jit(jax.vmap(finalize_warmup))(states)

    @jax.jit
    def sample_chunk(states):
        def step(states, _):
            states = jax.vmap(lambda s: nuts_transition(logp, s, max_depth))(states)
            return states, states.position

        states, pos = jax.lax.scan(step, states, None, length=CHUNK)
        return states, jnp.swapaxes(pos, 0, 1)  # (chains, CHUNK, dim)

    # compile once (not timed), then time the sampling chunks
    states_c, pos_c = sample_chunk(states)
    np.asarray(pos_c)  # synced compile warmup

    chunks = []
    t0 = time.perf_counter()
    for _ in range(0, num_samples, CHUNK):
        states, pos = sample_chunk(states)
        chunks.append(np.asarray(pos))  # forces device sync per chunk
    walltime = time.perf_counter() - t0

    pos = np.concatenate(chunks, axis=1)  # (chains, S, dim)
    ess_per_param = np.asarray(diagnostics.ess(jnp.asarray(pos)))  # (dim,)
    accept = float(np.mean(np.asarray(states.accept_prob)))
    out = {
        "metric": "ess_per_sec_nuts_hyperpriors",
        "unit": "ESS/s",
        "warmup_s": round(warm_time, 3),
        "warm_compile_s": round(compile_s, 3),
        "chains": chains,
        "samples_per_chain": num_samples,
        "max_tree_depth": max_depth,
        "seed": seed,
        "ess_per_param": [round(float(e), 1) for e in ess_per_param],
        "accept_rate": round(accept, 3),
        "step_size": round(float(np.mean(np.asarray(states.step_size))), 4),
        "sampler": "nuts",
        "platform": jax.devices()[0].platform,
    }
    out.update(gated_summary(pos, walltime, warm_time))
    return out


PROTOCOL_SEEDS = (0, 1, 2, 3, 4)

# Qualifier configs: one representative budget per engine family.  GHMC's
# per-transition cost is one gradient, so its draw budget is large for the
# same walltime; PT pays the ladder but crosses the noise-theta funnel.
QUALIFIER_CONFIGS = (
    {"engine": "chees", "chains": 64, "num_warmup": 512,
     "num_samples": 2048, "max_steps": 64, "race": 4, "race_probe": 128},
    # one chunk size per engine: the sample-chunk program is keyed on it
    {"engine": "ghmc", "chains": 64, "ghmc_warmup": 2048,
     "ghmc_samples": 32768, "chunk": 2048},
    {"engine": "pt-chees", "chains": 64, "num_warmup": 512,
     "num_samples": 2048, "max_steps": 64},
)


def qualify_engine(configs=QUALIFIER_CONFIGS, seed: int = 0,
                   quiet: bool = True) -> dict:
    """One gated seed-``seed`` run per engine config; rank them.

    Order: any converged run beats any non-converged; among converged,
    higher gated ESS/s wins; among non-converged, lower max bulk R-hat
    (closer to mixing) wins.  Returns {"winner": config, "rows": [...]}
    — bench.py runs the full seed-median protocol on the winner, so the
    recorded engine is chosen by measurement in the artifact itself, not
    by a hardcoded pick.
    """
    rows = []
    for cfg in configs:
        cfg = dict(cfg)
        engine = cfg.pop("engine")
        try:
            out = run_protocol(engine, seeds=(seed,), quiet=True, **cfg)
            row_src = out["per_seed"][0]
            row = {"engine": engine, "config": cfg,
                   "ess_per_sec": row_src["ess_per_sec"],
                   "max_rhat": row_src["max_rhat"],
                   "min_ess": row_src["min_ess"],
                   "walltime_s": row_src["walltime_s"]}
            if row_src.get("reason"):
                row["reason"] = row_src["reason"]
        except Exception as e:  # noqa: BLE001
            row = {"engine": engine, "config": cfg, "ess_per_sec": None,
                   "max_rhat": None, "min_ess": None, "walltime_s": None,
                   "reason": f"{type(e).__name__}: {e}"}
        rows.append(row)
        if not quiet:
            print(json.dumps({"qualifier": row}), flush=True)

    def key(r):
        converged = r["ess_per_sec"] is not None
        return (
            0 if converged else 1,
            -(r["ess_per_sec"] or 0.0),
            r["max_rhat"] if r["max_rhat"] is not None else float("inf"),
        )

    ranked = sorted(rows, key=key)
    best = ranked[0]
    winner = None
    for cfg in configs:
        c = dict(cfg)
        if c.pop("engine") == best["engine"] and c == best["config"]:
            winner = dict(cfg)
            break
    return {"winner": winner, "rows": rows,
            "winner_converged": best["ess_per_sec"] is not None}


def run_protocol(engine: str = "chees", seeds=PROTOCOL_SEEDS, chains: int = 64,
                 num_warmup: int = 512, num_samples: int = 2048,
                 max_steps: int = 64, race: int = 0, race_probe: int = 128,
                 ghmc_warmup: int = 2048, ghmc_samples: int = 16384,
                 chunk: int = 2048, max_extensions: int = 1,
                 quiet: bool = False) -> dict:
    """Seed-median ESS/s protocol: the honest north star.

    Runs ``engine`` once per seed at a FIXED config, ESS estimated from
    >= 2048 retained draws with split-chain ESS, per-seed values gated on
    split-R-hat <= 1.01 (a non-converged seed scores 0 — it delivered no
    usable samples), and reports the MEDIAN over seeds of both the
    sampling-walltime ESS/s and the end-to-end (warmup + race + sampling)
    ESS/s.  Medians over >= 5 seeds are what runs compare; a single
    pinned seed measures the luck of one adaptation draw, not the engine.

    Adaptive extension: a seed that fails ONLY the R-hat gate is re-run
    with its draw budget doubled, up to ``max_extensions`` times — the
    practitioner's "run longer until converged", with the gate itself
    untouched.  ESS/s is a rate, so a longer converged run measures the
    same quantity; the retried run is fully deterministic in (seed,
    draws).  The final draw count and extension count are recorded
    per-seed.  Crashes do NOT extend — they score 0
    immediately with the error recorded.  Sampling is chunk-compiled in
    every engine runner, so extensions reuse the cached program.
    """
    if engine not in ("chees", "ghmc", "nuts", "pt-chees"):
        raise ValueError(f"unknown engine {engine!r}")

    def run_one(s: int, draws: int) -> dict:
        if engine == "chees":
            return run_chees_bench(chains, num_warmup, draws, s,
                                   max_steps, 1, race, race_probe)
        if engine == "ghmc":
            return run_ghmc_bench(chains, ghmc_warmup, draws, s, chunk)
        if engine == "nuts":
            return run(chains, num_warmup, draws, s)
        return run_pt_chees_bench(max(chains // 4, 4), 8, num_warmup,
                                  draws, s, max_steps=max_steps)

    per_seed = []
    for s in seeds:
        draws = ghmc_samples if engine == "ghmc" else num_samples
        extensions = 0
        out = None
        err_row = None
        while True:
            try:
                out = run_one(s, draws)
            except Exception as e:  # noqa: BLE001 — one crashed seed
                # (a device error, a worker restart) must not void the whole
                # artifact; it scores 0 like a non-converged seed, with
                # the error recorded, and is never extended
                err_row = {
                    "seed": s, "ess_per_sec": None, "ess_per_sec_e2e": None,
                    "min_ess": None, "max_rhat": None, "walltime_s": None,
                    "warm_total_s": None, "samples_per_chain": draws,
                    "extensions": extensions,
                    "reason": f"{type(e).__name__}: {e}",
                }
                break
            gated_out = out["value"] is None and "value_reason" in out
            if not gated_out or extensions >= max_extensions:
                break
            extensions += 1
            draws *= 2
        if err_row is not None:
            per_seed.append(err_row)
            if not quiet:
                print(json.dumps({"protocol_seed": err_row}), flush=True)
            continue
        row = {
            "seed": s,
            "ess_per_sec": out["value"],
            "ess_per_sec_e2e": out["ess_per_sec_e2e"],
            "min_ess": out["min_ess"],
            "max_rhat": out["max_rhat"],
            "min_ess_raw": out.get("min_ess_raw"),
            "max_rhat_raw": out.get("max_rhat_raw"),
            "walltime_s": out["walltime_s"],
            "warm_total_s": out["warm_total_s"],
            "samples_per_chain": draws,
            "extensions": extensions,
        }
        if out.get("value_reason"):
            row["reason"] = out["value_reason"]
        if out.get("race"):
            row["race_winner_traj"] = out["race"]["candidates_traj"][
                out["race"]["winner"]
            ]
        per_seed.append(row)
        if not quiet:
            print(json.dumps({"protocol_seed": row}), flush=True)

    def med(field):
        vals = [r[field] if r[field] is not None else 0.0 for r in per_seed]
        return float(np.median(vals)), vals

    median_sampling, vals_sampling = med("ess_per_sec")
    median_e2e, vals_e2e = med("ess_per_sec_e2e")
    return {
        "metric": f"ess_per_sec_{engine}_hyperpriors_seed_median",
        "value": round(median_sampling, 2),
        "unit": "ESS/s",
        "ess_per_sec_median": round(median_sampling, 2),
        "ess_per_sec_e2e_median": round(median_e2e, 2),
        "ess_per_sec_min": round(min(vals_sampling), 2),
        "ess_per_sec_max": round(max(vals_sampling), 2),
        "per_seed": per_seed,
        "n_converged": sum(1 for r in per_seed if r["ess_per_sec"] is not None),
        "n_seeds": len(per_seed),
        "engine": engine,
        "rhat_gate": RHAT_GATE,
        "platform": jax.devices()[0].platform,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=512)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--pt", action="store_true", help="parallel-tempered NUTS")
    ap.add_argument("--chees", action="store_true", help="ChEES-HMC (shared adaptive trajectory)")
    ap.add_argument("--ghmc", action="store_true",
                    help="persistent-momentum GHMC (one gradient per "
                    "transition, cross-fold ensemble adaptation)")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="with --ghmc: transitions per dispatch")
    ap.add_argument("--pt-chees", action="store_true",
                    help="parallel tempering with ChEES rung populations")
    ap.add_argument("--max-steps", type=int, default=256,
                    help="with --chees: leapfrog-steps-per-transition cap")
    ap.add_argument("--race", type=int, default=0,
                    help="with --chees: K-candidate post-warmup trajectory "
                    "race (probe ESS per leapfrog step picks the sampling "
                    "trajectory; 0 = off)")
    ap.add_argument("--race-probe", type=int, default=128,
                    help="with --race: probe transitions per candidate")
    ap.add_argument("--protocol", default="",
                    help="engine name (chees|ghmc|nuts|pt-chees): run the "
                    "seed-median protocol (5 seeds, 2048 draws, split-chain "
                    "ESS, R-hat gate) and print the aggregate JSON line")
    ap.add_argument("--protocol-seeds", default="0,1,2,3,4",
                    help="with --protocol: comma-separated seeds")
    ap.add_argument("--pops", type=int, default=1,
                    help="with --chees: independent populations of "
                    "chains/pops chains (per-population adaptation)")
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--beta-min", type=float, default=0.05)
    ap.add_argument(
        "--auto-ladder", action="store_true",
        help="with --pt: pilot run estimates the communication barrier, "
        "then K* = ceil(1 + 2*Lambda) rungs are placed at equal barrier "
        "increments (Syed et al.; infer.tempering.tune_ladder recipe, "
        "driven chunked here)",
    )
    ap.add_argument(
        "--sweep", default="",
        help="comma-separated chain counts: print one JSON line per count "
        "(the chains -> ESS/s and samples/s saturation curve; anchors "
        "whether a single number is throughput- or mixing-limited)",
    )
    args = ap.parse_args()
    require_gpu(1, "ess_nuts.py")  # a measurement never falls back to the CPU
    if args.protocol:
        out = run_protocol(
            args.protocol,
            seeds=[int(s) for s in args.protocol_seeds.split(",")],
            chains=args.chains,
            num_warmup=args.warmup,
            num_samples=args.samples,
            max_steps=args.max_steps,
            race=args.race,
            race_probe=args.race_probe,
            chunk=args.chunk,
        )
        print(json.dumps(out))
        return
    betas0 = None
    if args.pt and args.auto_ladder:
        import math

        from gogp.infer.tempering import place_rungs

        pilot = run_pt(
            min(args.chains, 8), args.replicas, min(args.warmup, 256), 128,
            args.seed + 100, args.max_depth, args.beta_min,
        )
        lam = pilot["barrier"]
        k_star = min(max(math.ceil(1.0 + 2.0 * lam), 2), 64)
        betas0 = place_rungs(
            jnp.asarray(pilot["mean_betas"], jnp.float32),
            jnp.asarray(pilot["mean_pair_rej"], jnp.float32),
            k_star,
        )
        print(json.dumps({
            "auto_ladder": {
                "barrier": lam, "k_star": k_star,
                "pilot_replicas": args.replicas,
                "betas": [round(float(b), 5) for b in betas0],
            }
        }), flush=True)
    if args.sweep:
        for c in [int(s) for s in args.sweep.split(",")]:
            if args.ghmc:
                out = run_ghmc_bench(c, args.warmup, args.samples,
                                     args.seed, args.chunk)
            elif args.pt:
                out = run_pt(c, args.replicas, args.warmup, args.samples,
                             args.seed, args.max_depth, args.beta_min, betas0)
            elif args.pt_chees:
                out = run_pt_chees_bench(c, args.replicas, args.warmup,
                                         args.samples, args.seed,
                                         args.beta_min, args.max_steps, betas0)
            elif args.chees:
                out = run_chees_bench(c, args.warmup, args.samples, args.seed,
                                      args.max_steps, args.pops, args.race,
                                      args.race_probe)
            else:
                out = run(c, args.warmup, args.samples, args.seed, args.max_depth)
            out["samples_per_sec"] = round(c * args.samples / out["walltime_s"], 1)
            print(json.dumps(out), flush=True)
        return
    if args.ghmc:
        out = run_ghmc_bench(args.chains, args.warmup, args.samples,
                             args.seed, args.chunk)
    elif args.pt:
        out = run_pt(args.chains, args.replicas, args.warmup, args.samples,
                     args.seed, args.max_depth, args.beta_min, betas0)
    elif args.pt_chees:
        out = run_pt_chees_bench(args.chains, args.replicas, args.warmup,
                                 args.samples, args.seed, args.beta_min,
                                 args.max_steps, betas0)
    elif args.chees:
        out = run_chees_bench(args.chains, args.warmup, args.samples, args.seed,
                              args.max_steps, args.pops, args.race,
                              args.race_probe)
    else:
        out = run(args.chains, args.warmup, args.samples, args.seed, args.max_depth)
    out["samples_per_sec"] = round(args.chains * args.samples / out["walltime_s"], 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
