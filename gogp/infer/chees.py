"""ChEES-HMC: cross-chain adaptive trajectory lengths, the lockstep sampler.

Part of the north-star inference layer (BASELINE.json) — the reference
delegates inference to Infergo/gonum (tutorial/tutorial.go:128-169) and has
no sampler of its own; upstream Infergo ships HMC/NUTS, which run_nuts
reproduces.  This module goes further with the ChEES scheme (Hoffman, Radul
& Sountsov, AISTATS 2021): instead of NUTS's per-chain U-turn recursion, ALL
chains share one trajectory length, adapted by stochastic gradient ascent on
the Change-in-the-Estimator-of-the-Expected-Square criterion

    ChEES = E[ ( ||q' - E q'||^2 - ||q - E q||^2 )^2 ] / 4,

whose gradient w.r.t. the integration time is available from the endpoint
velocity alone.

Why this is the accelerator-idiomatic sampler: vmapped NUTS is lockstep — every
chain pays the leapfrog steps of the *deepest* tree in the batch each
transition, and the U-turn recursion adds bookkeeping per step.  ChEES-HMC
runs one shared-length leapfrog loop for the whole chain population (pure
batched matvecs), and all of its adaptation statistics are
plain cross-chain means — which also makes the multi-device story a pmean:
pass ``axis_name`` when the chain population is sharded with shard_map and
every adaptation decision stays bitwise identical on all devices.

State layout: unlike hmc.HMCState (per-chain, vmapped from outside), the
population lives INSIDE ChEESState — adaptation couples chains, so the
transition owns the chain axis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt
from gogp.infer.hmc import IntegratorState, Samples

Array = jax.Array
LogDensity = Callable[[Array], Array]


class AdamState(NamedTuple):
    """Scalar Adam for the log-trajectory-length ascent."""

    m: Array  # ()
    v: Array  # ()
    t: Array  # () int32


def _adam_init(dtype) -> AdamState:
    return AdamState(
        m=jnp.zeros((), dtype), v=jnp.zeros((), dtype), t=jnp.asarray(0, jnp.int32)
    )


def _adam_update(s: AdamState, grad: Array, lr: float) -> tuple[Array, AdamState]:
    """Return the (ascent) update step and the new state."""
    t = s.t + 1
    m = 0.9 * s.m + 0.1 * grad
    v = 0.999 * s.v + 0.001 * grad * grad
    tf = t.astype(m.dtype)
    mhat = m / (1.0 - 0.9**tf)
    vhat = v / (1.0 - 0.999**tf)
    return lr * mhat / (jnp.sqrt(vhat) + 1e-8), AdamState(m, v, t)


class ChEESState(NamedTuple):
    """Whole-population state: ``positions`` has the chain axis inside."""

    positions: Array  # (chains, dim)
    logps: Array  # (chains,)
    grads: Array  # (chains, dim)
    step_size: Array  # () shared across chains
    inv_mass: Array  # (dim,) shared diagonal inverse mass
    log_traj: Array  # () log of the max trajectory length T
    accept_probs: Array  # (chains,)
    da: adapt.DualAveragingState  # shared step-size dual averaging
    adam: AdamState  # trajectory-length Adam
    welford: adapt.WelfordState  # cross-chain mass accumulator
    step: Array  # () int32 iteration counter (drives the halton jitter)
    rng: Array


def _halton2(i: Array) -> Array:
    """van der Corput base-2 radical inverse of ``i`` — the standard
    low-discrepancy jitter sequence for ChEES trajectory lengths (one shared
    draw per iteration; a plain uniform works but mixes the adaptation signal
    with extra variance)."""
    i = i.astype(jnp.uint32)

    def body(k, carry):
        val, n = carry
        bit = (n & 1).astype(jnp.float32)
        return val + bit * (0.5 ** (k.astype(jnp.float32) + 1.0)), n >> 1

    val, _ = jax.lax.fori_loop(0, 24, body, (jnp.float32(0.0), i))
    return val


def chees_init(
    logp: LogDensity,
    positions: Array,
    rng: Array,
    step_size: float = 0.1,
    traj_length: float = 1.0,
    free: Array | None = None,
) -> ChEESState:
    positions = jnp.atleast_2d(jnp.asarray(positions))
    vals, grads = jax.vmap(jax.value_and_grad(logp))(positions)
    if free is not None:
        grads = grads * jnp.asarray(free, grads.dtype)
    chains, dim = positions.shape
    dt = positions.dtype
    return ChEESState(
        positions=positions,
        logps=vals,
        grads=grads,
        step_size=jnp.asarray(step_size, dt),
        inv_mass=jnp.ones((dim,), dt),
        log_traj=jnp.log(jnp.asarray(traj_length, dt)),
        accept_probs=jnp.zeros((chains,), dt),
        da=adapt.da_init(jnp.asarray(step_size, dt)),
        adam=_adam_init(dt),
        welford=adapt.welford_init(dim, dt),
        step=jnp.asarray(0, jnp.int32),
        rng=rng,
    )


def _pmean(x: Array, axis_name: str | tuple | None) -> Array:
    if axis_name is None:
        return x
    return jax.lax.pmean(x, axis_name)


def chees_transition(
    logp: LogDensity,
    state: ChEESState,
    adapt_traj: bool | Array = False,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Array | None = None,
    divergence_threshold: float = 1000.0,
    axis_name: str | tuple | None = None,
    chain_offset: Array | int = 0,
) -> ChEESState:
    """One population transition: shared jittered trajectory, batched
    leapfrog, per-chain Metropolis, optional ChEES gradient step on log T.

    ``axis_name``: name (or tuple of names) of mapped device axes holding
    more chains; all cross-chain reductions then pmean over them so every
    device adapts identically (the psum'd-adaptation idiom of
    parallel/sample.py).

    ``chain_offset``: global index of this shard's first chain.  Per-chain
    randomness is derived by fold_in(iteration key, global chain index), so
    a sharded population draws exactly the momenta/accepts a single-device
    run would — the device-count-invariance contract.
    """
    vg = jax.value_and_grad(logp)
    if free is not None:
        freea = jnp.asarray(free, state.positions.dtype)

        def vg_masked(q):
            v, g = jax.value_and_grad(logp)(q)
            return v, g * freea

        vg = vg_masked
    else:
        freea = None

    chains, dim = state.positions.shape
    dt = state.positions.dtype
    key, key_iter = jax.random.split(state.rng)
    idx = jnp.asarray(chain_offset) + jnp.arange(chains)

    def chain_draws(i):
        km, ka = jax.random.split(jax.random.fold_in(key_iter, i))
        return jax.random.normal(km, (dim,), dt), jax.random.uniform(ka, (), dt)

    r0_raw, u_acc = jax.vmap(chain_draws)(idx)

    # shared jittered trajectory length: t = u * T, u from the halton
    # sequence (all chains integrate the same number of steps — lockstep by
    # construction, nothing waits on a deepest tree)
    u = _halton2(state.step).astype(dt)
    traj = jnp.exp(state.log_traj)
    t_real = jnp.maximum(u * traj, state.step_size)
    n_steps = jnp.clip(
        jnp.ceil(t_real / state.step_size).astype(jnp.int32), 1, max_num_steps
    )

    r0 = r0_raw / jnp.sqrt(state.inv_mass)
    if freea is not None:
        r0 = r0 * freea
    kin0 = 0.5 * jnp.sum(r0 * (state.inv_mass * r0), axis=1)
    energy0 = -state.logps + kin0

    def one(s: IntegratorState) -> IntegratorState:
        r = s.momentum + 0.5 * state.step_size * s.grad
        q = s.position + state.step_size * state.inv_mass * r
        if freea is not None:
            q = jnp.where(freea > 0, q, s.position)
        lp, g = jax.vmap(vg)(q)
        r = r + 0.5 * state.step_size * g
        return IntegratorState(q, r, lp, g)

    integ = IntegratorState(state.positions, r0, state.logps, state.grads)
    integ = jax.lax.fori_loop(0, n_steps, lambda _, s: one(s), integ)

    kin1 = 0.5 * jnp.sum(integ.momentum * (state.inv_mass * integ.momentum), axis=1)
    energy1 = -integ.logp + kin1
    delta = energy1 - energy0
    delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
    accept_probs = jnp.where(
        delta > divergence_threshold, 0.0, jnp.minimum(1.0, jnp.exp(-delta))
    )
    accept = u_acc < accept_probs
    acc = accept[:, None]
    positions = jnp.where(acc, integ.position, state.positions)
    logps = jnp.where(accept, integ.logp, state.logps)
    grads = jnp.where(acc, integ.grad, state.grads)

    # --- ChEES gradient on log T (Hoffman et al. 2021, eq. 8-9) ----------
    # centered squared-radius change, differentiated through the endpoint:
    # dDelta_i/dt = 2 (q'_i - mu') . v'_i  with v' = M^-1 r'.
    # Divergent chains carry +-inf endpoints; their accept weight is 0, but
    # 0 * inf = NaN and an inf endpoint poisons the cross-chain means — so
    # sanitize per chain first (a divergent chain contributes its start
    # point at weight 0, i.e. nothing).
    fin = (
        jnp.all(jnp.isfinite(integ.position), axis=1)
        & jnp.all(jnp.isfinite(integ.momentum), axis=1)
        & jnp.isfinite(delta)
    )
    q1 = jnp.where(fin[:, None], integ.position, state.positions)
    vel1 = jnp.where(fin[:, None], state.inv_mass * integ.momentum, 0.0)
    mu0 = _pmean(jnp.mean(state.positions, axis=0), axis_name)
    mu1 = _pmean(jnp.mean(q1, axis=0), axis_name)
    c0 = state.positions - mu0
    c1 = q1 - mu1
    delta_sq = jnp.sum(c1 * c1, axis=1) - jnp.sum(c0 * c0, axis=1)
    ddelta_dt = 2.0 * jnp.sum(c1 * vel1, axis=1)
    w = accept_probs * fin
    wsum = _pmean(jnp.mean(w), axis_name) + 1e-12
    # d ChEES / dt, importance-weighted by accept prob; chain rule through
    # t = u * exp(log T) contributes a factor t.
    g_t = _pmean(jnp.mean(w * delta_sq * ddelta_dt), axis_name) / wsum
    g_logt = g_t * t_real
    g_logt = jnp.where(jnp.isfinite(g_logt), g_logt, 0.0)
    upd, adam2 = _adam_update(state.adam, g_logt, traj_lr)
    do_adapt = jnp.asarray(adapt_traj)
    log_traj = jnp.where(do_adapt, state.log_traj + upd, state.log_traj)
    # keep T in [step, max_num_steps * step]: outside that band the jittered
    # step count would saturate and the gradient signal decouples from T
    log_traj = jnp.clip(
        log_traj,
        jnp.log(state.step_size),
        jnp.log(state.step_size * max_num_steps),
    )
    adam2 = jax.tree.map(
        lambda new, old: jnp.where(do_adapt, new, old), adam2, state.adam
    )

    return state._replace(
        positions=positions,
        logps=logps,
        grads=grads,
        accept_probs=accept_probs,
        log_traj=log_traj,
        adam=adam2,
        step=state.step + 1,
        rng=key,
    )


def _welford_update_population(
    w: adapt.WelfordState, X: Array, axis_name: str | tuple | None
) -> adapt.WelfordState:
    """Fold a whole (chains, dim) batch into the accumulator via the Chan
    merge — additive, so the cross-device combine is exact as well."""
    n = jnp.asarray(X.shape[0], X.dtype)
    if axis_name is not None:
        n = n * jax.lax.psum(jnp.ones((), X.dtype), axis_name)
    mean = _pmean(jnp.mean(X, axis=0), axis_name)
    m2 = _pmean(jnp.mean((X - mean) ** 2, axis=0), axis_name) * n
    return adapt.welford_combine(w, adapt.WelfordState(n, mean, m2))


def chees_warmup_step(
    state: ChEESState,
    update_mass: Array,
    window_end: Array,
    target_accept: float = 0.75,
    axis_name: str | tuple | None = None,
) -> ChEESState:
    """Shared-statistics warmup bookkeeping: one dual-averaging update from
    the population-mean accept, one batched Welford feed, window refresh."""
    mean_accept = _pmean(jnp.mean(state.accept_probs), axis_name)
    da = adapt.da_update(state.da, mean_accept, target=target_accept)
    step_size = jnp.exp(da.log_step)

    welford = jax.lax.cond(
        update_mass,
        lambda w: _welford_update_population(w, state.positions, axis_name),
        lambda w: w,
        state.welford,
    )

    def refresh(args):
        welford, da, inv_mass = args
        new_inv_mass = adapt.welford_variance(welford)
        new_inv_mass = jnp.where(welford.count > 1, new_inv_mass, inv_mass)
        fresh = adapt.welford_init(inv_mass.shape[0], inv_mass.dtype)
        da2 = adapt.da_init(jnp.exp(da.log_step))
        return fresh, da2, new_inv_mass

    welford, da, inv_mass = jax.lax.cond(
        window_end, refresh, lambda a: a, (welford, da, state.inv_mass)
    )
    return state._replace(step_size=step_size, da=da, welford=welford, inv_mass=inv_mass)


def chees_warm_chunk(
    logp: LogDensity,
    state: ChEESState,
    update_mass: Array,
    window_end: Array,
    max_num_steps: int = 256,
    target_accept: float = 0.75,
    traj_lr: float = 0.025,
    free: Array | None = None,
    axis_name: str | tuple | None = None,
    chain_offset: Array | int = 0,
) -> ChEESState:
    """One scan over a chunk of warmup transitions (chunked driving gives
    per-phase walltimes and bounds the length of one dispatch)."""

    def step(s, flags):
        um, we = flags
        s = chees_transition(
            logp,
            s,
            adapt_traj=True,
            max_num_steps=max_num_steps,
            traj_lr=traj_lr,
            free=free,
            axis_name=axis_name,
            chain_offset=chain_offset,
        )
        s = chees_warmup_step(s, um, we, target_accept, axis_name)
        return s, None

    state, _ = jax.lax.scan(step, state, (update_mass, window_end))
    return state


def chees_sample_chunk(
    logp: LogDensity,
    state: ChEESState,
    num: int,
    max_num_steps: int = 256,
    free: Array | None = None,
    axis_name: str | tuple | None = None,
    chain_offset: Array | int = 0,
) -> tuple[ChEESState, tuple[Array, Array, Array]]:
    """Scan ``num`` frozen-hyperparameter transitions; returns
    (positions (num, chains, dim), logps, accept_probs)."""

    def step(s, _):
        s = chees_transition(
            logp,
            s,
            adapt_traj=False,
            max_num_steps=max_num_steps,
            free=free,
            axis_name=axis_name,
            chain_offset=chain_offset,
        )
        return s, (s.positions, s.logps, s.accept_probs)

    return jax.lax.scan(step, state, None, length=num)


def finalize_chees_warmup(state: ChEESState) -> ChEESState:
    """Freeze the step size at the dual-averaging average iterate (the
    trajectory length stays at its adapted value; the halton jitter keeps
    running during sampling — it is part of the kernel, not the tuning)."""
    return state._replace(step_size=jnp.exp(state.da.log_step_avg))


def race_candidates(
    state: ChEESState, n: int, max_num_steps: int, lo_steps: float = 4.0
) -> Array:
    """(n,) candidate log-trajectory lengths: the adapted draw plus n-1
    log-spaced points spanning [lo_steps, max_num_steps] leapfrog steps at
    the frozen step size — an absolute bracket, deliberately NOT centered
    on the adapted draw (the draw itself is the noisy quantity being
    hedged: adapted trajectories vary severalfold across seeds)."""
    if n < 2:
        raise ValueError(f"racing needs >= 2 candidates (got {n})")
    eps = state.step_size
    lo = jnp.log(lo_steps * eps)
    hi = jnp.log(max_num_steps * eps)
    frac = jnp.arange(n - 1, dtype=eps.dtype) / jnp.maximum(n - 2, 1)
    grid = lo + (hi - lo) * frac
    return jnp.concatenate([state.log_traj[None], grid])


def chees_race(
    logp: LogDensity,
    state: ChEESState,
    n_candidates: int = 4,
    probe: int = 128,
    max_num_steps: int = 256,
    free: Array | None = None,
    lo_steps: float = 4.0,
    candidates: Array | None = None,
) -> tuple[ChEESState, dict]:
    """Post-warmup trajectory-length racing: selection instead of smoothing.

    ChEES's ESJD-proxy adaptation is noisy on multimodal GP posteriors —
    the adapted trajectory varies severalfold across seeds, and so does
    ESS/s, while EMA-smoothing the adaptation path regresses.  Where the
    device has idle throughput (a small posterior at 64 chains), racing
    spends it on the variance instead: replicate the warmed population once per
    candidate trajectory length, run all K populations lockstep for a
    short probe phase, score each by slow-dim normalized ESJD per leapfrog
    step (walltime on a lockstep chip is proportional to gradient
    evaluations), and hand the sampling budget to the argmax.

    The probe populations use the frozen kernel (no adaptation), distinct
    fold_in rngs, and identical halton jitter indices, so the per-
    candidate leapfrog cost is computed exactly from the shared jitter
    sequence rather than measured.

    Scoring: min over dims of (accept-realized ESJD_d / var_d), divided
    by leapfrog cost.  NOT probe-ESS-per-cost: a short probe cannot see
    autocorrelation beyond its own length, so probe-ESS saturates for
    every slow candidate and the cost denominator then hands the race to
    the cheapest (shortest) trajectory (the 4-step candidate wins and the
    sampling run fails the split-R-hat gate).  Normalized ESJD is a one-transition statistic (no truncation
    bias): the random-walk mixing time of the slowest coordinate is
    ~ var_d / ESJD_d transitions, so ESJD_d/var_d/cost estimates slow-
    coordinate crossings per gradient evaluation; it grows ~t^2 with
    trajectory time until the coherence length, then flattens — the
    argmax lands at the coherence length, which is the quantity ChEES's
    own noisy adaptation was trying to find.  The winner's probe-end
    state (probe extra transitions of mixing, gratis) seeds sampling.

    Returns (winner state, info) with info carrying the candidate log-
    trajectories, per-candidate normalized ESJD, probe min-ESS (for
    diagnostics only), leapfrog costs and scores.
    """
    if candidates is None:
        candidates = race_candidates(state, n_candidates, max_num_steps, lo_steps)
    candidates = jnp.asarray(candidates, state.log_traj.dtype)
    k = candidates.shape[0]

    def arm(log_t, i):
        s = state._replace(log_traj=log_t, rng=jax.random.fold_in(state.rng, i))
        s, (pos, _, _) = chees_sample_chunk(
            logp, s, probe, max_num_steps, free
        )
        return s, pos  # pos: (probe, chains, dim)

    raced, pos = jax.vmap(arm)(candidates, jnp.arange(k))

    # exact per-candidate leapfrog cost from the shared halton sequence
    # (every arm runs iteration indices state.step + 0..probe-1)
    u = jax.vmap(_halton2)(state.step + jnp.arange(probe)).astype(
        state.step_size.dtype
    )  # (probe,)
    t_real = jnp.maximum(u[None, :] * jnp.exp(candidates)[:, None], state.step_size)
    n_steps = jnp.clip(
        jnp.ceil(t_real / state.step_size).astype(jnp.int32), 1, max_num_steps
    )
    cost = jnp.sum(n_steps, axis=1).astype(pos.dtype)  # (k,)

    from gogp.infer import diagnostics

    # realized ESJD per dim (rejections contribute zero jumps naturally),
    # normalized by each dim's posterior variance estimated from the probe
    # draws pooled across all arms (shared, well-estimated, and candidate-
    # independent so it cannot bias the argmax)
    jumps = jnp.diff(pos, axis=1)  # (k, probe-1, chains, dim)
    esjd = jnp.mean(jumps * jumps, axis=(1, 2))  # (k, dim)
    var_d = jnp.var(pos.reshape(-1, pos.shape[-1]), axis=0) + 1e-12  # (dim,)
    ratio = esjd / var_d[None, :]
    if free is not None:
        # pinned dims never move: their 0/eps ratio would pin the min at
        # ~0 for every candidate and void the race
        ratio = jnp.where(jnp.asarray(free, ratio.dtype)[None, :] > 0,
                          ratio, jnp.inf)
    norm_esjd = jnp.min(ratio, axis=1)  # (k,) slowest FREE dim
    score = norm_esjd / cost

    # probe min-ESS per candidate (diagnostics only — probe-length ESS
    # saturates for slow candidates and must not drive the argmax)
    probe_ess = jax.vmap(
        lambda p: jnp.min(diagnostics.ess(jnp.moveaxis(p, 0, 1)))
    )(pos)
    win = jnp.argmax(score)
    state_win = jax.tree.map(lambda a: jnp.take(a, win, axis=0), raced)
    info = {
        "candidates_log_traj": candidates,
        "norm_esjd": norm_esjd,
        "probe_min_ess": probe_ess,
        "leapfrog_cost": cost,
        "score": score,
        "winner": win,
    }
    return state_win, info


def run_chees_pops(
    logp: LogDensity,
    positions0: Array,
    rng: Array,
    n_pops: int,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Array | None = None,
) -> Samples:
    """Independent replicated ChEES populations, batched on one chip.

    ChEES couples chains through its shared adaptation statistics, and the
    population size is a *quality* knob: on the hyperpriors posterior the
    shared trajectory adapts longer (better slow-coordinate mixing) at 64
    chains than at 256.  Throughput, though, can keep scaling past 64.  This decouples
    the two: split ``positions0`` (chains, dim) into ``n_pops`` populations
    of chains//n_pops, each adapting its own step size / trajectory / mass
    from its own cross-chain means, and batch all of them through one
    vmapped program.  Populations share nothing — per-population rng comes
    from ``fold_in(rng, pop_index)``, and the vmapped leapfrog while-loop
    runs every population to the longest population's trajectory, masking
    the extra steps out of the carry, so each population takes exactly the
    transitions ``n_pops`` separate :func:`run_chees` calls would (tested).
    Caveat shared with every chaotic MCMC program: batching changes XLA's
    fusion choices, and a last-bit difference in a log-density can flip a
    Metropolis decision and decorrelate trajectories from the unbatched
    run — the kernel and its stationary distribution are unchanged.

    Total ESS sums across populations (all chains target the same
    posterior), so at a fixed chain budget this trades nothing away: same
    samples/s as one big population, per-population adaptation quality.
    It is also the zero-collective multi-chip layout — see
    ``parallel.run_chees_pops_sharded``.

    Returns Samples with positions (num_samples, chains, dim), chains
    grouped by population.
    """
    positions0 = jnp.atleast_2d(jnp.asarray(positions0))
    chains, dim = positions0.shape
    if chains % n_pops != 0:
        raise ValueError(f"{chains} chains not divisible by {n_pops} populations")
    per = chains // n_pops
    pos = positions0.reshape(n_pops, per, dim)
    keys = jax.vmap(lambda i: jax.random.fold_in(jnp.asarray(rng), i))(
        jnp.arange(n_pops)
    )
    sched = adapt.build_schedule(num_warmup)

    def one_pop(pos_p, key_p):
        state = chees_init(
            logp, pos_p, key_p, init_step_size, init_traj_length, free
        )
        if num_warmup > 0:
            state = chees_warm_chunk(
                logp,
                state,
                sched.update_mass,
                sched.window_end,
                max_num_steps,
                target_accept,
                traj_lr,
                free,
            )
            state = finalize_chees_warmup(state)
        return chees_sample_chunk(logp, state, num_samples, max_num_steps, free)

    state, (positions, logps, accepts) = jax.vmap(one_pop)(pos, keys)
    # (P, S, per, dim) -> (S, P*per, dim), chains grouped by population
    positions = jnp.moveaxis(positions, 0, 1).reshape(num_samples, chains, dim)
    logps = jnp.moveaxis(logps, 0, 1).reshape(num_samples, chains)
    accepts = jnp.moveaxis(accepts, 0, 1).reshape(num_samples, chains)
    return Samples(positions, logps, accepts, state)


def run_chees(
    logp: LogDensity,
    positions0: Array,
    rng: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Array | None = None,
    axis_name: str | tuple | None = None,
    chain_offset: Array | int = 0,
    race: int = 0,
    race_probe: int = 128,
) -> Samples:
    """Warmup + sampling as two compiled scans over the whole population.

    ``positions0``: (chains, dim) — the chain axis lives inside the state
    (adaptation couples chains), so do NOT vmap this function over chains.
    Returned positions are (num_samples, chains, dim).

    ``race > 0`` inserts a :func:`chees_race` selection phase between
    warmup and sampling: ``race`` candidate trajectory lengths probed for
    ``race_probe`` transitions each, sampling budget to the argmax (only
    on the single-device path — racing replicates the population, which a
    sharded caller should lay out itself).
    """
    state = chees_init(logp, positions0, rng, init_step_size, init_traj_length, free)
    sched = adapt.build_schedule(num_warmup)
    if num_warmup > 0:
        state = chees_warm_chunk(
            logp,
            state,
            sched.update_mass,
            sched.window_end,
            max_num_steps,
            target_accept,
            traj_lr,
            free,
            axis_name,
            chain_offset,
        )
        state = finalize_chees_warmup(state)
    if race > 0:
        if axis_name is not None:
            raise ValueError("race is a single-device feature; shard the race axis explicitly")
        state, _ = chees_race(
            logp, state, race, race_probe, max_num_steps, free
        )
    state, (positions, logps, accepts) = chees_sample_chunk(
        logp, state, num_samples, max_num_steps, free, axis_name, chain_offset
    )
    return Samples(positions, logps, accepts, state)
