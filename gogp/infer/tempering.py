"""Parallel tempering: replica ladder + non-reversible (DEO) swaps.

The hyperpriors posterior is multimodal in its period/noise hyperparameters,
which caps plain NUTS's cross-chain ESS regardless of chain count (chains
stuck in different modes inflate between-chain variance forever).  Parallel
tempering runs a ladder of replicas targeting ``beta_k * logp`` and lets
states flow between temperatures, so the hot replicas carry mode-hopping
moves down to beta = 1.

Design:

- geometric ladder ``betas[0] = 1 > ... > betas[K-1] = beta_min``;
- each replica is an independent NUTS/HMC chain with its OWN step-size /
  mass adaptation (vmapped — one batched transition per sweep);
- swaps use the deterministic even-odd (DEO) scheme of Okabe et al. /
  Syed et al. (2019): even sweeps propose pairs (0,1)(2,3)..., odd sweeps
  (1,2)(3,4)... — the non-reversible schedule with provably better round
  trips than random pairing;
- a swap exchanges *positions* between adjacent temperatures; the cached
  log-density and gradient are TEMPERED values, so they transfer with a
  linear rescale (beta_i/beta_j) — no re-evaluation;
- acceptance: log A = (beta_i - beta_j) (raw_j - raw_i) with
  raw = tempered_logp / beta.

Everything jits; the replica axis is also the natural shard_map axis for
multi-chip ladders (swap statistics are O(K) scalars).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt
from gogp.infer.hmc import (
    HMCState,
    finalize_warmup,
    init_state,
    warmup_step,
)
from gogp.infer.nuts import nuts_transition

Array = jax.Array
LogDensity = Callable[[Array], Array]


def geometric_ladder(n_replicas: int, beta_min: float = 0.1, dtype=jnp.float32) -> Array:
    """betas[0]=1 down to betas[-1]=beta_min, geometric spacing."""
    if n_replicas == 1:
        return jnp.ones((1,), dtype)
    return jnp.asarray(
        beta_min ** (jnp.arange(n_replicas, dtype=dtype) / (n_replicas - 1)), dtype
    )


def swap_decision(betas: Array, raw_logp: Array, key: Array, parity: Array):
    """DEO swap decisions for one sweep — pure function of the ladder state.

    Returns ``(src, pair_probs, proposed, swap_frac)`` where ``src[k]`` is
    the replica whose position slot k receives, ``pair_probs[i]`` is the
    acceptance probability min(1, e^delta) of adjacent pair (i, i+1) (zero
    when not proposed this sweep), and ``proposed[i]`` marks the pairs
    proposed under this sweep's parity.  Factored out so the distributed
    ladder (parallel.sample.run_pt_distributed) can apply the identical
    decision to gathered replica state.
    """
    K = betas.shape[0]
    idx = jnp.arange(K)
    # partner of replica k under this sweep's parity (identity at the ends)
    is_left = (idx % 2) == parity % 2
    partner = jnp.where(is_left, idx + 1, idx - 1)
    partner = jnp.clip(partner, 0, K - 1)
    valid = partner != idx

    delta = (betas - betas[partner]) * (raw_logp[partner] - raw_logp)
    u = jax.random.uniform(key, (K,), dtype=raw_logp.dtype)
    # one uniform per PAIR: both members must use the left member's draw
    left_idx = jnp.minimum(idx, partner)
    accept = valid & (jnp.log(u[left_idx]) < delta)

    src = jnp.where(accept, partner, idx)
    swap_frac = jnp.sum(accept.astype(raw_logp.dtype)) / jnp.maximum(
        jnp.sum(valid.astype(raw_logp.dtype)), 1.0
    )

    # per adjacent pair (i, i+1): proposed iff i is a left member this sweep
    pair_idx = idx[:-1]
    proposed = (pair_idx % 2) == parity % 2
    pair_delta = (betas[:-1] - betas[1:]) * (raw_logp[1:] - raw_logp[:-1])
    pair_probs = jnp.where(
        proposed, jnp.minimum(1.0, jnp.exp(pair_delta)), 0.0
    )
    return src, pair_probs, proposed, swap_frac


def place_rungs(betas: Array, rej_mean: Array, n_new: int) -> Array:
    """Place ``n_new`` rungs at equal increments of the cumulative
    communication barrier estimated on the grid ``betas`` (Syed et al.
    2019, §5.2).  ``rej_mean``: (K-1,) mean rejection of each adjacent
    pair — the Rao-Blackwellized barrier-increment estimate.  Endpoints
    (betas[0], betas[-1]) stay pinned.
    """
    K = betas.shape[0]
    # strictly increasing cumulative barrier (epsilon keeps interp stable
    # when stretches of the ladder reject never)
    lam = jnp.concatenate([jnp.zeros((1,), betas.dtype), jnp.cumsum(rej_mean)])
    lam = lam + jnp.arange(K, dtype=betas.dtype) * 1e-6
    targets = jnp.linspace(lam[0], lam[-1], n_new).astype(betas.dtype)
    new = jnp.interp(targets, lam, betas)
    new = new.at[0].set(betas[0]).at[-1].set(betas[-1])
    return new


def adapt_ladder_betas(betas: Array, rej_sum: Array, prop_count: Array) -> Array:
    """Round-trip-optimal ladder update (Syed et al. 2019, §5.2).

    The expected rejection rate r_i of adjacent pair i estimates the
    communication-barrier increment Lambda(beta_i) - Lambda(beta_{i+1});
    round trips are maximized when every pair rejects equally, i.e. when
    the ladder places the K rungs at equal increments of the cumulative
    barrier.  Piecewise-linear inversion of the empirical barrier on the
    current grid; endpoints (beta=1, beta_min) stay pinned.
    """
    r = rej_sum / jnp.maximum(prop_count, 1.0)  # (K-1,) mean rejection
    return place_rungs(betas, r, betas.shape[0])


def _swap_sweep(states: HMCState, betas: Array, raw_logp: Array, key: Array, parity: Array):
    """One DEO swap sweep over adjacent pairs of the ladder.

    ``states``: replica-stacked HMCState; ``raw_logp``: (K,) untempered
    log-density of each replica's position.  Returns swapped states/raws,
    the sweep's accepted-swap fraction, and the per-pair statistics for
    ladder adaptation.
    """
    src, pair_probs, proposed, swap_frac = swap_decision(
        betas, raw_logp, key, parity
    )
    # positions, raw values and gradients travel; tempered caches rescale
    new_pos = states.position[src]
    new_raw = raw_logp[src]
    raw_grad = states.grad / betas[:, None]  # grad of raw logp
    new_grad = raw_grad[src] * betas[:, None]
    new_logp = new_raw * betas
    new_states = states._replace(position=new_pos, logp=new_logp, grad=new_grad)
    return new_states, new_raw, swap_frac, pair_probs, proposed


class PTFlow(NamedTuple):
    """Replica-flow and pair statistics threaded across sampling chunks."""

    labels: Array  # (K,) int32: +1 travelling up (hot->cold), -1 down
    trips: Array  # () int32: completed beta_min -> 1 round trips
    rej_sum: Array  # (K-1,) summed expected rejection of adjacent pairs
    prop_count: Array  # (K-1,) number of times each pair was proposed


def init_flow(n_replicas: int, dtype=jnp.float32) -> PTFlow:
    return PTFlow(
        labels=jnp.zeros((n_replicas,), jnp.int32),
        trips=jnp.zeros((), jnp.int32),
        rej_sum=jnp.zeros((n_replicas - 1,), dtype),
        prop_count=jnp.zeros((n_replicas - 1,), dtype),
    )


class PTResult(NamedTuple):
    positions: Array  # (num_samples, dim) — the beta=1 replica
    logps: Array  # (num_samples,) raw log-density at beta=1
    swap_rate: Array  # () mean DEO acceptance over sampling
    state: HMCState  # final replica-stacked state
    betas: Array
    # round trips completed during sampling (a state travelling
    # beta_min -> 1 counted at the cold end; Syed et al. flow diagnostic:
    # cold-chain ESS cannot exceed ~2x the round-trip count, so this says
    # whether mixing is ladder-limited).  None when not tracked.
    round_trips: Array | None = None
    # estimated total communication barrier Lambda = sum of per-pair mean
    # rejections over sampling; K ~ 2*Lambda replicas is the Syed et al.
    # efficient-ladder depth (see tune_ladder).  None when not tracked.
    barrier: Array | None = None
    # (K-1,) per-pair mean rejection over sampling (the barrier's
    # increments on this run's ladder).  None when not tracked.
    pair_rej: Array | None = None


def pt_init(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    betas: Array,
    init_step_size: float = 0.1,
    free: Array | None = None,
):
    """Replica-stacked initial state + loop key for chunked driving."""
    position0 = jnp.asarray(position0)
    n_replicas = betas.shape[0]
    if position0.ndim == 1:
        position0 = jnp.broadcast_to(position0, (n_replicas,) + position0.shape)
    key, key_init = jax.random.split(jnp.asarray(rng))
    init_keys = jax.random.split(key_init, n_replicas)

    def init_one(q, k, beta):
        return init_state(lambda v: beta * logp(v), q, k, init_step_size, free)

    return jax.vmap(init_one)(position0, init_keys, betas), key


def _make_steps(logp, max_tree_depth, target_accept, free, adapt_ladder):
    def transition(state, beta):
        return nuts_transition(lambda v: beta * logp(v), state, max_tree_depth, free)

    def warm_step(carry, inp):
        states, key, betas, rej_sum, prop_count = carry
        key, k_swap = jax.random.split(key)
        states = jax.vmap(transition)(states, betas)
        states = jax.vmap(
            lambda s: warmup_step(s, inp["um"], inp["we"], target_accept)
        )(states)
        raw = states.logp / betas
        states, raw, _, pair_probs, proposed = _swap_sweep(
            states, betas, raw, k_swap, inp["t"] % 2
        )
        rej_sum = rej_sum + jnp.where(proposed, 1.0 - pair_probs, 0.0)
        prop_count = prop_count + proposed.astype(rej_sum.dtype)

        if adapt_ladder:
            # at each adaptation-window end, re-place the rungs at equal
            # increments of the estimated communication barrier and
            # re-temper the cached log-density/gradient (raw values are
            # beta-free; step-size/mass stay with the temperature slot)
            def update(args):
                betas, rej_sum, prop_count, states = args
                new_betas = adapt_ladder_betas(betas, rej_sum, prop_count)
                raw_grad = states.grad / betas[:, None]
                states = states._replace(
                    logp=raw * new_betas,
                    grad=raw_grad * new_betas[:, None],
                )
                return (
                    new_betas,
                    jnp.zeros_like(rej_sum),
                    jnp.zeros_like(prop_count),
                    states,
                )

            betas, rej_sum, prop_count, states = jax.lax.cond(
                inp["we"], update, lambda a: a, (betas, rej_sum, prop_count, states)
            )
        return (states, key, betas, rej_sum, prop_count), None

    def sample_step(carry, inp):
        states, key, betas, flow = carry
        key, k_swap = jax.random.split(key)
        states = jax.vmap(transition)(states, betas)
        raw = states.logp / betas
        src, pair_probs, proposed, swap_frac = swap_decision(
            betas, raw, k_swap, inp["t"] % 2
        )
        new_pos = states.position[src]
        new_raw = raw[src]
        raw_grad = states.grad / betas[:, None]
        states = states._replace(
            position=new_pos,
            logp=new_raw * betas,
            grad=raw_grad[src] * betas[:, None],
        )
        # replica-flow labels travel with the states: +1 after visiting the
        # hottest rung, -1 after the coldest; an up-labelled state reaching
        # the cold end completes one round trip
        labels = flow.labels[src]
        K = betas.shape[0]
        trips = flow.trips + (labels[0] > 0).astype(flow.trips.dtype)
        labels = labels.at[0].set(-1).at[K - 1].set(1)
        flow = PTFlow(
            labels=labels,
            trips=trips,
            # Rao-Blackwellized barrier increments: expected (not realized)
            # rejection of each proposed adjacent pair
            rej_sum=flow.rej_sum + jnp.where(proposed, 1.0 - pair_probs, 0.0),
            prop_count=flow.prop_count + proposed.astype(flow.prop_count.dtype),
        )
        return (states, key, betas, flow), (new_pos[0], new_raw[0], swap_frac)

    return warm_step, sample_step


def pt_warm_chunk(
    logp, states, key, betas, um, we, t0,
    max_tree_depth: int = 6, target_accept: float = 0.8, free=None,
    adapt_ladder: bool = True,
):
    """Run len(um) warmup sweeps (transition + adapt + swap + ladder
    adaptation).  Returns the (possibly re-placed) ladder alongside the
    states.  Chunk-callable: benchmarks drive warmup as a sequence of
    fixed-size chunks (same pattern as benchmarks/ess_nuts.py for plain
    NUTS)."""
    warm_step, _ = _make_steps(logp, max_tree_depth, target_accept, free, adapt_ladder)
    ts = t0 + jnp.arange(um.shape[0])
    zeros = jnp.zeros((betas.shape[0] - 1,), betas.dtype)
    (states, key, betas, _, _), _ = jax.lax.scan(
        warm_step, (states, key, betas, zeros, zeros), {"um": um, "we": we, "t": ts}
    )
    return states, key, betas


def pt_sample_chunk(
    logp, states, key, betas, num: int, t0,
    max_tree_depth: int = 6, free=None, flow: PTFlow | None = None,
):
    """Run ``num`` sampling sweeps; returns cold-chain draws of the chunk.

    ``flow`` (optional) threads the replica-flow round-trip counter and
    the pair rejection statistics across chunks; a fresh :class:`PTFlow`
    is created when omitted.
    Returns ``(states, key, positions, raws, swap_fracs, flow)``.
    """
    _, sample_step = _make_steps(logp, max_tree_depth, 0.8, free, False)
    ts = t0 + jnp.arange(num)
    if flow is None:
        flow = init_flow(betas.shape[0], betas.dtype)
    (states, key, _, flow), (positions, raws, swap_fracs) = jax.lax.scan(
        sample_step, (states, key, betas, flow), {"t": ts}
    )
    return states, key, positions, raws, swap_fracs, flow


def run_pt_nuts(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    n_replicas: int = 8,
    beta_min: float = 0.1,
    betas: Array | None = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Array | None = None,
    adapt_ladder: bool = True,
) -> PTResult:
    """Parallel-tempered NUTS; returns the cold-chain (beta=1) draws.

    ``position0``: (dim,) shared init, or (n_replicas, dim) per replica.
    ``adapt_ladder``: re-place the rungs at equal increments of the
    estimated communication barrier at every warmup window end (Syed et
    al. 2019); the endpoints (1, beta_min) stay pinned.  The final ladder
    is returned in ``PTResult.betas``.
    """
    position0 = jnp.asarray(position0)
    dtype = position0.dtype
    if betas is None:
        betas = geometric_ladder(n_replicas, beta_min, dtype)
    else:
        betas = jnp.asarray(betas, dtype)
        n_replicas = betas.shape[0]

    states, key = pt_init(logp, position0, rng, betas, init_step_size, free)
    sched = adapt.build_schedule(num_warmup)

    if num_warmup > 0:
        states, key, betas = pt_warm_chunk(
            logp, states, key, betas, sched.update_mass, sched.window_end,
            jnp.asarray(0), max_tree_depth, target_accept, free, adapt_ladder,
        )
        states = jax.vmap(finalize_warmup)(states)

    states, key, positions, raws, swap_fracs, flow = pt_sample_chunk(
        logp, states, key, betas, num_samples, jnp.asarray(num_warmup),
        max_tree_depth, free,
    )
    pair_rej = flow.rej_sum / jnp.maximum(flow.prop_count, 1.0)
    return PTResult(
        positions, raws, jnp.mean(swap_fracs), states, betas, flow.trips,
        jnp.sum(pair_rej), pair_rej,
    )


def tune_ladder(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    beta_min: float = 0.1,
    pilot_replicas: int = 8,
    pilot_warmup: int = 256,
    pilot_samples: int = 128,
    growth: float = 2.0,
    max_replicas: int = 64,
    max_tree_depth: int = 6,
    free: Array | None = None,
) -> tuple[Array, PTResult]:
    """Auto-tune the ladder DEPTH from a pilot run (Syed et al. 2019).

    Runs a ``pilot_replicas``-rung pilot (with within-run rung placement),
    estimates the total communication barrier Lambda from the pilot's
    Rao-Blackwellized pair rejections, sets

        K* = clip(ceil(1 + growth * Lambda), 2, max_replicas)

    (``growth=2`` is the paper's efficient regime: per-pair rejection
    ~Lambda/(K-1) <= 1/2 keeps the round-trip rate within a constant of
    its K -> infinity limit), and places the K* rungs at equal barrier
    increments on the pilot grid.  Returns ``(betas_star, pilot_result)``
    — pass ``betas_star`` to :func:`run_pt_nuts` (or the distributed
    runner) as ``betas``.

    Round trips, not sweeps, bound cold-chain ESS (PTResult.round_trips);
    when a run measures ESS ~= 2x round trips, deepening the ladder via
    this tuner is the scaling lever.
    """
    pilot = run_pt_nuts(
        logp, position0, rng,
        n_replicas=pilot_replicas, beta_min=beta_min,
        num_warmup=pilot_warmup, num_samples=pilot_samples,
        max_tree_depth=max_tree_depth, free=free, adapt_ladder=True,
    )
    barrier = float(pilot.barrier)
    n_star = min(max(math.ceil(1.0 + growth * barrier), 2), max_replicas)
    betas_star = place_rungs(pilot.betas, pilot.pair_rej, n_star)
    return betas_star, pilot
