"""Parallel tempering with ChEES-HMC rung populations.

PT cold-chain ESS is round-trip capped (Syed et al.: min-ESS ~= 2x round
trips), so the ESS/s lever is cheaper *sweeps* — and the sweep cost is the
mutation kernel.  ChEES-HMC transitions are cheaper than lockstep vmapped
NUTS (no per-chain tree depth; see
infer/chees.py), but ChEES needs a *population* per target density.  PT
supplies one for free: run L independent ladders, and the L chains sitting
at rung k all target ``beta_k * logp`` — a valid ChEES population.  Each
rung owns a shared step size / trajectory length / mass matrix adapted from
its cross-ladder population; DEO swaps act within each ladder, exchanging
states between adjacent rungs.

Layout: every ChEESState leaf gains a leading rung axis K; chain axes hold
the L ladders.  Rung transitions are ``vmap(chees_transition)`` over K
(each rung's traced ``n_steps`` differs — batching lowers the leapfrog
fori_loop to a masked while, so rungs run lockstep to the longest rung's
trajectory, the cross-rung analogue of the deepest-tree cost but over K ~ 8
rungs, not the whole chain population).  Swap sweeps are
``vmap(swap_decision)`` over L.

The reference has no inference layer (SURVEY.md §4 — tutorial/tutorial.go
delegates to Infergo); this composes the round-2 north-star pieces.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt
from gogp.infer.chees import (
    ChEESState,
    chees_init,
    chees_transition,
    chees_warmup_step,
    finalize_chees_warmup,
)
from gogp.infer.tempering import (
    PTFlow,
    adapt_ladder_betas,
    geometric_ladder,
    init_flow,
    swap_decision,
)

Array = jax.Array
LogDensity = Callable[[Array], Array]


class PTChEESResult(NamedTuple):
    positions: Array  # (num_samples, L, dim) cold-chain draws, all ladders
    logps: Array  # (num_samples, L) raw log-density at beta=1
    swap_rate: Array  # () mean DEO acceptance over sampling
    state: ChEESState  # final rung-stacked state (leading axis K)
    betas: Array  # (K,) final ladder
    round_trips: Array  # () completed beta_min -> 1 trips, summed over ladders
    barrier: Array  # () estimated total communication barrier Lambda
    pair_rej: Array  # (K-1,) per-pair mean rejection over sampling


def pt_chees_init(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    betas: Array,
    n_ladders: int,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    free: Array | None = None,
) -> ChEESState:
    """Rung-stacked ChEES state: positions (K, L, dim).

    ``position0``: (dim,) shared init or (L, dim) per ladder; every rung
    starts from the same ladder positions.
    """
    position0 = jnp.atleast_2d(jnp.asarray(position0))  # (L?, dim)
    if position0.shape[0] == 1 and n_ladders > 1:
        position0 = jnp.broadcast_to(
            position0, (n_ladders, position0.shape[-1])
        )
    K = betas.shape[0]
    keys = jax.random.split(jnp.asarray(rng), K)

    def init_rung(k, beta):
        return chees_init(
            lambda v: beta * logp(v), position0, k,
            init_step_size, init_traj_length, free,
        )

    return jax.vmap(init_rung)(keys, betas)


def _rung_transition(logp, max_num_steps, traj_lr, free, axis_name, ladder_offset):
    """vmap-over-rungs ChEES transition; beta enters as a traced closure.

    ``axis_name``/``ladder_offset``: when the ladder population is sharded
    over mapped device axes, each rung's cross-ladder adaptation statistics
    pmean over them and per-chain randomness keys off the GLOBAL ladder
    index (the device-count-invariance contract of infer/chees.py).
    """

    def one(state, beta, adapt_traj):
        return chees_transition(
            lambda v: beta * logp(v),
            state,
            adapt_traj=adapt_traj,
            max_num_steps=max_num_steps,
            traj_lr=traj_lr,
            free=free,
            axis_name=axis_name,
            chain_offset=ladder_offset,
        )

    return one


def _pt_chees_swap(
    states: ChEESState,
    betas: Array,
    key: Array,
    parity: Array,
    axis_name=None,
    ladder_offset: Array | int = 0,
    n_ladders_global: int | None = None,
):
    """One DEO sweep across every (local) ladder.

    ``states``: rung-stacked (leading K, chain axis L).  Position / raw
    logp / raw grad travel between rungs within each ladder; tempered
    caches rescale by the destination beta.  Shared per-rung adaptation
    state (step size, mass, trajectory, accept_probs feeding the rung's
    dual averaging) stays with the temperature slot, exactly like the
    HMC-PT swap (tempering.py:_swap_sweep).

    Sharded ladders: swaps act within a ladder, so they stay device-local;
    only the PAIR STATISTICS (which drive the shared beta-ladder
    adaptation) are pmean'd, and per-ladder keys come from the global
    ladder index so draws match the single-device run.
    """
    K, L = states.logps.shape
    raw = states.logps / betas[:, None]  # (K, L)
    if n_ladders_global is None:
        keys = jax.random.split(key, L)
    else:
        all_keys = jax.random.split(key, n_ladders_global)
        keys = jax.lax.dynamic_slice_in_dim(
            all_keys, jnp.asarray(ladder_offset), L, axis=0
        )

    # per-ladder decisions: vmap over the L axis
    src, pair_probs, proposed, frac = jax.vmap(
        lambda r, k: swap_decision(betas, r, k, parity),
        in_axes=(1, 0),
        out_axes=(1, 0, 0, 0),
    )(raw, keys)
    # src: (K, L) source rung for each ladder's slot k

    ladder = jnp.arange(L)[None, :]
    new_pos = states.positions[src, ladder]  # (K, L, dim)
    new_raw = raw[src, ladder]  # (K, L)
    raw_grad = states.grads / betas[:, None, None]
    new_grad = raw_grad[src, ladder] * betas[:, None, None]
    states = states._replace(
        positions=new_pos,
        logps=new_raw * betas[:, None],
        grads=new_grad,
    )
    # pair stats averaged over ALL ladders (pmean over device axes when
    # sharded) -> one shared ladder's estimates, identical on every device
    pair_rej = jnp.mean(jnp.where(proposed, 1.0 - pair_probs, 0.0), axis=0)
    frac_mean = jnp.mean(frac)
    if axis_name is not None:
        pair_rej = jax.lax.pmean(pair_rej, axis_name)
        frac_mean = jax.lax.pmean(frac_mean, axis_name)
    prop = proposed[0].astype(raw.dtype)  # same parity pattern every ladder
    return states, src, pair_rej, prop, frac_mean


def _flow_update(flow: PTFlow, src: Array) -> PTFlow:
    """Replica-flow labels per ladder (leaves carry a leading L axis)."""
    K = src.shape[0]

    def one(labels, trips, src_l):
        labels = labels[src_l]
        trips = trips + (labels[0] > 0).astype(trips.dtype)
        labels = labels.at[0].set(-1).at[K - 1].set(1)
        return labels, trips

    labels, trips = jax.vmap(one)(flow.labels, flow.trips, src.T)
    return flow._replace(labels=labels, trips=trips)


def _make_steps(
    logp, max_num_steps, traj_lr, target_accept, free, adapt_ladder,
    axis_name=None, ladder_offset=0, n_ladders_global=None,
):
    transition = _rung_transition(
        logp, max_num_steps, traj_lr, free, axis_name, ladder_offset
    )

    def warm_step(carry, inp):
        states, key, betas, rej_sum, prop_count = carry
        key, k_swap = jax.random.split(key)
        states = jax.vmap(transition, in_axes=(0, 0, None))(states, betas, True)
        states = jax.vmap(
            lambda s: chees_warmup_step(
                s, inp["um"], inp["we"], target_accept, axis_name
            )
        )(states)
        states, _, pair_rej, prop, _ = _pt_chees_swap(
            states, betas, k_swap, inp["t"] % 2,
            axis_name, ladder_offset, n_ladders_global,
        )
        rej_sum = rej_sum + pair_rej
        prop_count = prop_count + prop

        if adapt_ladder:

            def update(args):
                betas, rej_sum, prop_count, states = args
                new_betas = adapt_ladder_betas(betas, rej_sum, prop_count)
                raw = states.logps / betas[:, None]
                raw_grad = states.grads / betas[:, None, None]
                states = states._replace(
                    logps=raw * new_betas[:, None],
                    grads=raw_grad * new_betas[:, None, None],
                )
                return (
                    new_betas,
                    jnp.zeros_like(rej_sum),
                    jnp.zeros_like(prop_count),
                    states,
                )

            betas, rej_sum, prop_count, states = jax.lax.cond(
                inp["we"], update, lambda a: a,
                (betas, rej_sum, prop_count, states),
            )
        return (states, key, betas, rej_sum, prop_count), None

    def sample_step(carry, inp):
        states, key, betas, flow = carry
        key, k_swap = jax.random.split(key)
        states = jax.vmap(transition, in_axes=(0, 0, None))(states, betas, False)
        states, src, pair_rej, prop, frac = _pt_chees_swap(
            states, betas, k_swap, inp["t"] % 2,
            axis_name, ladder_offset, n_ladders_global,
        )
        flow = _flow_update(flow, src)
        flow = flow._replace(
            rej_sum=flow.rej_sum + pair_rej, prop_count=flow.prop_count + prop
        )
        cold_raw = states.logps[0] / betas[0]
        return (states, key, betas, flow), (states.positions[0], cold_raw, frac)

    return warm_step, sample_step


def pt_chees_warm_chunk(
    logp, states, key, betas, um, we, t0,
    max_num_steps: int = 256, target_accept: float = 0.75,
    traj_lr: float = 0.025, free=None, adapt_ladder: bool = True,
    axis_name=None, ladder_offset=0, n_ladders_global=None,
):
    """len(um) warmup sweeps, chunk-callable."""
    warm_step, _ = _make_steps(
        logp, max_num_steps, traj_lr, target_accept, free, adapt_ladder,
        axis_name, ladder_offset, n_ladders_global,
    )
    ts = t0 + jnp.arange(um.shape[0])
    zeros = jnp.zeros((betas.shape[0] - 1,), betas.dtype)
    (states, key, betas, _, _), _ = jax.lax.scan(
        warm_step, (states, key, betas, zeros, zeros), {"um": um, "we": we, "t": ts}
    )
    return states, key, betas


def pt_chees_sample_chunk(
    logp, states, key, betas, num: int, t0,
    max_num_steps: int = 256, free=None, flow: PTFlow | None = None,
    axis_name=None, ladder_offset=0, n_ladders_global=None,
):
    """``num`` sampling sweeps; returns all-ladder cold-chain draws.

    Returns ``(states, key, positions (num, L, dim), raws, swap_fracs,
    flow)``; ``flow`` leaves carry a leading L (per-ladder) axis.
    """
    _, sample_step = _make_steps(
        logp, max_num_steps, 0.025, 0.75, free, False,
        axis_name, ladder_offset, n_ladders_global,
    )
    ts = t0 + jnp.arange(num)
    if flow is None:
        flow = _init_flow_ladders(states.logps.shape[1], betas)
    (states, key, _, flow), (positions, raws, fracs) = jax.lax.scan(
        sample_step, (states, key, betas, flow), {"t": ts}
    )
    return states, key, positions, raws, fracs, flow


def _init_flow_ladders(n_ladders: int, betas: Array) -> PTFlow:
    K = betas.shape[0]
    one = init_flow(K, betas.dtype)
    return one._replace(
        labels=jnp.zeros((n_ladders, K), jnp.int32),
        trips=jnp.zeros((n_ladders,), jnp.int32),
    )


def run_pt_chees(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    n_ladders: int = 16,
    n_replicas: int = 8,
    beta_min: float = 0.1,
    betas: Array | None = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Array | None = None,
    adapt_ladder: bool = True,
) -> PTChEESResult:
    """Parallel-tempered ChEES-HMC over L ladders x K rungs.

    Returns cold-chain draws of every ladder: positions
    (num_samples, n_ladders, dim).  Per-rung kernels (step size, mass,
    trajectory) adapt from the cross-ladder population; the beta ladder
    (shared by all ladders) re-places its rungs at equal
    communication-barrier increments during warmup (Syed et al. 2019).
    """
    position0 = jnp.asarray(position0)
    dtype = position0.dtype
    if betas is None:
        betas = geometric_ladder(n_replicas, beta_min, dtype)
    else:
        betas = jnp.asarray(betas, dtype)
        n_replicas = betas.shape[0]

    key, key_init = jax.random.split(jnp.asarray(rng))
    states = pt_chees_init(
        logp, position0, key_init, betas, n_ladders,
        init_step_size, init_traj_length, free,
    )
    sched = adapt.build_schedule(num_warmup)

    if num_warmup > 0:
        states, key, betas = pt_chees_warm_chunk(
            logp, states, key, betas, sched.update_mass, sched.window_end,
            jnp.asarray(0), max_num_steps, target_accept, traj_lr, free,
            adapt_ladder,
        )
        states = jax.vmap(finalize_chees_warmup)(states)

    states, key, positions, raws, fracs, flow = pt_chees_sample_chunk(
        logp, states, key, betas, num_samples, jnp.asarray(num_warmup),
        max_num_steps, free,
    )
    pair_rej = flow.rej_sum / jnp.maximum(flow.prop_count, 1.0)
    return PTChEESResult(
        positions, raws, jnp.mean(fracs), states, betas,
        jnp.sum(flow.trips), jnp.sum(pair_rej), pair_rej,
    )
