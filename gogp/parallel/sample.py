"""Multi-chip MCMC: chains sharded over the device mesh, adaptation shared
through collectives.

This is the multi-device replacement for the reference's goroutine parallelism
(SURVEY.md §5 "distributed communication backend" — the reference has none):
chains are split across devices with ``shard_map``; every warmup step the
acceptance statistic is ``psum``-averaged into ONE dual-averaging step size,
and at each adaptation-window end the per-device Welford accumulators are
``psum``-combined into ONE shared mass matrix:

    total count  n   = psum(n_d)
    total mean   mu  = psum(n_d mu_d) / n
    total SS     m2  = psum(m2_d + n_d (mu_d - mu)^2)

so an N-device run adapts exactly like a single-device run over the full
chain population (device-count invariance is tested on the fake CPU mesh).
The per-step collective payload is O(dim) scalars.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gogp.infer import adapt
from gogp.infer.hmc import Samples, hmc_transition, init_state
from gogp.infer.nuts import nuts_transition
from gogp.parallel.mesh import CHAIN_AXIS, DATA_AXIS

Array = jax.Array
LogDensity = Callable[[Array], Array]


def _make_transition(kind: str, logp, free, **kw):
    if kind == "nuts":
        return lambda s: nuts_transition(
            logp, s, max_tree_depth=kw.get("max_tree_depth", 10), free=free
        )
    if kind == "hmc":
        return lambda s: hmc_transition(
            logp,
            s,
            trajectory_length=kw.get("trajectory_length", 1.0),
            max_num_steps=kw.get("max_num_steps", 1024),
            free=free,
        )
    raise ValueError(f"unknown sampler kind {kind!r}")


def run_mcmc_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    kind: str = "nuts",
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Array | None = None,
    **kw,
) -> Samples:
    """Run ``position0.shape[0]`` chains sharded over the mesh.

    Returns Samples with leading axes (chains, num_samples).  The chain count
    must divide by the mesh size (chain axis * data axis — both are used as
    one flat chain axis here; large-N data sharding composes separately).
    """
    position0 = jnp.asarray(position0)
    n_chains, dim = position0.shape
    axes = (CHAIN_AXIS, DATA_AXIS)
    n_dev = mesh.devices.size
    if n_chains % n_dev != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_dev} devices")

    keys = jax.random.split(jnp.asarray(rng), n_chains)
    sched = adapt.build_schedule(num_warmup)

    transition = _make_transition(kind, logp, free, **kw)
    total_chains = float(n_chains)

    def psum_all(x):
        return jax.lax.psum(jax.lax.psum(x, CHAIN_AXIS), DATA_AXIS)

    def device_fn(pos_local, keys_local):
        # per-chain states (local shard)
        states = jax.vmap(
            lambda q, k: init_state(logp, q, k, init_step_size, free)
        )(pos_local, keys_local)
        dtype = pos_local.dtype

        # shared (replicated) adaptation state
        da = adapt.da_init(jnp.asarray(init_step_size, dtype))
        welford = adapt.welford_init(dim, dtype)
        inv_mass = jnp.ones((dim,), dtype)

        def wstep(carry, flags):
            states, da, welford, inv_mass = carry
            um, we = flags
            step_size = jnp.exp(da.log_step)
            states = states._replace(
                step_size=jnp.broadcast_to(step_size, states.step_size.shape),
                inv_mass=jnp.broadcast_to(inv_mass, states.inv_mass.shape),
            )
            states = jax.vmap(transition)(states)

            # ONE step size from the psum-averaged accept statistic
            accept_mean = psum_all(jnp.sum(states.accept_prob)) / total_chains
            da = adapt.da_update(da, accept_mean, target=target_accept)

            # feed local chain positions into the local accumulator
            def feed(w):
                return jax.lax.fori_loop(
                    0,
                    states.position.shape[0],
                    lambda i, w: adapt.welford_update(w, states.position[i]),
                    w,
                )

            welford = jax.lax.cond(um, feed, lambda w: w, welford)

            def refresh(args):
                welford, da, inv_mass = args
                n = psum_all(welford.count)
                mu = psum_all(welford.count * welford.mean) / jnp.maximum(n, 1.0)
                d = welford.mean - mu
                m2 = psum_all(welford.m2 + welford.count * d * d)
                var = adapt.welford_variance(adapt.WelfordState(n, mu, m2))
                return (
                    adapt.welford_init(dim, dtype),
                    adapt.da_init(jnp.exp(da.log_step)),
                    jnp.where(n > 1, var, inv_mass),
                )

            welford, da, inv_mass = jax.lax.cond(
                we, refresh, lambda a: a, (welford, da, inv_mass)
            )
            return (states, da, welford, inv_mass), None

        if num_warmup > 0:
            (states, da, welford, inv_mass), _ = jax.lax.scan(
                wstep,
                (states, da, welford, inv_mass),
                (sched.update_mass, sched.window_end),
            )
            final_step = jnp.exp(da.log_step_avg)
            states = states._replace(
                step_size=jnp.broadcast_to(final_step, states.step_size.shape),
                inv_mass=jnp.broadcast_to(inv_mass, states.inv_mass.shape),
            )

        def sstep(states, _):
            states = jax.vmap(transition)(states)
            return states, (states.position, states.logp, states.accept_prob)

        states, (pos, lps, acc) = jax.lax.scan(
            sstep, states, None, length=num_samples
        )
        # (local_chains, num_samples, ...) ordering
        return (
            jnp.swapaxes(pos, 0, 1),
            jnp.swapaxes(lps, 0, 1),
            jnp.swapaxes(acc, 0, 1),
            states,
        )

    shard = P(axes)
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard, shard),
            out_specs=(shard, shard, shard, shard),
            # while_loop carries mix device-varying sampler state with
            # replicated adaptation scalars; skip the varying-axis type check
            check_vma=False,
        )
    )
    pos, lps, acc, states = fn(position0, keys)
    return Samples(pos, lps, acc, states)


run_nuts_sharded = functools.partial(run_mcmc_sharded, kind="nuts")
run_hmc_sharded = functools.partial(run_mcmc_sharded, kind="hmc")


def run_chees_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    init_traj_length: float = 1.0,
    target_accept: float = 0.75,
    max_num_steps: int = 256,
    traj_lr: float = 0.025,
    free: Array | None = None,
) -> Samples:
    """ChEES-HMC with the chain population sharded over the mesh.

    ChEES is the natural multi-device sampler: ALL of its adaptation
    signals (mean accept, position means for the criterion centering, the
    criterion gradient, the Welford mass moments) are plain cross-chain
    means, so the distributed form is the single-device form with every
    mean wrapped in a pmean over the device axes — infer.chees takes the
    axis names directly.  Per-chain randomness is fold_in(key, global
    chain index), so the draws match a single-device run chain-for-chain
    and results are device-count invariant up to float reduction order.

    Returns Samples with positions (num_samples, chains, dim), matching
    run_chees.
    """
    from gogp.infer.chees import (
        AdamState,
        ChEESState,
        chees_init,
        chees_sample_chunk,
        chees_warm_chunk,
        finalize_chees_warmup,
    )

    position0 = jnp.asarray(position0)
    n_chains, dim = position0.shape
    axes = (CHAIN_AXIS, DATA_AXIS)
    n_dev = mesh.devices.size
    if n_chains % n_dev != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_dev} devices")
    local = n_chains // n_dev
    sched = adapt.build_schedule(num_warmup)
    rng = jnp.asarray(rng)
    data_size = mesh.shape[DATA_AXIS]

    def device_fn(pos_local):
        dev = jax.lax.axis_index(CHAIN_AXIS) * data_size + jax.lax.axis_index(
            DATA_AXIS
        )
        offset = dev * local
        # same replicated key everywhere: shared scalars (step size, log T,
        # halton counter) evolve identically; per-chain draws differ only
        # through the global chain index
        state = chees_init(logp, pos_local, rng, init_step_size, init_traj_length, free)
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
                axes,
                offset,
            )
            state = finalize_chees_warmup(state)
        state, (pos, lps, acc) = chees_sample_chunk(
            logp, state, num_samples, max_num_steps, free, axes, offset
        )
        return pos, lps, acc, state

    shard = P(axes)
    draws = P(None, axes)  # (num_samples, chains, ...)
    repl = P()
    state_spec = ChEESState(
        positions=shard,
        logps=shard,
        grads=shard,
        step_size=repl,
        inv_mass=repl,
        log_traj=repl,
        accept_probs=shard,
        da=adapt.DualAveragingState(repl, repl, repl, repl, repl),
        adam=AdamState(repl, repl, repl),
        welford=adapt.WelfordState(repl, repl, repl),
        step=repl,
        rng=repl,
    )
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(draws, draws, draws, state_spec),
            # scan carries mix device-varying chain state with replicated
            # adaptation scalars; skip the varying-axis type check
            check_vma=False,
        )
    )
    pos, lps, acc, state = fn(position0)
    return Samples(pos, lps, acc, state)


def run_ghmc_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    num_warmup: int = 500,
    num_samples: int = 500,
    init_step_size: float = 0.1,
    free: Array | None = None,
) -> Samples:
    """Persistent-momentum GHMC with the chain population sharded.

    Like ChEES, every adaptation signal (mean accept for dual averaging,
    the cross-fold position moments for the preconditioner) is a
    cross-chain mean — the sharded form wraps them in pmeans over the
    device axes (infer.ghmc takes axis names directly).  Chains split
    into folds by GLOBAL index parity; each device's slab must therefore
    hold an even number of chains so local parity equals global parity
    and the per-fold pmean moments are exact.
    """
    from gogp.infer.ghmc import (
        GHMCState,
        finalize_ghmc_warmup,
        ghmc_init,
        ghmc_sample_chunk,
        ghmc_warm_chunk,
    )

    position0 = jnp.asarray(position0)
    n_chains, dim = position0.shape
    axes = (CHAIN_AXIS, DATA_AXIS)
    n_dev = mesh.devices.size
    if n_chains % n_dev != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_dev} devices")
    if n_chains < 4:
        raise ValueError(
            f"ghmc needs >= 4 chains globally (got {n_chains}): with fewer, "
            "each parity fold has a single chain and the cross-fold std "
            "degenerates to its floor"
        )
    local = n_chains // n_dev
    if local % 2 != 0:
        raise ValueError(
            f"ghmc sharding needs an even per-device chain count (got "
            f"{local}): folds split by global index parity"
        )
    rng = jnp.asarray(rng)
    data_size = mesh.shape[DATA_AXIS]

    def device_fn(pos_local):
        dev = jax.lax.axis_index(CHAIN_AXIS) * data_size + jax.lax.axis_index(
            DATA_AXIS
        )
        offset = dev * local
        state = ghmc_init(logp, pos_local, rng, init_step_size, chain_offset=offset)
        if num_warmup > 0:
            state = ghmc_warm_chunk(logp, state, num_warmup, free, axes, offset)
            state = finalize_ghmc_warmup(state)
        state, (pos, lps, acc) = ghmc_sample_chunk(
            logp, state, num_samples, free, axes, offset
        )
        return pos, lps, acc, state

    shard = P(axes)
    draws = P(None, axes)
    repl = P()
    state_spec = GHMCState(
        positions=shard,
        momenta=shard,
        logps=shard,
        grads=shard,
        step_size=repl,
        sigma=repl,
        accept_probs=shard,
        da=adapt.DualAveragingState(repl, repl, repl, repl, repl),
        step=repl,
        rng=repl,
    )
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(draws, draws, draws, state_spec),
            check_vma=False,
        )
    )
    pos, lps, acc, state = fn(position0)
    return Samples(pos, lps, acc, state)


def run_chees_pops_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
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
    """Independent ChEES populations sharded over the mesh — the
    zero-collective sampler layout.

    ``infer.run_chees_pops`` semantics (population size is an adaptation-
    quality knob; populations share nothing), with the population axis
    laid over the devices: each device runs ``n_pops // n_devices`` whole
    populations locally, so the compiled program contains NO collectives —
    adding chips multiplies populations at constant walltime (total ESS
    then grows only as fast as the posterior's cross-chain mixing allows).  Per-population rng is
    fold_in(rng, global pop index) and no cross-device reduction exists,
    so draws match the single-device run exactly up to XLA fusion
    differences between per-device batch sizes (device-count invariance
    tested).

    Returns Samples with positions (num_samples, chains, dim), chains
    grouped by population.
    """
    from gogp.infer.chees import (
        AdamState,
        ChEESState,
        chees_init,
        chees_sample_chunk,
        chees_warm_chunk,
        finalize_chees_warmup,
    )

    position0 = jnp.asarray(position0)
    n_chains, dim = position0.shape
    axes = (CHAIN_AXIS, DATA_AXIS)
    n_dev = mesh.devices.size
    if n_chains % n_pops != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_pops} populations")
    if n_pops % n_dev != 0:
        raise ValueError(f"{n_pops} populations not divisible by {n_dev} devices")
    per = n_chains // n_pops
    pops_local = n_pops // n_dev
    sched = adapt.build_schedule(num_warmup)
    rng = jnp.asarray(rng)
    data_size = mesh.shape[DATA_AXIS]

    def device_fn(pos_local):
        dev = jax.lax.axis_index(CHAIN_AXIS) * data_size + jax.lax.axis_index(
            DATA_AXIS
        )
        pos_pops = pos_local.reshape(pops_local, per, dim)
        pop_ids = dev * pops_local + jnp.arange(pops_local)
        keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(pop_ids)

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
            return chees_sample_chunk(
                logp, state, num_samples, max_num_steps, free
            )

        state, (pos, lps, acc) = jax.vmap(one_pop)(pos_pops, keys)
        # (P_local, S, per, ...) -> (S, P_local*per, ...)
        pos = jnp.moveaxis(pos, 0, 1).reshape(num_samples, pops_local * per, dim)
        lps = jnp.moveaxis(lps, 0, 1).reshape(num_samples, pops_local * per)
        acc = jnp.moveaxis(acc, 0, 1).reshape(num_samples, pops_local * per)
        return pos, lps, acc, state

    shard = P(axes)
    draws = P(None, axes)
    # every state leaf carries a leading (local) population axis — even the
    # per-population adaptation scalars are device-varying here
    state_spec = ChEESState(
        positions=shard,
        logps=shard,
        grads=shard,
        step_size=shard,
        inv_mass=shard,
        log_traj=shard,
        accept_probs=shard,
        da=adapt.DualAveragingState(shard, shard, shard, shard, shard),
        adam=AdamState(shard, shard, shard),
        welford=adapt.WelfordState(shard, shard, shard),
        step=shard,
        rng=shard,
    )
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(draws, draws, draws, state_spec),
            check_vma=False,
        )
    )
    pos, lps, acc, state = fn(position0)
    return Samples(pos, lps, acc, state)


def run_pt_chees_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
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
):
    """PT-ChEES with the LADDERS sharded over the mesh.

    Each device runs its local ladders' K-rung stacks; the cross-ladder
    rung populations (which drive every per-rung ChEES adaptation signal)
    span the mesh through pmeans, and the shared beta ladder adapts from
    pmean'd pair-rejection statistics — so every device holds the identical
    ladder and the run is device-count invariant (swaps are within-ladder
    and therefore entirely device-local; zero communication beyond O(K)
    adaptation scalars per sweep).

    ``position0``: (n_ladders, dim) cold-start positions, n_ladders
    divisible by the device count.  Returns
    :class:`gogp.infer.pt_chees.PTChEESResult` with all-ladder draws
    (num_samples, n_ladders, dim).
    """
    from gogp.infer.chees import finalize_chees_warmup
    from gogp.infer.pt_chees import (
        PTChEESResult,
        _init_flow_ladders,
        geometric_ladder,
        pt_chees_init,
        pt_chees_sample_chunk,
        pt_chees_warm_chunk,
    )

    position0 = jnp.asarray(position0)
    n_ladders, dim = position0.shape
    dtype = position0.dtype
    if betas is None:
        betas0 = geometric_ladder(n_replicas, beta_min, dtype)
    else:
        betas0 = jnp.asarray(betas, dtype)
        n_replicas = betas0.shape[0]
    axes = (CHAIN_AXIS, DATA_AXIS)
    n_dev = mesh.devices.size
    if n_ladders % n_dev != 0:
        raise ValueError(f"{n_ladders} ladders not divisible by {n_dev} devices")
    local = n_ladders // n_dev
    sched = adapt.build_schedule(num_warmup)
    key, key_init = jax.random.split(jnp.asarray(rng))
    data_size = mesh.shape[DATA_AXIS]

    def device_fn(pos_local):
        dev = jax.lax.axis_index(CHAIN_AXIS) * data_size + jax.lax.axis_index(
            DATA_AXIS
        )
        offset = dev * local
        states = pt_chees_init(
            logp, pos_local, key_init, betas0, local,
            init_step_size, init_traj_length, free,
        )
        betas_l = betas0
        k = key
        if num_warmup > 0:
            states, k, betas_l = pt_chees_warm_chunk(
                logp, states, k, betas_l,
                sched.update_mass, sched.window_end, jnp.asarray(0),
                max_num_steps, target_accept, traj_lr, free, adapt_ladder,
                axes, offset, n_ladders,
            )
            states = jax.vmap(finalize_chees_warmup)(states)
        flow = _init_flow_ladders(local, betas_l)
        states, k, pos, raws, fracs, flow = pt_chees_sample_chunk(
            logp, states, k, betas_l, num_samples, jnp.asarray(num_warmup),
            max_num_steps, free, flow, axes, offset, n_ladders,
        )
        # flow pair stats are identical on every device (pmean'd at the
        # swap); trips are per-local-ladder -> psum for the global count
        trips = jax.lax.psum(jnp.sum(flow.trips), axes)
        pair_rej = flow.rej_sum / jnp.maximum(flow.prop_count, 1.0)
        return pos, raws, jnp.mean(fracs), states, betas_l, trips, pair_rej

    shard = P(axes)
    draws = P(None, axes)
    repl = P()
    from gogp.infer.chees import AdamState, ChEESState

    state_spec = ChEESState(
        positions=P(None, axes),
        logps=P(None, axes),
        grads=P(None, axes),
        step_size=repl,
        inv_mass=repl,
        log_traj=repl,
        accept_probs=P(None, axes),
        da=adapt.DualAveragingState(repl, repl, repl, repl, repl),
        adam=AdamState(repl, repl, repl),
        welford=adapt.WelfordState(repl, repl, repl),
        step=repl,
        rng=repl,
    )
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(draws, draws, repl, state_spec, repl, repl, repl),
            check_vma=False,
        )
    )
    pos, raws, frac, states, betas_f, trips, pair_rej = fn(position0)
    return PTChEESResult(
        pos, raws, frac, states, betas_f, trips, jnp.sum(pair_rej), pair_rej
    )


def run_pt_distributed(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    n_replicas: int = 8,
    beta_min: float = 0.05,
    betas: Array | None = None,
    num_warmup: int = 400,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Array | None = None,
    adapt_ladder: bool = True,
):
    """ONE parallel-tempering ladder spanning the whole mesh.

    Each device owns ``n_replicas / n_devices`` adjacent temperature slots
    and runs their NUTS transitions + per-temperature step-size/mass
    adaptation locally.  A DEO swap sweep gathers the (position, raw logp,
    raw gradient) of all replicas — O(K * dim) scalars between devices, tiny for
    hyperparameter spaces — computes the identical swap decision on every
    device from a replicated key (infer.tempering.swap_decision), and each
    device keeps its slots' incoming states; step size and mass stay with
    the temperature.  The beta ladder is replicated and adapted to equal
    communication-barrier increments at every warmup window end (Syed et
    al. 2019, infer.tempering.adapt_ladder_betas).

    Unlike :func:`run_pt_sharded` (independent whole ladders per device),
    this lets MORE DEVICES DEEPEN ONE LADDER: K scales with the mesh while
    per-sweep comm stays O(K * dim).  Results are invariant to the device
    count (same replica count, same PRNG streams — tested on the CPU
    mesh).  Returns infer.tempering.PTResult with the cold-chain draws
    replicated and ``state`` sharded over the mesh.
    """
    from gogp.infer.hmc import finalize_warmup, init_state, warmup_step
    from gogp.infer.tempering import (
        PTFlow,
        PTResult,
        adapt_ladder_betas,
        geometric_ladder,
        init_flow,
        swap_decision,
    )

    position0 = jnp.asarray(position0)
    dtype = position0.dtype
    if betas is None:
        betas0 = geometric_ladder(n_replicas, beta_min, dtype)
    else:
        betas0 = jnp.asarray(betas, dtype)
        n_replicas = betas0.shape[0]
    K = n_replicas
    n_dev = mesh.devices.size
    if K % n_dev != 0:
        raise ValueError(f"{K} replicas not divisible by {n_dev} devices")
    r_local = K // n_dev
    if position0.ndim == 1:
        position0 = jnp.broadcast_to(position0, (K,) + position0.shape)
    key_loop, key_init = jax.random.split(jnp.asarray(rng))
    init_keys = jax.random.split(key_init, K)
    sched = adapt.build_schedule(num_warmup)

    def gather(x):
        x = jax.lax.all_gather(x, DATA_AXIS, tiled=True)
        return jax.lax.all_gather(x, CHAIN_AXIS, tiled=True)

    def device_fn(pos_local, keys_local):
        r0 = (
            jax.lax.axis_index(CHAIN_AXIS) * jax.lax.axis_size(DATA_AXIS)
            + jax.lax.axis_index(DATA_AXIS)
        ) * r_local

        def betas_loc_of(b):
            return jax.lax.dynamic_slice_in_dim(b, r0, r_local, 0)

        states = jax.vmap(
            lambda q, k, b: init_state(lambda v: b * logp(v), q, k, init_step_size, free)
        )(pos_local, keys_local, betas_loc_of(betas0))

        def transition(state, beta):
            return nuts_transition(
                lambda v: beta * logp(v), state, max_tree_depth=max_tree_depth, free=free
            )

        def swap(states, betas_full, k_swap, t):
            betas_loc = betas_loc_of(betas_full)
            raw_loc = states.logp / betas_loc
            rawg_loc = states.grad / betas_loc[:, None]
            raw_f = gather(raw_loc)
            pos_f = gather(states.position)
            rawg_f = gather(rawg_loc)
            src, pair_probs, proposed, swap_frac = swap_decision(
                betas_full, raw_f, k_swap, t % 2
            )
            my_src = jax.lax.dynamic_slice_in_dim(src, r0, r_local, 0)
            new_raw = raw_f[my_src]
            new_rawg = rawg_f[my_src]
            states = states._replace(
                position=pos_f[my_src],
                logp=new_raw * betas_loc,
                grad=new_rawg * betas_loc[:, None],
            )
            return (
                states, new_raw, new_rawg, pair_probs, proposed, swap_frac,
                pos_f[src[0]], raw_f[src[0]], src,
            )

        def warm_step(carry, inp):
            states, key, betas_full, rej_sum, prop_count = carry
            key, k_swap = jax.random.split(key)
            betas_loc = betas_loc_of(betas_full)
            states = jax.vmap(transition)(states, betas_loc)
            states = jax.vmap(
                lambda s: warmup_step(s, inp["um"], inp["we"], target_accept)
            )(states)
            states, new_raw, new_rawg, pair_probs, proposed, _, _, _, _ = swap(
                states, betas_full, k_swap, inp["t"]
            )
            rej_sum = rej_sum + jnp.where(proposed, 1.0 - pair_probs, 0.0)
            prop_count = prop_count + proposed.astype(rej_sum.dtype)

            if adapt_ladder:

                def update(args):
                    betas_full, rej, cnt, states = args
                    nb = adapt_ladder_betas(betas_full, rej, cnt)
                    nb_loc = betas_loc_of(nb)
                    states = states._replace(
                        logp=new_raw * nb_loc, grad=new_rawg * nb_loc[:, None]
                    )
                    return nb, jnp.zeros_like(rej), jnp.zeros_like(cnt), states

                betas_full, rej_sum, prop_count, states = jax.lax.cond(
                    inp["we"], update, lambda a: a,
                    (betas_full, rej_sum, prop_count, states),
                )
            return (states, key, betas_full, rej_sum, prop_count), None

        def sample_step(carry, t):
            states, key, betas_full, flow = carry
            key, k_swap = jax.random.split(key)
            states = jax.vmap(transition)(states, betas_loc_of(betas_full))
            states, _, _, pair_probs, proposed, swap_frac, cold_pos, cold_raw, src = swap(
                states, betas_full, k_swap, t
            )
            # replica-flow round trips + Rao-Blackwellized pair rejections:
            # src/pair stats are replicated, so every device computes the
            # identical O(K) update (infer.tempering.sample_step)
            labels = flow.labels[src]
            trips = flow.trips + (labels[0] > 0).astype(flow.trips.dtype)
            labels = labels.at[0].set(-1).at[K - 1].set(1)
            flow = PTFlow(
                labels=labels,
                trips=trips,
                rej_sum=flow.rej_sum + jnp.where(proposed, 1.0 - pair_probs, 0.0),
                prop_count=flow.prop_count + proposed.astype(flow.prop_count.dtype),
            )
            return (states, key, betas_full, flow), (cold_pos, cold_raw, swap_frac)

        zeros = jnp.zeros((K - 1,), dtype)
        betas_f = betas0
        key = key_loop
        if num_warmup > 0:
            ts = jnp.arange(num_warmup)
            (states, key, betas_f, _, _), _ = jax.lax.scan(
                warm_step,
                (states, key, betas_f, zeros, zeros),
                {"um": sched.update_mass, "we": sched.window_end, "t": ts},
            )
            states = jax.vmap(finalize_warmup)(states)
        ts2 = num_warmup + jnp.arange(num_samples)
        flow0 = init_flow(K, dtype)
        (states, _, betas_f, flow), (cold_pos, cold_raw, swap_fracs) = jax.lax.scan(
            sample_step, (states, key, betas_f, flow0), ts2
        )
        return cold_pos, cold_raw, jnp.mean(swap_fracs), states, betas_f, flow

    shard = P((CHAIN_AXIS, DATA_AXIS))
    rep = P()
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard, shard),
            out_specs=(rep, rep, rep, shard, rep, rep),
            check_vma=False,
        )
    )
    cold_pos, cold_raw, swap_rate, states, betas_f, flow = fn(position0, init_keys)
    pair_rej = flow.rej_sum / jnp.maximum(flow.prop_count, 1.0)
    return PTResult(
        cold_pos, cold_raw, swap_rate, states, betas_f, flow.trips,
        jnp.sum(pair_rej), pair_rej,
    )


def run_pt_chees_distributed(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
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
):
    """PT-ChEES with the RUNGS spanning the mesh — the ChEES analogue of
    :func:`run_pt_distributed`.

    Each device owns ``n_replicas / n_devices`` adjacent temperature slots;
    every slot holds the FULL cross-ladder population (L chains) locally,
    so all per-rung ChEES adaptation (shared step size / trajectory / mass
    from cross-ladder means) is device-local — zero collectives in the
    mutation.  A DEO sweep gathers (position, raw logp, raw grad) of all
    rungs — O(K * L * dim) floats between devices, tiny for hyperparameter
    spaces — computes identical per-ladder swap decisions on every device
    from replicated keys, and each device keeps its slots' incoming
    states; the adaptation state stays with the temperature slot.  The
    replicated beta ladder adapts to equal communication-barrier
    increments at warmup window ends (Syed et al. 2019).

    Unlike :func:`run_pt_chees_sharded` (whole ladders per device, rung
    populations pmean'd across the mesh), this lets MORE DEVICES DEEPEN
    ONE LADDER: K scales with the mesh at constant walltime per sweep —
    the scaling lever when cold-chain ESS is round-trip capped (min-ESS
    ~= 2x round trips).  Consumes the same PRNG
    stream as infer.run_pt_chees, so results match the local runner (and
    are device-count invariant) up to float reassociation.

    ``position0``: (dim,) or (n_ladders, dim) cold-start positions.
    Returns :class:`gogp.infer.pt_chees.PTChEESResult` with all-ladder
    cold draws (num_samples, n_ladders, dim) replicated and ``state``
    rung-sharded over the mesh.
    """
    from gogp.infer.chees import chees_init, chees_transition
    from gogp.infer.chees import chees_warmup_step, finalize_chees_warmup
    from gogp.infer.pt_chees import _flow_update, _init_flow_ladders
    from gogp.infer.tempering import (
        adapt_ladder_betas,
        geometric_ladder,
        swap_decision,
    )

    position0 = jnp.atleast_2d(jnp.asarray(position0))  # (L?, dim)
    if position0.shape[0] == 1 and n_ladders > 1:
        position0 = jnp.broadcast_to(position0, (n_ladders, position0.shape[-1]))
    L = n_ladders = position0.shape[0]
    dtype = position0.dtype
    if betas is None:
        betas0 = geometric_ladder(n_replicas, beta_min, dtype)
    else:
        betas0 = jnp.asarray(betas, dtype)
        n_replicas = betas0.shape[0]
    K = n_replicas
    n_dev = mesh.devices.size
    if K % n_dev != 0:
        raise ValueError(f"{K} replicas not divisible by {n_dev} devices")
    r_local = K // n_dev
    key_loop, key_init = jax.random.split(jnp.asarray(rng))
    # one init key per rung, global order — matches pt_chees_init's stream
    init_keys = jax.random.split(key_init, K)
    sched = adapt.build_schedule(num_warmup)
    axes = (CHAIN_AXIS, DATA_AXIS)

    def gather(x):
        x = jax.lax.all_gather(x, DATA_AXIS, tiled=True)
        return jax.lax.all_gather(x, CHAIN_AXIS, tiled=True)

    def device_fn(keys_local):
        r0 = (
            jax.lax.axis_index(CHAIN_AXIS) * jax.lax.axis_size(DATA_AXIS)
            + jax.lax.axis_index(DATA_AXIS)
        ) * r_local

        def betas_loc_of(b):
            return jax.lax.dynamic_slice_in_dim(b, r0, r_local, 0)

        states = jax.vmap(
            lambda k, b: chees_init(
                lambda v: b * logp(v), position0, k,
                init_step_size, init_traj_length, free,
            )
        )(keys_local, betas_loc_of(betas0))

        def transition(state, beta, adapt_traj):
            return chees_transition(
                lambda v: beta * logp(v), state,
                adapt_traj=adapt_traj, max_num_steps=max_num_steps,
                traj_lr=traj_lr, free=free,
            )

        def swap(states, betas_full, k_swap, parity):
            betas_loc = betas_loc_of(betas_full)
            raw_loc = states.logps / betas_loc[:, None]  # (r_local, L)
            rawg_loc = states.grads / betas_loc[:, None, None]
            raw_f = gather(raw_loc)  # (K, L)
            pos_f = gather(states.positions)  # (K, L, dim)
            rawg_f = gather(rawg_loc)
            keys = jax.random.split(k_swap, L)
            src, pair_probs, proposed, frac = jax.vmap(
                lambda r, k: swap_decision(betas_full, r, k, parity),
                in_axes=(1, 0), out_axes=(1, 0, 0, 0),
            )(raw_f, keys)  # src (K, L); pair stats (L, K-1); frac (L,)
            ladder = jnp.arange(L)[None, :]
            my_src = jax.lax.dynamic_slice_in_dim(src, r0, r_local, 0)
            new_raw = raw_f[my_src, ladder]  # (r_local, L)
            new_rawg = rawg_f[my_src, ladder]
            betas_col = betas_loc[:, None]
            states = states._replace(
                positions=pos_f[my_src, ladder],
                logps=new_raw * betas_col,
                grads=new_rawg * betas_col[..., None],
            )
            pair_rej = jnp.mean(jnp.where(proposed, 1.0 - pair_probs, 0.0), axis=0)
            prop = proposed[0].astype(raw_f.dtype)  # same parity every ladder
            cold = jnp.arange(L)
            return (
                states, new_raw, new_rawg, src, pair_rej, prop,
                jnp.mean(frac), pos_f[src[0], cold], raw_f[src[0], cold],
            )

        def warm_step(carry, inp):
            states, key, betas_full, rej_sum, prop_count = carry
            key, k_swap = jax.random.split(key)
            betas_loc = betas_loc_of(betas_full)
            states = jax.vmap(transition, in_axes=(0, 0, None))(
                states, betas_loc, True
            )
            states = jax.vmap(
                lambda s: chees_warmup_step(s, inp["um"], inp["we"], target_accept)
            )(states)
            states, new_raw, new_rawg, _, pair_rej, prop, _, _, _ = swap(
                states, betas_full, k_swap, inp["t"] % 2
            )
            rej_sum = rej_sum + pair_rej
            prop_count = prop_count + prop

            if adapt_ladder:

                def update(args):
                    betas_full, rej, cnt, states = args
                    nb = adapt_ladder_betas(betas_full, rej, cnt)
                    nb_loc = betas_loc_of(nb)[:, None]
                    states = states._replace(
                        logps=new_raw * nb_loc,
                        grads=new_rawg * nb_loc[..., None],
                    )
                    return nb, jnp.zeros_like(rej), jnp.zeros_like(cnt), states

                betas_full, rej_sum, prop_count, states = jax.lax.cond(
                    inp["we"], update, lambda a: a,
                    (betas_full, rej_sum, prop_count, states),
                )
            return (states, key, betas_full, rej_sum, prop_count), None

        def sample_step(carry, t):
            states, key, betas_full, flow = carry
            key, k_swap = jax.random.split(key)
            states = jax.vmap(transition, in_axes=(0, 0, None))(
                states, betas_loc_of(betas_full), False
            )
            states, _, _, src, pair_rej, prop, frac, cold_pos, cold_raw = swap(
                states, betas_full, k_swap, t % 2
            )
            # src and pair stats are replicated: every device computes the
            # identical per-ladder flow update (infer.pt_chees._flow_update)
            flow = _flow_update(flow, src)
            flow = flow._replace(
                rej_sum=flow.rej_sum + pair_rej, prop_count=flow.prop_count + prop
            )
            return (states, key, betas_full, flow), (cold_pos, cold_raw, frac)

        zeros = jnp.zeros((K - 1,), dtype)
        betas_f = betas0
        key = key_loop
        if num_warmup > 0:
            ts = jnp.arange(num_warmup)
            (states, key, betas_f, _, _), _ = jax.lax.scan(
                warm_step, (states, key, betas_f, zeros, zeros),
                {"um": sched.update_mass, "we": sched.window_end, "t": ts},
            )
            states = jax.vmap(finalize_chees_warmup)(states)
        flow0 = _init_flow_ladders(L, betas_f)
        ts2 = num_warmup + jnp.arange(num_samples)
        (states, _, betas_f, flow), (cold_pos, cold_raw, fracs) = jax.lax.scan(
            sample_step, (states, key, betas_f, flow0), ts2
        )
        trips = jnp.sum(flow.trips)  # replicated (flow is replicated)
        pair_rej = flow.rej_sum / jnp.maximum(flow.prop_count, 1.0)
        return cold_pos, cold_raw, jnp.mean(fracs), states, betas_f, trips, pair_rej

    from gogp.infer.chees import AdamState, ChEESState
    from gogp.infer.pt_chees import PTChEESResult

    shard = P(axes)
    rep = P()
    # every state leaf is rung-stacked: leading axis sharded over the mesh
    state_spec = ChEESState(
        positions=P(axes, None, None),
        logps=P(axes, None),
        grads=P(axes, None, None),
        step_size=shard,
        inv_mass=P(axes, None),
        log_traj=shard,
        accept_probs=P(axes, None),
        da=adapt.DualAveragingState(shard, shard, shard, shard, shard),
        adam=AdamState(shard, shard, shard),
        welford=adapt.WelfordState(shard, P(axes, None), P(axes, None)),
        step=shard,
        rng=shard,
    )
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(rep, rep, rep, state_spec, rep, rep, rep),
            check_vma=False,
        )
    )
    cold_pos, cold_raw, frac, states, betas_f, trips, pair_rej = fn(init_keys)
    return PTChEESResult(
        cold_pos, cold_raw, frac, states, betas_f, trips,
        jnp.sum(pair_rej), pair_rej,
    )


def run_pt_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    n_replicas: int = 4,
    beta_min: float = 0.05,
    num_warmup: int = 400,
    num_samples: int = 500,
    max_tree_depth: int = 6,
    free: Array | None = None,
):
    """Parallel-tempered NUTS with independent ladders sharded over the mesh.

    ``position0``: (n_chains, dim) — each chain owns a full replica ladder
    (the ladder lives on one device; swaps are local).  Chains split over
    the flattened mesh.  Returns a replica of
    gogp.infer.tempering.PTResult with leading axis n_chains.
    """
    from gogp.infer.tempering import run_pt_nuts

    position0 = jnp.asarray(position0)
    n_chains = position0.shape[0]
    n_dev = mesh.devices.size
    if n_chains % n_dev != 0:
        raise ValueError(f"{n_chains} chains not divisible by {n_dev} devices")
    keys = jax.random.split(jnp.asarray(rng), n_chains)
    sh = NamedSharding(mesh, P((CHAIN_AXIS, DATA_AXIS)))

    def one(q, k):
        return run_pt_nuts(
            logp, q, k, n_replicas=n_replicas, beta_min=beta_min,
            num_warmup=num_warmup, num_samples=num_samples,
            max_tree_depth=max_tree_depth, free=free,
        )

    f = jax.jit(jax.vmap(one), in_shardings=(sh, sh))
    return f(jax.device_put(position0, sh), jax.device_put(keys, sh))


def run_ess_sharded(
    loglik_fn: Callable,
    chol: Array,
    f0: Array,
    rng: Array,
    mesh: Mesh,
    num_warmup: int = 256,
    num_samples: int = 256,
    thin: int = 1,
):
    """Elliptical slice sampling with chains sharded over the mesh.

    ESS chains share no adaptation state, so — like run_chees_pops_sharded
    — the compiled program contains NO collectives: adding chips
    multiplies chains at constant walltime.  Per-chain rng is
    fold_in(rng, global chain id), exactly the stream infer.elliptical.
    run_ess assigns, so draws are bitwise device-count invariant (tested
    on the 8-virtual-device CPU mesh).  ``chol`` (the latent prior factor)
    is replicated; returns ((C,S,n), (C,S), (C,S)) like run_ess.
    """
    from gogp.infer.elliptical import run_ess_chain

    f0 = jnp.asarray(f0)
    c = f0.shape[0]
    n_dev = mesh.devices.size
    if c % n_dev != 0:
        raise ValueError(f"{c} chains not divisible by {n_dev} devices")
    local = c // n_dev
    data_size = mesh.shape[DATA_AXIS]
    rng = jnp.asarray(rng)
    axes = (CHAIN_AXIS, DATA_AXIS)

    def device_fn(f0_local):
        dev = jax.lax.axis_index(CHAIN_AXIS) * data_size + jax.lax.axis_index(
            DATA_AXIS
        )
        ids = dev * local + jnp.arange(local)
        keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(ids)
        return jax.vmap(
            lambda f0c, k: run_ess_chain(
                loglik_fn, chol, f0c, k, num_warmup, num_samples, thin
            )
        )(f0_local, keys)

    shard = P(axes)
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(shard, shard, shard),
            check_vma=False,
        )
    )
    return fn(f0)
