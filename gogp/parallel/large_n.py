"""Large-N GP inference: SMC over hyperparameters with the covariance
sharded over the mesh and the Cholesky distributed (BASELINE.json config
"Large-N forecast: N=16k points, sharded covariance + distributed Cholesky,
SMC over hyperparameters").

Composition: the whole SMC sampler runs *inside* ``shard_map`` over the
full mesh.  The particle population is sharded over the non-data axes
(weights/resampling gather over them, mutation keys derive from global
particle indices — see parallel.smc_sharded.smc_loop); each particle's
log-density does distributed work over the *data* axis — each device
builds its block-rows of K(theta) directly from its shard of X (the
covariance is never materialized unsharded) and the blocked distributed
Cholesky + solve (gogp.ops.distributed) reduce to the replicated LML
scalar with psum collectives.  Sampler control flow (tempering bisection,
resampling) is replicated everywhere by identical PRNG streams.

Mutation: HMC by default — the distributed factorization's fori_loop
pipeline is not reverse-differentiable, but the sharded LML carries an
analytic custom VJP (ops/distributed.lml_rowsharded) whose solves use the
trailing-update block substitution (per-step comm O(b m), never a gather
of the partial solution), and :func:`psum_grads` completes the
cross-device parameter gradient.  "rwm" remains the log-density-only
cheap option.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gogp.gp.core import GP
from gogp.infer.smc import SMCResult
from gogp.ops.distributed import lml_rowsharded
from gogp.parallel.mesh import DATA_AXIS
from gogp.parallel.smc_sharded import _fold_rank, smc_loop

Array = jax.Array


def make_rowsharded_logp(gp: GP, x_local, x_full, y_local, mask_local, axis: str, block: int,
                         method: str = "exact", key=None, num_probes: int = 16,
                         cg_iters: int = 100, lanczos_iters: int = 32,
                         precond_rank: int = 0):
    """Per-device closure: v (log-thetas, replicated) -> replicated LML.

    Builds this device's block-rows of K(theta) from its X shard (reference
    covariance semantics, gp/gp.go:106-156: noise + mask on the diagonal
    only) and runs the distributed factorization — or, with
    ``method="iterative"``, the matrix-free CG/SLQ estimator
    (ops.iterative.lml_rowsharded_iterative: the whole distribution
    reduces to one all_gather per covariance matvec; ``key`` seeds the
    probes identically on every device).  ``precond_rank > 0`` (iterative
    only) builds the pivoted-Cholesky preconditioner from all_gathered
    column slices and runs PCG + preconditioned SLQ.
    """
    if method == "iterative" and key is None:
        raise ValueError("method='iterative' needs a probe `key`")
    n_local = x_local.shape[0]
    n = x_full.shape[0]

    def logp(v):
        theta = jnp.exp(v)
        th_s, th_n = theta[: gp.n_theta_simil], theta[gp.n_theta_simil :]
        row0 = jax.lax.axis_index(axis) * n_local
        rows = gp.simil.matrix(th_s, x_local, x_full)  # (n_local, n)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local, n), 1)
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local, n), 0) + row0
        eye = col_ids == row_ids
        noise = gp.noise.vector(th_n, x_local)
        rows = jnp.where(eye, rows + noise[:, None], rows)
        # padding mask: identity rows/cols for masked-out points
        m_local = mask_local.astype(rows.dtype)
        # column mask needs the full mask: gather it
        m_full = jax.lax.all_gather(m_local, axis, tiled=True)
        rows = rows * (m_local[:, None] * m_full[None, :])
        rows = jnp.where(eye, rows + (1.0 - m_local[:, None]), rows)
        yv = y_local * m_local
        if method == "iterative":
            from gogp.ops.iterative import lml_rowsharded_iterative

            y_full = jax.lax.all_gather(yv, axis, tiled=True)
            noise_diag = None
            if precond_rank > 0:
                nd_local = gp.noise.vector(th_n, x_local) * m_local + (1.0 - m_local)
                noise_diag = jax.lax.all_gather(nd_local, axis, tiled=True)
            core = lml_rowsharded_iterative(
                rows, y_full, key, axis, num_probes, cg_iters, lanczos_iters,
                precond_rank, noise_diag,
            )
            n_eff = jax.lax.psum(jnp.sum(m_local), axis)
            return core - 0.5 * n_eff * jnp.log(2.0 * jnp.pi)
        lml = lml_rowsharded(rows, yv, axis, block)
        # correct the constant term for padding: lml_rowsharded used full n
        n_pad = jnp.asarray(n, rows.dtype) - jax.lax.psum(jnp.sum(m_local), axis)
        return lml + 0.5 * n_pad * jnp.log(2.0 * jnp.pi)

    return logp


def make_rowsharded_value_and_grad(logp, axis: str = DATA_AXIS):
    """value_and_grad for a row-sharded log-density.

    The LML's custom VJP yields each device's *partial* parameter gradient
    (the terms of tr(W dK) whose K rows it owns); one psum completes it.
    This is the gradient entry point for HMC/NUTS over the large-N sharded
    log-density.
    """
    vg = jax.value_and_grad(logp)

    def f(v):
        val, g = vg(v)
        return val, jax.lax.psum(g, axis)

    return f


def psum_grads(logp, axis: str = DATA_AXIS):
    """Wrap a row-sharded log-density so plain ``jax.grad`` of the wrapper
    is the COMPLETE parameter gradient (cross-device psum baked into the
    custom VJP).  Lets gradient-generic samplers (run_smc's HMC mutation,
    run_nuts) consume the sharded density unchanged."""

    @jax.custom_vjp
    def f(v):
        return logp(v)

    def fwd(v):
        val, vjp = jax.vjp(logp, v)
        return val, vjp

    def bwd(vjp, cot):
        (g,) = vjp(cot)
        return (jax.lax.psum(g, axis),)

    f.defvjp(fwd, bwd)
    return f


def run_chees_large_n(
    gp: GP,
    x: Array,
    y: Array,
    rng: Array,
    mesh: Mesh,
    num_chains: int = 8,
    num_warmup: int = 200,
    num_samples: int = 200,
    block: int = 256,
    mask: Array | None = None,
    position0: Array | None = None,
    sigma0: float = 0.1,
    init_step_size: float = 0.01,
    init_traj_length: float = 0.1,
    target_accept: float = 0.75,
    max_num_steps: int = 64,
    traj_lr: float = 0.025,
    method: str = "exact",
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
    grid_size: int | tuple = 2048,
):
    """Full-posterior ChEES-HMC over log-thetas with the covariance
    row-sharded over the data axis — Bayesian GP inference at n beyond one
    chip's HBM.

    The composition mirrors :func:`run_smc_large_n`: chains shard over the
    non-data mesh axes (every cross-chain adaptation statistic pmeans over
    them; per-chain randomness keys off global chain indices), and each
    chain's log-density + gradient does distributed work over the *data*
    axis — block-rows of K(theta) built from the local X shard, the
    distributed blocked Cholesky/solves reducing to a replicated LML, and
    the analytic custom VJP completing the cross-device parameter gradient
    (:func:`psum_grads`).  Leapfrog control flow is replicated everywhere.

    Returns infer.hmc.Samples with positions (num_samples, num_chains,
    dim); ``state`` is the final rung-less ChEESState (positions sharded
    over the chain axes, adaptation scalars replicated).

    ``method="iterative"`` samples the matrix-free CG/SLQ surrogate
    instead of the exact LML — probes are fixed for the whole run, so the
    target is a smooth deterministic approximation whose bias is the
    estimator error (see run_smc_large_n's note).

    ``method="ski"`` samples the SKI O(n 4^d + N log N) surrogate
    (gp.ski.lml_ski, ``grid_size`` per axis) — the n=10^5-per-chain
    regime.  The composition flips: per-chain work is cheap enough on ONE
    chip that data sharding buys nothing, so chains shard over EVERY mesh
    axis with (x, y) replicated — zero collectives besides the adaptation
    pmeans.  Probes are fixed for the whole run (smooth surrogate, as
    above); no padding mask (raise if given).
    """
    from gogp.infer import adapt
    from gogp.infer.chees import (
        AdamState,
        ChEESState,
        chees_init,
        chees_sample_chunk,
        chees_warm_chunk,
        finalize_chees_warmup,
    )
    from gogp.infer.hmc import Samples

    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    y = jnp.asarray(y)
    n = x.shape[0]
    n_data = mesh.shape[DATA_AXIS]
    if method == "ski":
        if mask is not None:
            raise ValueError("method='ski' does not support a padding mask")
    else:
        if n % n_data != 0:
            raise ValueError(f"n={n} must divide over {n_data} data-axis devices")
        if mask is None:
            mask = jnp.ones(n, dtype=x.dtype)
    if position0 is None:
        position0 = jnp.zeros(gp.n_theta, dtype=x.dtype)
    position0 = jnp.asarray(position0)
    dim = position0.shape[0]
    dtype = position0.dtype
    rng = jnp.asarray(rng)

    if method == "ski":
        chain_axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    else:
        chain_axes = tuple(
            a for a in mesh.axis_names if a != DATA_AXIS and mesh.shape[a] > 1
        )
    n_chain_dev = 1
    for a in chain_axes:
        n_chain_dev *= mesh.shape[a]
    if num_chains % n_chain_dev != 0:
        raise ValueError(
            f"{num_chains} chains not divisible over {n_chain_dev} "
            f"chain-axis devices {chain_axes}"
        )
    local = num_chains // n_chain_dev
    axis_name = chain_axes if chain_axes else None

    key_init, key_loop = jax.random.split(rng)
    key_probes = (
        jax.random.fold_in(rng, 2) if method in ("iterative", "ski") else None
    )
    sched = adapt.build_schedule(num_warmup)

    def device_fn_ski(x_rep, y_rep):
        from gogp.gp.ski import lml_ski

        def logp(v):
            theta = jnp.exp(v)
            return lml_ski(
                gp, theta[: gp.n_theta_simil], theta[gp.n_theta_simil :],
                x_rep, y_rep, key_probes, grid_size, num_probes, cg_iters,
                lanczos_iters,
            )

        eps = jax.random.normal(key_init, (num_chains, dim), dtype)
        pos0 = position0[None, :] + sigma0 * eps
        if chain_axes:
            rank = _fold_rank(chain_axes)
            slab = jax.lax.dynamic_slice_in_dim(pos0, rank * local, local, 0)
            offset = rank * local
        else:
            slab = pos0
            offset = 0
        state = chees_init(logp, slab, key_loop, init_step_size, init_traj_length)
        if num_warmup > 0:
            state = chees_warm_chunk(
                logp, state, sched.update_mass, sched.window_end,
                max_num_steps, target_accept, traj_lr, None, axis_name, offset,
            )
            state = finalize_chees_warmup(state)
        state, (pos, lps, acc) = chees_sample_chunk(
            logp, state, num_samples, max_num_steps, None, axis_name, offset
        )
        return pos, lps, acc, state

    def device_fn(x_local, y_local, m_local):
        logp = psum_grads(
            make_rowsharded_logp(
                gp, x_local, jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
                y_local, m_local, DATA_AXIS, block,
                method=method, key=key_probes, num_probes=num_probes,
                cg_iters=cg_iters, lanczos_iters=lanczos_iters,
                precond_rank=precond_rank,
            ),
            DATA_AXIS,
        )
        # identical global init everywhere; keep my chain-axis slab
        eps = jax.random.normal(key_init, (num_chains, dim), dtype)
        pos0 = position0[None, :] + sigma0 * eps
        if chain_axes:
            rank = _fold_rank(chain_axes)
            slab = jax.lax.dynamic_slice_in_dim(pos0, rank * local, local, 0)
            offset = rank * local
        else:
            slab = pos0
            offset = 0
        state = chees_init(
            logp, slab, key_loop, init_step_size, init_traj_length
        )
        if num_warmup > 0:
            state = chees_warm_chunk(
                logp, state, sched.update_mass, sched.window_end,
                max_num_steps, target_accept, traj_lr, None,
                axis_name, offset,
            )
            state = finalize_chees_warmup(state)
        state, (pos, lps, acc) = chees_sample_chunk(
            logp, state, num_samples, max_num_steps, None, axis_name, offset
        )
        return pos, lps, acc, state

    rep = P()
    shard = P(chain_axes) if chain_axes else rep
    draws = P(None, chain_axes) if chain_axes else rep
    state_spec = ChEESState(
        positions=shard,
        logps=shard,
        grads=shard,
        step_size=rep,
        inv_mass=rep,
        log_traj=rep,
        accept_probs=shard,
        da=jax.tree.map(lambda _: rep, adapt.da_init(0.1)),
        adam=AdamState(rep, rep, rep),
        welford=jax.tree.map(
            lambda _: rep, adapt.welford_init(dim, dtype)
        ),
        step=rep,
        rng=rep,
    )
    if method == "ski":
        fn = jax.jit(
            jax.shard_map(
                device_fn_ski,
                mesh=mesh,
                in_specs=(P(), P()),
                out_specs=(draws, draws, draws, state_spec),
                check_vma=False,
            )
        )
        pos, lps, acc, state = fn(x, y)
        return Samples(pos, lps, acc, state)
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(draws, draws, draws, state_spec),
            check_vma=False,
        )
    )
    pos, lps, acc, state = fn(x, y, mask)
    return Samples(pos, lps, acc, state)


def run_smc_large_n(
    gp: GP,
    x: Array,
    y: Array,
    rng: Array,
    mesh: Mesh,
    num_particles: int = 32,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    block: int = 256,
    mask: Array | None = None,
    position0: Array | None = None,
    max_stages: int = 50,
    mutation: str = "hmc",
    method: str = "exact",
    num_probes: int = 16,
    cg_iters: int = 100,
    lanczos_iters: int = 32,
    precond_rank: int = 0,
) -> SMCResult:
    """SMC posterior over log-thetas with N-sharded covariance work AND the
    particle population sharded over the remaining mesh axes.

    ``x``: (n, d), ``y``: (n,) with n divisible by the mesh's data-axis
    size.  Every non-data mesh axis with size > 1 shards particles: a
    (chain=C, data=D) mesh gives each device P/C particles and n/D rows of
    each particle's covariance — each particle's LML/gradient collectives
    ride the data axis while weights/resampling gather over the chain axis.
    2x4 / 4x2 / 1x8 meshes produce identical posteriors up to float
    reassociation (mutation keys derive from global particle indices).

    ``mutation``: "hmc" (default — gradient-guided, using the sharded
    LML's custom VJP with the cross-device psum baked in via
    :func:`psum_grads`) or "rwm" (log-density only, cheapest per step).

    ``method="iterative"`` swaps the distributed blocked factorization
    for the matrix-free CG/SLQ core (make_rowsharded_logp): probes are
    FIXED for the whole run (fold_in(rng, 2)), so the target is a smooth
    deterministic surrogate of the posterior whose bias is the estimator
    error — the correlated-across-theta form that Metropolis differences
    mostly cancel — rather than a fresh-noise pseudo-marginal.
    """
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    y = jnp.asarray(y)
    n = x.shape[0]
    n_data = mesh.shape[DATA_AXIS]
    if n % n_data != 0:
        raise ValueError(f"n={n} must divide over {n_data} data-axis devices")
    if mask is None:
        mask = jnp.ones(n, dtype=x.dtype)
    if position0 is None:
        position0 = jnp.zeros(gp.n_theta, dtype=x.dtype)
    position0 = jnp.asarray(position0)
    rng = jnp.asarray(rng)
    dim = position0.shape[0]
    dtype = position0.dtype

    particle_axes = tuple(
        a for a in mesh.axis_names if a != DATA_AXIS and mesh.shape[a] > 1
    )
    n_part_dev = 1
    for a in particle_axes:
        n_part_dev *= mesh.shape[a]
    if num_particles % n_part_dev != 0:
        raise ValueError(
            f"{num_particles} particles not divisible over {n_part_dev} "
            f"particle-axis devices {particle_axes}"
        )
    p_local = num_particles // n_part_dev

    key_init, key_loop = jax.random.split(rng)
    key_probes = jax.random.fold_in(rng, 2) if method == "iterative" else None

    def device_fn(x_local, y_local, m_local):
        logp = make_rowsharded_logp(
            gp, x_local, jax.lax.all_gather(x_local, DATA_AXIS, tiled=True),
            y_local, m_local, DATA_AXIS, block,
            method=method, key=key_probes, num_probes=num_probes,
            cg_iters=cg_iters, lanczos_iters=lanczos_iters,
            precond_rank=precond_rank,
        )
        if mutation == "hmc":
            logp = psum_grads(logp, DATA_AXIS)
        # identical population on every device; keep my chain-axis slab
        eps = jax.random.normal(key_init, (num_particles, dim), dtype)
        particles0 = position0[None, :] + sigma0 * eps
        if particle_axes:
            rank = _fold_rank(particle_axes)
            slab = jax.lax.dynamic_slice_in_dim(
                particles0, rank * p_local, p_local, 0
            )
        else:
            slab = particles0
        return smc_loop(
            logp,
            slab,
            position0,
            key_loop,
            particle_axes,
            num_particles,
            sigma0=sigma0,
            num_mcmc_steps=num_mcmc_steps,
            max_stages=max_stages,
            free=None,
            mutation=mutation,
        )

    in_shard = P(DATA_AXIS)
    rep = P()
    part_spec = P(particle_axes) if particle_axes else rep
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(P(DATA_AXIS, None), in_shard, in_shard),
            out_specs=(part_spec, rep, rep, rep, rep),
            check_vma=False,
        )
    )
    parts, log_z, stage, done, acc = fn(x, y, mask)
    return SMCResult(parts, log_z, stage, done, acc)
