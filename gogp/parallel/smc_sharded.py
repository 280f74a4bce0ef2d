"""Multi-chip SMC: particles sharded over the mesh, resampling by all-gather.

The north-star large-N config (BASELINE.json: "SMC over hyperparameters on
multi-host pod").  Each device owns a slab of particles; per stage:

- incremental log-weights are computed locally (the expensive part: one GP
  LML per particle) and ``all_gather``-ed — hyperparameter vectors are tiny,
  so the gather payload is O(P * dim) floats;
- the adaptive tempering bisection and the systematic-resampling index
  vector are computed identically on every device from the gathered weights
  (same key -> same indices -> no divergence);
- each device gathers the full particle set once and keeps its slab of the
  resampled population; HMC/RWM mutation runs locally.

The loop itself (:func:`smc_loop`) is a shard_map-level function
parameterized by *which* mesh axes shard the particle population, so it
composes with data-parallel log-densities: ``run_smc_sharded`` shards
particles over every device (chain x data), while
``gogp.parallel.large_n.run_smc_large_n`` shards particles over the
chain axis and lets each particle's row-sharded LML collectives ride the
data axis — particle and data sharding simultaneously.

Device-count invariance (same result on 1 and N devices up to the identical
PRNG stream) is tested on the fake CPU mesh.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gogp.infer import smc as serial_smc
from gogp.infer.smc import SMCResult, _hmc_mutate, _rwm_mutate, _systematic_resample
from gogp.parallel.mesh import CHAIN_AXIS, DATA_AXIS

Array = jax.Array
LogDensity = Callable[[Array], Array]

_LOG_2PI = 1.8378770664093453


def _fold_rank(axes: Sequence[str]) -> Array:
    """Device rank in the flattened (row-major) ordering of ``axes`` —
    matches how P((a1, a2)) splits the particle axis."""
    r = jnp.asarray(0, jnp.int32)
    for a in axes:
        r = r * jax.lax.axis_size(a) + jax.lax.axis_index(a)
    return r


def _gather_axes(x: Array, axes: Sequence[str]) -> Array:
    """all_gather over ``axes`` so the result is ordered axes[0]-major."""
    for a in reversed(axes):
        x = jax.lax.all_gather(x, a, tiled=True)
    return x


def smc_loop(
    logp: LogDensity,
    particles_local: Array,
    position0: Array,
    key_loop: Array,
    particle_axes: Sequence[str],
    num_particles: int,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    n_leapfrog: int = 10,
    ess_target: float = 0.5,
    max_stages: int = 100,
    bisection_iters: int = 20,
    free: Array | None = None,
    mutation: str = "hmc",
):
    """Adaptive-tempering SMC on this device's particle slab.

    MUST be called inside shard_map.  ``particle_axes`` are the mesh axes
    sharding the particle population (weights/particles are gathered over
    them); any *other* mesh axes are free for the log-density's own
    collectives (e.g. the row-sharded large-N LML over the data axis) —
    particles and all control flow are replicated across those axes.

    Mutation keys derive from global particle indices, so results are
    invariant to how the population is split over devices.
    """
    if mutation not in ("hmc", "rwm"):
        raise ValueError(f"unknown mutation {mutation!r}")
    dim = position0.shape[0]
    dtype = position0.dtype
    p_local = particles_local.shape[0]

    def log_q0(v):
        z = (v - position0) / sigma0
        if free is not None:
            z = z * free
            n_free = jnp.sum(free)
        else:
            n_free = dim
        return -0.5 * jnp.sum(z * z) - n_free * (0.5 * _LOG_2PI + jnp.log(sigma0))

    def log_ratio(v):
        return logp(v) - log_q0(v)

    def vg_beta_fn(beta):
        def f(v):
            return (1.0 - beta) * log_q0(v) + beta * logp(v)

        return jax.value_and_grad(f)

    def next_beta(beta, log_ratios):
        def ess_at(b):
            lw = (b - beta) * log_ratios
            lw = lw - jnp.max(lw)
            w = jnp.exp(lw)
            return jnp.square(jnp.sum(w)) / jnp.sum(w * w)

        target = ess_target * num_particles
        lo, hi = beta, jnp.asarray(1.0, dtype)

        def bis(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        ok_full = ess_at(hi) >= target
        lo, hi = jax.lax.fori_loop(0, bisection_iters, bis, (lo, hi))
        return jnp.where(ok_full, 1.0, lo)

    rank = _fold_rank(particle_axes)

    def my_slab(full):
        return jax.lax.dynamic_slice_in_dim(full, rank * p_local, p_local, 0)

    def cond(carry):
        _, _, beta, stage, _, _ = carry
        return (beta < 1.0) & (stage < max_stages)

    def body(carry):
        parts, key, beta, stage, log_z, _ = carry
        key, k_res, k_mut = jax.random.split(key, 3)

        lr_local = jax.vmap(log_ratio)(parts)
        lr_local = jnp.where(jnp.isnan(lr_local), -jnp.inf, lr_local)
        log_ratios = _gather_axes(lr_local, particle_axes)  # (P,)
        beta_new = next_beta(beta, log_ratios)
        lw = (beta_new - beta) * log_ratios
        log_z = log_z + jax.scipy.special.logsumexp(lw) - jnp.log(
            float(num_particles)
        )

        idx = _systematic_resample(k_res, lw)  # identical on all devices
        full = _gather_axes(parts, particle_axes)  # (P, dim)
        parts = my_slab(full[idx])

        std = jnp.sqrt(
            jnp.maximum(
                jnp.mean(jnp.square(full[idx]), axis=0)
                - jnp.square(jnp.mean(full[idx], axis=0)),
                0.0,
            )
        )
        if free is not None:
            std = jnp.where(free > 0, std, 1.0)
        inv_mass = jnp.maximum(std * std, 1e-10)
        step_size = 0.5 / jnp.sqrt(jnp.asarray(dim, dtype))

        def particle_keys(i):
            # per-particle keys from GLOBAL indices: identical streams
            # regardless of device count / particle-axis layout
            keys_all = jax.random.split(
                jax.random.fold_in(k_mut, i), num_particles
            )
            return jax.lax.dynamic_slice_in_dim(keys_all, rank * p_local, p_local, 0)

        if mutation == "hmc":
            vg = vg_beta_fn(beta_new)

            def mutate(i, pa):
                p, _ = pa
                p, accept_probs = _hmc_mutate(
                    vg, p, particle_keys(i), step_size, inv_mass, n_leapfrog, free
                )
                return p, jnp.mean(accept_probs)

        else:  # rwm

            def logp_b(v):
                return (1.0 - beta_new) * log_q0(v) + beta_new * logp(v)

            rwm_scale = (2.38 / jnp.sqrt(jnp.asarray(dim, dtype))) * std

            def mutate(i, pa):
                p, _ = pa
                p, accept_probs = _rwm_mutate(
                    logp_b, p, particle_keys(i), rwm_scale, free
                )
                return p, jnp.mean(accept_probs)

        parts, acc = jax.lax.fori_loop(
            0, num_mcmc_steps, mutate, (parts, jnp.asarray(0.0, dtype))
        )
        return parts, key, beta_new, stage + 1, log_z, acc

    init = (
        particles_local,
        key_loop,
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
    )
    parts, _, beta, stage, log_z, acc = jax.lax.while_loop(cond, body, init)
    return parts, log_z, stage, beta >= 1.0, acc


def run_smc_sharded(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    mesh: Mesh,
    num_particles: int = 512,
    sigma0: float = 1.0,
    num_mcmc_steps: int = 5,
    n_leapfrog: int = 10,
    ess_target: float = 0.5,
    max_stages: int = 100,
    bisection_iters: int = 20,
    free: Array | None = None,
    mutation: str = "hmc",
) -> SMCResult:
    """Sharded counterpart of gogp.infer.smc.run_smc (same semantics);
    particles sharded over every mesh device (chain x data)."""
    position0 = jnp.asarray(position0)
    dim = position0.shape[0]
    dtype = position0.dtype
    n_dev = mesh.devices.size
    if num_particles % n_dev != 0:
        raise ValueError(f"{num_particles} particles not divisible by {n_dev} devices")
    if free is not None:
        free = jnp.asarray(free, dtype=dtype)

    key = jnp.asarray(rng)
    key_init, key_loop = jax.random.split(key)
    eps = jax.random.normal(key_init, (num_particles, dim), dtype)
    if free is not None:
        eps = eps * free[None, :]
    particles0 = position0[None, :] + sigma0 * eps

    def device_fn(particles_local):
        return smc_loop(
            logp,
            particles_local,
            position0,
            key_loop,
            (CHAIN_AXIS, DATA_AXIS),
            num_particles,
            sigma0=sigma0,
            num_mcmc_steps=num_mcmc_steps,
            n_leapfrog=n_leapfrog,
            ess_target=ess_target,
            max_stages=max_stages,
            bisection_iters=bisection_iters,
            free=free,
            mutation=mutation,
        )

    shard = P((CHAIN_AXIS, DATA_AXIS))
    rep = P()
    fn = jax.jit(
        jax.shard_map(
            device_fn,
            mesh=mesh,
            in_specs=(shard,),
            out_specs=(shard, rep, rep, rep, rep),
            # replicated outputs are derived from all_gathered values; skip
            # the varying-axis type check (see parallel/sample.py)
            check_vma=False,
        )
    )
    parts, log_z, stage, done, acc = fn(particles0)
    return SMCResult(parts, log_z, stage, done, acc)


# re-export for callers that want the serial fallback alongside
run_smc = serial_smc.run_smc
