"""Hamiltonian Monte Carlo: vectorized leapfrog + windowed warmup.

Part of the north-star inference layer (BASELINE.json: "Replace Infergo's
reverse-mode AD + MLE/HMC with JAX autodiff driving NUTS/HMC, ADVI and SMC").
The reference itself only exposes MLE (tutorial/tutorial.go:128-169); upstream
Infergo ships HMC/NUTS, which is the behavioral surface this reproduces.

Everything is a pure function of (key, state): one compiled ``lax.scan``
drives warmup + sampling with zero host round-trips; chains are vmapped on
one chip and sharded across chips by gogp.parallel.sample (the mass
matrix and step-size adaptation statistics are combined across devices with
psum — see adapt.welford_combine).

Supports an optional 0/1 ``free`` mask pinning coordinates (the tutorials'
gradient-surgery constraint, SURVEY.md §2.1-10): frozen coordinates get zero
momentum and zero gradient, so they never move and contribute nothing to the
Hamiltonian.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt

Array = jax.Array
LogDensity = Callable[[Array], Array]


class HMCState(NamedTuple):
    """Per-chain sampler state (a pytree; vmap/shard over a leading axis)."""

    position: Array  # (dim,)
    logp: Array  # ()
    grad: Array  # (dim,)
    step_size: Array  # ()
    inv_mass: Array  # (dim,) diagonal inverse mass matrix
    da: adapt.DualAveragingState
    welford: adapt.WelfordState
    accept_prob: Array  # () last transition's acceptance probability
    rng: Array  # PRNG key


class IntegratorState(NamedTuple):
    position: Array
    momentum: Array
    logp: Array
    grad: Array


def leapfrog(
    value_and_grad: Callable[[Array], tuple[Array, Array]],
    state: IntegratorState,
    step_size: Array,
    inv_mass: Array,
    n_steps: int | Array,
    free: Array | None = None,
) -> IntegratorState:
    """``n_steps`` velocity-Verlet steps, as one lax.scan (static) or
    fori_loop (traced n_steps)."""

    def one(s: IntegratorState) -> IntegratorState:
        r = s.momentum + 0.5 * step_size * s.grad
        q = s.position + step_size * inv_mass * r
        if free is not None:
            q = jnp.where(free > 0, q, s.position)
        logp, grad = value_and_grad(q)
        if free is not None:
            grad = grad * free
        r = r + 0.5 * step_size * grad
        return IntegratorState(q, r, logp, grad)

    if isinstance(n_steps, int):
        return jax.lax.scan(lambda s, _: (one(s), None), state, None, length=n_steps)[0]
    return jax.lax.fori_loop(0, n_steps, lambda _, s: one(s), state)


def kinetic(momentum: Array, inv_mass: Array) -> Array:
    return 0.5 * jnp.dot(momentum, inv_mass * momentum)


def sample_momentum(key: Array, inv_mass: Array, free: Array | None = None) -> Array:
    r = jax.random.normal(key, inv_mass.shape, dtype=inv_mass.dtype) / jnp.sqrt(inv_mass)
    if free is not None:
        r = r * free
    return r


def init_state(
    logp: LogDensity,
    position: Array,
    rng: Array,
    step_size: float = 0.1,
    free: Array | None = None,
) -> HMCState:
    position = jnp.asarray(position)
    val, grad = jax.value_and_grad(logp)(position)
    if free is not None:
        grad = grad * jnp.asarray(free, dtype=grad.dtype)
    dim = position.shape[0]
    return HMCState(
        position=position,
        logp=val,
        grad=grad,
        step_size=jnp.asarray(step_size, position.dtype),
        inv_mass=jnp.ones((dim,), position.dtype),
        da=adapt.da_init(jnp.asarray(step_size, position.dtype)),
        welford=adapt.welford_init(dim, position.dtype),
        accept_prob=jnp.zeros((), position.dtype),
        rng=rng,
    )


def hmc_transition(
    logp: LogDensity,
    state: HMCState,
    trajectory_length: float = 1.0,
    max_num_steps: int = 1024,
    free: Array | None = None,
    divergence_threshold: float = 1000.0,
) -> HMCState:
    """One HMC transition: sample momentum, integrate ~trajectory_length,
    Metropolis accept.  Number of leapfrog steps = ceil(length/step) (traced,
    bounded by ``max_num_steps`` to keep the program static)."""
    vg = jax.value_and_grad(logp)
    if free is not None:
        free = jnp.asarray(free, dtype=state.position.dtype)

        def vg_masked(q):
            v, g = jax.value_and_grad(logp)(q)
            return v, g * free

        vg = vg_masked

    key, key_mom, key_acc = jax.random.split(state.rng, 3)
    r0 = sample_momentum(key_mom, state.inv_mass, free)
    energy0 = -state.logp + kinetic(r0, state.inv_mass)

    n_steps = jnp.clip(
        jnp.ceil(trajectory_length / state.step_size).astype(jnp.int32),
        1,
        max_num_steps,
    )
    integ = IntegratorState(state.position, r0, state.logp, state.grad)
    integ = leapfrog(vg, integ, state.step_size, state.inv_mass, n_steps, free)

    energy1 = -integ.logp + kinetic(integ.momentum, state.inv_mass)
    delta = energy1 - energy0
    delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
    accept_prob = jnp.where(
        delta > divergence_threshold, 0.0, jnp.minimum(1.0, jnp.exp(-delta))
    )
    accept = jax.random.uniform(key_acc) < accept_prob
    position = jnp.where(accept, integ.position, state.position)
    logp_new = jnp.where(accept, integ.logp, state.logp)
    grad_new = jnp.where(accept, integ.grad, state.grad)
    return state._replace(
        position=position,
        logp=logp_new,
        grad=grad_new,
        accept_prob=accept_prob,
        rng=key,
    )


def warmup_step(
    state: HMCState,
    update_mass: Array,
    window_end: Array,
    target_accept: float = 0.8,
) -> HMCState:
    """Adaptation bookkeeping after one transition (shared by HMC and NUTS).

    - always: dual-averaging step-size update from the accept statistic;
    - if ``update_mass``: feed the position into the Welford accumulator;
    - if ``window_end``: refresh inv_mass from the window's variance, reset
      the accumulator, and re-init dual averaging at the current step size.
    """
    da = adapt.da_update(state.da, state.accept_prob, target=target_accept)
    step_size = jnp.exp(da.log_step)

    welford = jax.lax.cond(
        update_mass,
        lambda w: adapt.welford_update(w, state.position),
        lambda w: w,
        state.welford,
    )

    def refresh(args):
        welford, da, inv_mass = args
        new_inv_mass = adapt.welford_variance(welford)
        # keep unit mass if the window was empty
        new_inv_mass = jnp.where(welford.count > 1, new_inv_mass, inv_mass)
        fresh = adapt.welford_init(inv_mass.shape[0], inv_mass.dtype)
        da2 = adapt.da_init(jnp.exp(da.log_step))
        return fresh, da2, new_inv_mass

    welford, da, inv_mass = jax.lax.cond(
        window_end,
        refresh,
        lambda args: args,
        (welford, da, state.inv_mass),
    )
    return state._replace(step_size=step_size, da=da, welford=welford, inv_mass=inv_mass)


def finalize_warmup(state: HMCState) -> HMCState:
    """Freeze the step size at the dual-averaging iterate average."""
    return state._replace(step_size=jnp.exp(state.da.log_step_avg))


class Samples(NamedTuple):
    positions: Array  # (num_samples, dim) or (chains, num_samples, dim)
    logps: Array
    accept_probs: Array
    state: HMCState  # final state (carries tuned step size / mass)


def run_hmc(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    trajectory_length: float = 1.0,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Array | None = None,
    max_num_steps: int = 1024,
) -> Samples:
    """Warmup + sampling as two compiled scans (single chain; vmap for more)."""
    state = init_state(logp, position0, rng, init_step_size, free)
    sched = adapt.build_schedule(num_warmup)

    def wstep(state, flags):
        um, we = flags
        state = hmc_transition(
            logp, state, trajectory_length, max_num_steps, free
        )
        state = warmup_step(state, um, we, target_accept)
        return state, None

    if num_warmup > 0:
        state, _ = jax.lax.scan(
            wstep, state, (sched.update_mass, sched.window_end)
        )
        state = finalize_warmup(state)

    def sstep(state, _):
        state = hmc_transition(
            logp, state, trajectory_length, max_num_steps, free
        )
        return state, (state.position, state.logp, state.accept_prob)

    state, (positions, logps, accepts) = jax.lax.scan(
        sstep, state, None, length=num_samples
    )
    return Samples(positions, logps, accepts, state)
