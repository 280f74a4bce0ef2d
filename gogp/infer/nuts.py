"""No-U-Turn Sampler: iterative tree doubling under jit.

Part of the north-star inference layer (BASELINE.json).  The reference
delegates sampling to Infergo (which ships HMC/NUTS upstream); this is a
fresh accelerator-first implementation.

Design constraints drive the algorithm choice: XLA traces once and forbids
recursion and data-dependent Python control flow, so the recursive tree
building of Hoffman & Gelman (2014) is reformulated iteratively:

- a trajectory subtree of 2^d leaves is built by d bounded ``while_loop``
  leapfrog steps;
- the O(log n) U-turn checks of the recursive algorithm are reproduced with
  a checkpoint stack of size ``max_tree_depth``: leaf ``n`` (even) stores its
  momentum and running momentum-sum at slot ``popcount(n)``; leaf ``n`` (odd,
  with ``t`` trailing one-bits) checks the spans of sizes 2,4,...,2^t that
  end at ``n`` against slots ``popcount(n>>1)-t+1 .. popcount(n>>1)``.
  For the span starting at checkpointed leaf ``a``:
  ``rho = r_sum_now - r_sum_ckpt + r_ckpt`` (the checkpointed sum includes
  leaf ``a``), and the span turns when ``rho . M^-1 r`` is non-positive at
  either end;
- proposals are multinomial in leaf weights ``exp(energy0 - energy_leaf)``
  (progressive within a subtree, biased-progressive across doublings).

Everything is a pure function of (key, state): chains vmap on one chip and
shard across chips (gogp.parallel.sample); adaptation statistics psum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from gogp.infer import adapt
from gogp.infer.hmc import (
    HMCState,
    IntegratorState,
    Samples,
    finalize_warmup,
    init_state,
    kinetic,
    sample_momentum,
    warmup_step,
)

Array = jax.Array
LogDensity = Callable[[Array], Array]

DIVERGENCE_THRESHOLD = 1000.0


def _popcount(n: Array) -> Array:
    return jax.lax.population_count(n.astype(jnp.uint32)).astype(jnp.int32)


def _trailing_ones(n: Array) -> Array:
    """Number of trailing 1-bits: ctz(n+1) = popcount((m & -m) - 1), m=n+1."""
    m = (n + 1).astype(jnp.uint32)
    return _popcount((m & (~m + jnp.uint32(1))) - jnp.uint32(1))


def _is_turning(inv_mass: Array, rho: Array, r_left: Array, r_right: Array) -> Array:
    v = inv_mass * rho
    return (jnp.dot(v, r_left) <= 0) | (jnp.dot(v, r_right) <= 0)


class _TreeState(NamedTuple):
    # trajectory endpoints in time order (left = earliest)
    left: IntegratorState
    right: IntegratorState
    # current multinomial proposal
    prop: IntegratorState
    r_sum: Array  # momentum sum over all leaves
    log_weight: Array  # logsumexp of leaf log-weights
    depth: Array
    turning: Array
    diverging: Array
    sum_accept: Array  # sum of per-leaf accept statistics
    num_leaves: Array


class _SubtreeCarry(NamedTuple):
    n: Array  # next leaf index within the subtree
    integ: IntegratorState  # last produced leaf
    r_ckpts: Array  # (max_depth+1, dim)
    r_sum_ckpts: Array  # (max_depth+1, dim)
    r_sum: Array
    prop: IntegratorState
    log_weight: Array
    turning: Array
    diverging: Array
    sum_accept: Array


def _one_leapfrog(vg, integ: IntegratorState, step: Array, inv_mass: Array, free):
    r = integ.momentum + 0.5 * step * integ.grad
    q = integ.position + step * inv_mass * r
    if free is not None:
        q = jnp.where(free > 0, q, integ.position)
    logp, grad = vg(q)
    if free is not None:
        grad = grad * free
    r = r + 0.5 * step * grad
    return IntegratorState(q, r, logp, grad)


def _build_subtree(
    vg,
    from_state: IntegratorState,
    num_leaves: Array,
    direction: Array,
    step_size: Array,
    inv_mass: Array,
    energy0: Array,
    key: Array,
    max_tree_depth: int,
    free,
) -> _SubtreeCarry:
    dim = from_state.position.shape[0]
    dtype = from_state.position.dtype
    step = direction.astype(dtype) * step_size

    def cond(c: _SubtreeCarry):
        return (c.n < num_leaves) & ~c.turning & ~c.diverging

    def body(c: _SubtreeCarry) -> _SubtreeCarry:
        integ = _one_leapfrog(vg, c.integ, step, inv_mass, free)
        energy = -integ.logp + kinetic(integ.momentum, inv_mass)
        delta = energy - energy0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > DIVERGENCE_THRESHOLD
        leaf_lw = -delta
        accept_stat = jnp.exp(jnp.minimum(0.0, leaf_lw))
        r_sum = c.r_sum + integ.momentum

        # progressive multinomial proposal within the subtree
        total_lw = jnp.logaddexp(c.log_weight, leaf_lw)
        u = jax.random.uniform(jax.random.fold_in(key, c.n), dtype=dtype)
        take = jnp.log(u) < (leaf_lw - total_lw)
        prop = jax.tree.map(
            lambda new, old: jnp.where(take, new, old), integ, c.prop
        )

        n = c.n
        is_even = (n % 2) == 0

        # even leaf: store checkpoint at slot popcount(n).  Written as a
        # broadcast select over the (max_depth+1, dim) stack instead of a
        # scatter — scatters serialize on accelerators.
        slot = _popcount(n)
        slot_ids = jax.lax.broadcasted_iota(jnp.int32, c.r_ckpts.shape, 0)
        write = is_even & (slot_ids == slot)
        r_ckpts = jnp.where(write, integ.momentum[None, :], c.r_ckpts)
        r_sum_ckpts = jnp.where(write, r_sum[None, :], c.r_sum_ckpts)

        # odd leaf: check the spans of size 2,4,...,2^t ending here
        idx_max = _popcount(n >> 1)
        idx_min = idx_max - _trailing_ones(n) + 1

        def check(k, turning):
            rho = r_sum - r_sum_ckpts[k] + r_ckpts[k]
            return turning | _is_turning(inv_mass, rho, r_ckpts[k], integ.momentum)

        turning_here = jax.lax.cond(
            is_even,
            lambda: jnp.asarray(False),
            lambda: jax.lax.fori_loop(idx_min, idx_max + 1, check, False),
        )

        return _SubtreeCarry(
            n=n + 1,
            integ=integ,
            r_ckpts=r_ckpts,
            r_sum_ckpts=r_sum_ckpts,
            r_sum=r_sum,
            prop=prop,
            log_weight=total_lw,
            turning=turning_here,
            diverging=diverging,
            sum_accept=c.sum_accept + accept_stat,
        )

    init = _SubtreeCarry(
        n=jnp.asarray(0, jnp.int32),
        integ=from_state,
        r_ckpts=jnp.zeros((max_tree_depth + 1, dim), dtype),
        r_sum_ckpts=jnp.zeros((max_tree_depth + 1, dim), dtype),
        r_sum=jnp.zeros((dim,), dtype),
        prop=from_state,
        log_weight=jnp.asarray(-jnp.inf, dtype),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        sum_accept=jnp.asarray(0.0, dtype),
    )
    return jax.lax.while_loop(cond, body, init)


def nuts_transition(
    logp: LogDensity,
    state: HMCState,
    max_tree_depth: int = 10,
    free: Array | None = None,
) -> HMCState:
    """One NUTS transition (Hoffman & Gelman 2014, multinomial variant)."""
    dtype = state.position.dtype
    if free is not None:
        free = jnp.asarray(free, dtype=dtype)

        def vg(q):
            v, g = jax.value_and_grad(logp)(q)
            return v, g * free

    else:
        vg = jax.value_and_grad(logp)

    key, key_mom, key_dirs, key_sub, key_merge = jax.random.split(state.rng, 5)
    r0 = sample_momentum(key_mom, state.inv_mass, free)
    energy0 = -state.logp + kinetic(r0, state.inv_mass)

    z0 = IntegratorState(state.position, r0, state.logp, state.grad)
    tree0 = _TreeState(
        left=z0,
        right=z0,
        prop=z0,
        r_sum=r0,
        log_weight=jnp.asarray(0.0, dtype),
        depth=jnp.asarray(0, jnp.int32),
        turning=jnp.asarray(False),
        diverging=jnp.asarray(False),
        sum_accept=jnp.asarray(0.0, dtype),
        num_leaves=jnp.asarray(0, jnp.int32),
    )

    def cond(tree: _TreeState):
        return (tree.depth < max_tree_depth) & ~tree.turning & ~tree.diverging

    def body(tree: _TreeState) -> _TreeState:
        direction = jnp.where(
            jax.random.bernoulli(jax.random.fold_in(key_dirs, tree.depth)), 1, -1
        ).astype(jnp.int32)
        from_state = jax.tree.map(
            lambda l, r: jnp.where(direction > 0, r, l), tree.left, tree.right
        )
        sub = _build_subtree(
            vg,
            from_state,
            jnp.asarray(1, jnp.int32) << tree.depth,
            direction,
            state.step_size,
            state.inv_mass,
            energy0,
            jax.random.fold_in(key_sub, tree.depth),
            max_tree_depth,
            free,
        )
        sum_accept = tree.sum_accept + sub.sum_accept
        num_leaves = tree.num_leaves + sub.n
        ok = ~sub.turning & ~sub.diverging

        # biased progressive sampling across the doubling
        u = jax.random.uniform(jax.random.fold_in(key_merge, tree.depth), dtype=dtype)
        take_new = ok & (jnp.log(u) < (sub.log_weight - tree.log_weight))
        prop = jax.tree.map(
            lambda new, old: jnp.where(take_new, new, old), sub.prop, tree.prop
        )

        new_left = jax.tree.map(
            lambda cur, new: jnp.where(direction > 0, cur, jnp.where(ok, new, cur)),
            tree.left,
            sub.integ,
        )
        new_right = jax.tree.map(
            lambda cur, new: jnp.where(direction > 0, jnp.where(ok, new, cur), cur),
            tree.right,
            sub.integ,
        )
        r_sum = tree.r_sum + jnp.where(ok, sub.r_sum, 0.0)
        turning_total = ok & _is_turning(
            state.inv_mass, r_sum, new_left.momentum, new_right.momentum
        )

        return _TreeState(
            left=new_left,
            right=new_right,
            prop=prop,
            r_sum=r_sum,
            log_weight=jnp.where(ok, jnp.logaddexp(tree.log_weight, sub.log_weight), tree.log_weight),
            depth=tree.depth + 1,
            turning=sub.turning | turning_total,
            diverging=sub.diverging,
            sum_accept=sum_accept,
            num_leaves=num_leaves,
        )

    tree = jax.lax.while_loop(cond, body, tree0)

    accept_prob = tree.sum_accept / jnp.maximum(
        tree.num_leaves.astype(dtype), 1.0
    )
    return state._replace(
        position=tree.prop.position,
        logp=tree.prop.logp,
        grad=tree.prop.grad,
        accept_prob=accept_prob,
        rng=key,
    )


def run_nuts(
    logp: LogDensity,
    position0: Array,
    rng: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_tree_depth: int = 10,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    free: Array | None = None,
) -> Samples:
    """Warmup + sampling as two compiled scans (single chain; vmap for more)."""
    state = init_state(logp, position0, rng, init_step_size, free)
    sched = adapt.build_schedule(num_warmup)

    def wstep(state, flags):
        um, we = flags
        state = nuts_transition(logp, state, max_tree_depth, free)
        state = warmup_step(state, um, we, target_accept)
        return state, None

    if num_warmup > 0:
        state, _ = jax.lax.scan(wstep, state, (sched.update_mass, sched.window_end))
        state = finalize_warmup(state)

    def sstep(state, _):
        state = nuts_transition(logp, state, max_tree_depth, free)
        return state, (state.position, state.logp, state.accept_prob)

    state, (positions, logps, accepts) = jax.lax.scan(
        sstep, state, None, length=num_samples
    )
    return Samples(positions, logps, accepts, state)
