"""Distributed dense linear algebra over the device mesh: blocked Cholesky,
triangular solves, and the large-N GP marginal likelihood.

This is the multi-device answer to the reference's large-N scaling gap
(SURVEY.md §5 "long-context" analogue: its only mechanism is goroutine
row-parallelism over covariance assembly, gp/gp.go:165-213, capped at one
machine).  Layout: the n x n matrix is sharded by *block-rows* over the
mesh's ``data`` axis; each device owns n/D contiguous rows.

Right-looking blocked Cholesky, one ``fori_loop`` step per block column k:

1. the b x b diagonal block is psum-broadcast (owner contributes, others
   send zeros) and factorized redundantly on every device — O(b^2) comm;
2. each device TRSMs its rows of the panel column: L[i,k] = A[i,k] Lkk^-T;
3. the panel (n x b) is all-gathered — the only O(n b) collective — and the
   trailing update A -= L[:,k] L[:,k]^T runs as one local matmul per
   device, masked to the not-yet-factorized columns.

Per-step comm is O(n b) over the interconnect while per-step compute is O(n^2 b / D),
so the update stays compute-bound for n >> D b.  The triangular solves
reuse the same layout with per-block psum pipelining.  All entry points are
``shard_map``-level functions: call them inside shard_map/jit with the
matrix row-sharded on ``axis``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

Array = jax.Array


def _rank(axis: str) -> Array:
    return jax.lax.axis_index(axis)


def cholesky_rowsharded(
    A_local: Array, axis: str, block: int = 256, unroll: bool = False
) -> Array:
    """Blocked right-looking Cholesky of a block-row-sharded SPD matrix.

    ``A_local``: (n_local, n) — this device's contiguous rows.  Returns the
    same rows of the lower factor L (upper triangle zeroed).
    Call inside shard_map with ``A`` sharded P(axis, None).
    """
    n_local, n = A_local.shape
    block = min(block, n_local)
    if n % block != 0 or n_local % block != 0:
        raise ValueError(
            f"block={block} must divide both n={n} and n_local={n_local} "
            "(each b x b diagonal block must live on one device)"
        )
    nb = n // block
    ndev = jax.lax.axis_size(axis)
    rank = _rank(axis)
    row0 = rank * n_local  # first global row owned by this device
    dtype = A_local.dtype

    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n), 1)
    row_ids_local = jax.lax.broadcasted_iota(jnp.int32, (n_local, 1), 0) + row0

    def step(k, A_loc):
        # fori_loop's index is int64 under x64; keep all indices int32
        c0 = jnp.asarray(k * block, jnp.int32)

        # -- 1. diagonal block, psum-broadcast from its owner ------------
        # owner test per local row; every device builds a (block, n) slab of
        # its rows that fall inside global rows [c0, c0+block), zero-padded.
        in_diag = (row_ids_local[:, 0] >= c0) & (row_ids_local[:, 0] < c0 + block)
        # local row index where the diag rows start (clamped; masked anyway)
        local_start = jnp.clip(c0 - row0, 0, n_local - block)
        slab = jax.lax.dynamic_slice(A_loc, (local_start, jnp.int32(0)), (block, n))
        have_all = jnp.all(
            jax.lax.dynamic_slice_in_dim(in_diag, local_start, block, 0)
        )
        slab = jnp.where(have_all, slab, 0.0)
        diag = jax.lax.dynamic_slice(slab, (jnp.int32(0), c0), (block, block))
        diag = jax.lax.psum(diag, axis)
        Lkk = jnp.linalg.cholesky(diag)  # redundant on every device (tiny)

        # -- 2. local panel TRSM: L[i,k] = A[i,k] Lkk^-T ------------------
        A_col = jax.lax.dynamic_slice(A_loc, (jnp.int32(0), c0), (n_local, block))
        # solve X Lkk^T = A_col  =>  Lkk X^T = A_col^T
        panel_local = jax.scipy.linalg.solve_triangular(
            Lkk, A_col.T, lower=True
        ).T
        below = row_ids_local >= c0 + block
        within = (row_ids_local >= c0) & (row_ids_local < c0 + block)
        # rows inside the diagonal block take Lkk's rows; rows above are zero
        lkk_rows = jnp.zeros((n_local, block), dtype)
        my_diag_rows = jnp.clip(row_ids_local[:, 0] - c0, 0, block - 1)
        lkk_rows = jnp.where(within, Lkk[my_diag_rows], lkk_rows)
        panel_local = jnp.where(below, panel_local, lkk_rows)

        # -- 3. all-gather panel; masked trailing update ------------------
        panel = jax.lax.all_gather(panel_local, axis, tiled=True)  # (n, block)
        c1 = None if not isinstance(k, int) else (k + 1) * block
        if c1 is not None and c1 >= n:
            pass  # last block: no trailing submatrix
        elif c1 is not None:
            # unrolled path: k is static, so slice exactly the trailing
            # columns — skips the ~2x wasted FLOPs of the masked full-width
            # form (rows still need the mask: they're distributed)
            update = jax.lax.dot_general(
                panel_local,
                panel[c1:],
                (((1,), (1,)), ((), ())),
                preferred_element_type=dtype,
            )  # (n_local, n - c1)
            update = jnp.where(below, update, 0.0)
            A_loc = A_loc.at[:, c1:].add(-update)
        else:
            # traced k: subtract where BOTH row and column are strictly
            # below the current block column (the trailing submatrix)
            update = jax.lax.dot_general(
                panel_local,
                panel,
                (((1,), (1,)), ((), ())),
                preferred_element_type=dtype,
            )  # (n_local, n)
            trailing = (col_ids >= c0 + block) & below
            A_loc = A_loc - jnp.where(trailing, update, 0.0)

        # write the finished panel column into A (zero above the diagonal)
        keep = row_ids_local >= c0
        col_block = jnp.where(keep, panel_local, 0.0)
        A_loc = jax.lax.dynamic_update_slice(A_loc, col_block, (jnp.int32(0), c0))
        return A_loc

    if unroll:
        for k in range(nb):
            A_local = step(k, A_local)
    else:
        A_local = jax.lax.fori_loop(0, nb, step, A_local)
    # zero the strict upper triangle
    tri = col_ids <= row_ids_local
    return jnp.where(tri, A_local, 0.0)


def solve_lower_rowsharded(L_local: Array, b_local: Array, axis: str, block: int = 256) -> Array:
    """Solve L Y = B with L block-row-sharded; B row-sharded (n_local,) or
    (n_local, m).

    Sequential over block rows; per step one psum of a (block, m) slab.
    """
    vec = b_local.ndim == 1
    if vec:
        b_local = b_local[:, None]
    m = b_local.shape[1]
    n_local, n = L_local.shape
    block = min(block, n_local)
    nb = n // block
    rank = _rank(axis)
    row0 = rank * n_local
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local,), 0) + row0

    def step(k, carry):
        # Trailing-update block substitution: the carry's residual already
        # equals b - L[:, :c0] y[:c0], so the only communication per step
        # is the psum-broadcast of the solved (block, m) block and the
        # (block, block) diagonal tile — O(b m + b^2), never a gather of
        # the full partial solution.
        resid_local, y_local = carry
        c0 = jnp.asarray(k * block, jnp.int32)

        in_blk = (row_ids >= c0) & (row_ids < c0 + block)
        local_start = jnp.clip(c0 - row0, 0, n_local - block)
        have = jnp.all(jax.lax.dynamic_slice_in_dim(in_blk, local_start, block, 0))
        r_slab = jax.lax.dynamic_slice(resid_local, (local_start, jnp.int32(0)), (block, m))
        L_slab = jax.lax.dynamic_slice(L_local, (local_start, c0), (block, block))
        r_blk = jax.lax.psum(jnp.where(have, r_slab, 0.0), axis)
        L_blk = jax.lax.psum(jnp.where(have, L_slab, 0.0), axis)

        y_blk = jax.scipy.linalg.solve_triangular(L_blk, r_blk, lower=True)

        # local trailing update: resid -= L[:, c0:c0+block] @ y_blk.  Rows
        # above the block are untouched automatically (those L columns are
        # zero in the lower triangle).
        L_cols = jax.lax.dynamic_slice(L_local, (jnp.int32(0), c0), (n_local, block))
        resid_local = resid_local - L_cols @ y_blk

        # owner writes the solved block into its local slice
        idx_in_blk = jnp.clip(row_ids - c0, 0, block - 1)
        y_local = jnp.where(in_blk[:, None], y_blk[idx_in_blk], y_local)
        return resid_local, y_local

    y0 = jnp.zeros((n_local, m), L_local.dtype)
    _, out = jax.lax.fori_loop(0, nb, step, (b_local, y0))
    return out[:, 0] if vec else out


def solve_upper_rowsharded(L_local: Array, b_local: Array, axis: str, block: int = 256) -> Array:
    """Solve L^T Y = B with L block-row-sharded (its transpose is
    column-sharded, so each step's off-diagonal contribution is a psum of
    local L-column-slab^T @ x products); B row-sharded (n_local,) or
    (n_local, m).  Proceeds bottom-up over block rows.
    """
    vec = b_local.ndim == 1
    if vec:
        b_local = b_local[:, None]
    m = b_local.shape[1]
    n_local, n = L_local.shape
    block = min(block, n_local)
    nb = n // block
    rank = _rank(axis)
    row0 = rank * n_local
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local,), 0) + row0

    def step(t, x_local):
        k = nb - 1 - t
        c0 = jnp.asarray(k * block, jnp.int32)

        # contribution sum_{j>k} L[j, k-block]^T x_j : local rows > block end
        known = (row_ids >= c0 + block)[:, None]
        x_known = jnp.where(known, x_local, 0.0)  # (n_local, m)
        L_cols = jax.lax.dynamic_slice(
            L_local, (jnp.int32(0), c0), (n_local, block)
        )  # (n_local, block) = my rows of L[:, k-block]
        contrib = jax.lax.dot_general(
            L_cols, x_known, (((0,), (0,)), ((), ())),
            preferred_element_type=L_local.dtype,
        )  # (block, m)
        S = jax.lax.psum(contrib, axis)

        # owner's diagonal tile and rhs rows
        in_blk = (row_ids >= c0) & (row_ids < c0 + block)
        local_start = jnp.clip(c0 - row0, 0, n_local - block)
        have = jnp.all(jax.lax.dynamic_slice_in_dim(in_blk, local_start, block, 0))
        b_slab = jax.lax.dynamic_slice(b_local, (local_start, jnp.int32(0)), (block, m))
        L_slab = jax.lax.dynamic_slice(L_local, (local_start, c0), (block, block))
        b_blk = jax.lax.psum(jnp.where(have, b_slab, 0.0), axis)
        L_blk = jax.lax.psum(jnp.where(have, L_slab, 0.0), axis)

        x_blk = jax.scipy.linalg.solve_triangular(
            L_blk, b_blk - S, lower=True, trans=1
        )
        idx_in_blk = jnp.clip(row_ids - c0, 0, block - 1)
        x_local = jnp.where(in_blk[:, None], x_blk[idx_in_blk], x_local)
        return x_local

    x0 = jnp.zeros((n_local, m), L_local.dtype)
    out = jax.lax.fori_loop(0, nb, step, x0)
    return out[:, 0] if vec else out


def _lml_forward(K_local, y_local, axis, block, unroll=False):
    n_local, n = K_local.shape
    rank = _rank(axis)
    row0 = rank * n_local
    L_local = cholesky_rowsharded(K_local, axis, block, unroll=unroll)
    z_local = solve_lower_rowsharded(L_local, y_local, axis, block)

    row_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local,), 0) + row0
    my_diag = L_local[jnp.arange(n_local), row_ids]
    logdet_half = jax.lax.psum(jnp.sum(jnp.log(my_diag)), axis)
    quad = jax.lax.psum(jnp.sum(z_local * z_local), axis)
    n_f = jnp.asarray(n, K_local.dtype)
    lml = -0.5 * n_f * jnp.log(2.0 * jnp.pi) - logdet_half - 0.5 * quad
    return lml, L_local, z_local


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def lml_rowsharded(
    K_local: Array, y_local: Array, axis: str, block: int = 256, unroll: bool = False
) -> Array:
    """Large-N GP log marginal likelihood with K block-row-sharded.

    L = -(n/2) log 2pi - sum(log diag L) - 1/2 ||L^-1 y||^2  (GPML eq. 5.8,
    reference gp/gp.go:244-253) — note 1/2 log|K| = sum log diag L and
    y^T K^-1 y = ||L^-1 y||^2, so only the forward solve is needed.
    Returns the (replicated) scalar on every device.

    DIFFERENTIABLE: the factorization pipeline is a fori_loop (not
    reverse-differentiable), so the gradient is supplied analytically
    (GPML eq. 5.9):  dL/dK = 1/2 (alpha alpha^T - K^-1),  dL/dy = -alpha,
    with alpha and the row shard of K^-1 computed by the distributed
    triangular solves (two extra O(n^3/D)-per-device solves on the
    backward pass).  This is what lets HMC/NUTS run on the sharded
    large-N log-density.
    """
    lml, _, _ = _lml_forward(K_local, y_local, axis, block, unroll)
    return lml


def _lml_fwd(K_local, y_local, axis, block, unroll):
    lml, L_local, z_local = _lml_forward(K_local, y_local, axis, block, unroll)
    return lml, (L_local, z_local)


def _lml_bwd(axis, block, unroll, res, cot):
    L_local, z_local = res
    n_local, n = L_local.shape
    rank = _rank(axis)
    row0 = rank * n_local

    # Convention: differentiate INSIDE shard_map (each device receives the
    # full scalar cotangent and produces its rows' share of the gradient;
    # parameter gradients downstream need one final psum — see
    # gogp.parallel.large_n.make_rowsharded_value_and_grad).
    # Differentiating the shard_map'd function from the outside with
    # check_vma=False is NOT supported: its transpose splits the cotangent
    # 1/D per device.

    # alpha = K^-1 y = L^-T z
    alpha_local = solve_upper_rowsharded(L_local, z_local, axis, block)
    alpha_full = jax.lax.all_gather(alpha_local, axis, tiled=True)  # (n,)

    # my rows of K^-1: solve K X = I for my one-hot columns, transposed by
    # symmetry.  I_local = my rows of the identity.
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local, n), 1)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (n_local, n), 0) + row0
    eye_local = (col_ids == row_ids).astype(L_local.dtype)
    Z = solve_lower_rowsharded(L_local, eye_local, axis, block)
    Kinv_rows = solve_upper_rowsharded(L_local, Z, axis, block)  # (n_local, n)

    Kbar = cot * 0.5 * (alpha_local[:, None] * alpha_full[None, :] - Kinv_rows)
    ybar = -cot * alpha_local
    return Kbar, ybar


lml_rowsharded.defvjp(_lml_fwd, _lml_bwd)


def make_sharded_lml(mesh: Mesh, axis: str, block: int = 256, unroll: bool = False):
    """jit-compiled entry: (K row-sharded, y row-sharded) -> replicated lml.

    ``unroll=True`` unrolls the factorization's block loop so trailing
    updates slice exactly the remaining columns (saves ~2x of the masked
    full-width FLOPs; costs compile time proportional to n/block)."""
    fn = jax.shard_map(
        lambda K, y: lml_rowsharded(K, y, axis, block, unroll),
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)
