"""Matrix-free iterative LML+gradient vs the exact path at large n.

The exact path (Cholesky + analytic pullback) is O(n^3);
ops/iterative is O(n^2) per CG/Lanczos step and bandwidth-bound — each
iteration streams K from HBM once for the whole probe block.  The
crossover question this bench answers: at what n does ~(cg_iters +
lanczos_iters) * n^2 beat n^3?

Prints one JSON line per configuration with walltimes, the iterative
estimator's value/gradient agreement against the exact path, and CG
iteration counts.

Usage: python benchmarks/iterative_lml.py [--n 16384] [--probes 16]
       [--cg-iters 100] [--lanczos 32] [--compare-exact]
"""

from __future__ import annotations

import argparse
import contextlib
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

enable_compile_cache()


def build(n):
    from gogp.gp.core import GP
    from gogp.kernels import rbf, uniform_noise

    gp = GP(ndim=1, simil=rbf.scaled(), noise=uniform_noise)
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.sort(rng.uniform(0, 100, (n, 1)), axis=0), jnp.float32)
    y = jnp.asarray(
        np.sin(np.asarray(x[:, 0]) / 3.0) + 0.1 * rng.normal(size=n), jnp.float32
    )
    return gp, x, y


def devloop(f, *args, reps=5):
    @jax.jit
    def looped(*args):
        def body(c, _):
            out = f(*jax.tree.map(lambda a: a + jnp.asarray(1e-30, a.dtype) * c, args))
            return sum(jnp.sum(l).astype(jnp.float32) for l in jax.tree.leaves(out)), None

        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=reps)
        return c

    jax.block_until_ready(looped(*args))  # compile
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(looped(*args))
        ts.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--probes", type=int, default=16)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--lanczos", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="default",
                    choices=["default", "tensorfloat32", "float32"])
    ap.add_argument("--compare-exact", action="store_true")
    ap.add_argument("--theta", default="",
                    help="comma-separated log-thetas (scale, lengthscale, "
                    "noise-std); default zeros.  An optimized theta on "
                    "dense inputs is the ill-conditioned stress case")
    ap.add_argument("--precond-rank", type=int, default=0,
                    help="pivoted-Cholesky PCG rank for the solves")
    ap.add_argument("--matfree", action="store_true",
                    help="never materialize K: panel-rematerialized "
                    "matvecs (gp.lml_iterative_matfree) — the route past "
                    "the HBM covariance ceiling")
    ap.add_argument("--panel", type=int, default=2048)
    args = ap.parse_args()
    require_gpu(1, "iterative_lml.py")  # a measurement never falls back to the CPU

    from gogp.models.params import gp_observe
    from gogp.gp.core import lml_iterative, lml_iterative_matfree

    gp, x, y = build(args.n)
    if args.theta:
        v = jnp.asarray([float(s) for s in args.theta.split(",")], jnp.float32)
    else:
        v = jnp.zeros(gp.n_theta, jnp.float32)
    key = jax.random.PRNGKey(args.seed)

    prec = (
        contextlib.nullcontext()
        if args.precision == "default"
        else jax.default_matmul_precision(args.precision)
    )

    def lml_of(v):
        ts = jnp.exp(v)[: gp.n_theta_simil]
        tn = jnp.exp(v)[gp.n_theta_simil :]
        if args.matfree:
            return lml_iterative_matfree(
                gp, ts, tn, x, y, key, panel=args.panel,
                num_probes=args.probes, cg_iters=args.cg_iters,
                lanczos_iters=args.lanczos, precond_rank=args.precond_rank,
            )
        return lml_iterative(
            gp, ts, tn, x, y, key,
            num_probes=args.probes, cg_iters=args.cg_iters,
            lanczos_iters=args.lanczos, precond_rank=args.precond_rank,
        )

    def iter_vg(v):
        with prec:
            return jax.value_and_grad(lml_of)(v)

    it_ms = devloop(iter_vg, v)
    vi, gi = jax.jit(iter_vg)(v)
    out = {
        "metric": f"iterative_lml_grad_n{args.n}",
        "value": round(it_ms, 2),
        "unit": "ms",
        "n": args.n,
        "probes": args.probes,
        "cg_iters": args.cg_iters,
        "lanczos_iters": args.lanczos,
        "precision": args.precision,
        "precond_rank": args.precond_rank,
        "matfree": args.matfree,
        "theta": [round(float(t), 3) for t in np.asarray(v)],
        "lml": round(float(vi), 3),
        "finite": bool(np.isfinite(float(vi)) and np.isfinite(np.asarray(gi)).all()),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }

    if args.compare_exact:
        # like-for-like: the exact leg runs under the same matmul-precision
        # context as the iterative leg
        def exact_vg(v):
            with prec:
                return jax.value_and_grad(lambda v: gp_observe(gp, v, x=x, y=y))(v)

        ex_ms = devloop(exact_vg, v)
        ve, ge = jax.jit(exact_vg)(v)
        out["exact_ms"] = round(ex_ms, 2)
        out["vs_exact"] = round(ex_ms / it_ms, 3)
        out["lml_rel_err"] = round(
            abs(float(vi - ve)) / max(abs(float(ve)), 1e-30), 5
        )
        ge_n, gi_n = np.asarray(ge), np.asarray(gi)
        out["grad_rel_err"] = round(
            float(np.abs(gi_n - ge_n).max() / np.abs(ge_n).max()), 5
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
