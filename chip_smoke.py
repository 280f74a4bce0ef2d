"""Drive the exact-GP main path once on the GPU and check every phase.

Run from the repository root:

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # four cards: the sharded paths only

One card runs, in one process: the LML and its gradient at n=4096 and
n=16384 in float32, 20 Adam steps at both sizes, the hyperpriors posterior
under ChEES (64 chains) and NUTS, serving at n=4096 on 1024 test points,
and the barebones tutorial CLI with ``--platform gpu``.  ``--multi`` runs
sharded ChEES and NUTS on a 4x1 chain mesh against the single-device
engines and ChEES on the sharded hyperpriors posterior, and the row-sharded LML plus gradient at n=16384 on a 1x4 data
mesh against one card.

Each phase prints one ``PHASE`` line: its error against a plain float64
reference (dense ``jnp`` on the same card, independent of ``ops/linalg``),
the tolerance and why, the matmul precision, compile time apart from steady
time, and the card's name and power limit.  A phase outside its tolerance
fails the run.  The last line of standard output is one JSON object, printed
only when every phase passed.  Without a GPU the script exits non-zero
before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "forecast_barebones.csv"
LOG_2PI = math.log(2.0 * math.pi)

# (bound, reason) for every comparison a phase makes.
TOL = {
    "lml_value": (1e-5, "float32 Cholesky of a well-conditioned K: relative error ~sqrt(n) eps"),
    "lml_grad": (1e-4, "max abs gradient error over max |g|; the trace term sums n^2 float32 products"),
    "adam_x": (1e-4, "20 Adam steps of size <= 0.01 from the same start; float32 gradients"),
    "logp": (1e-4, "abs error over max(1, |logp|); float32 Cholesky of the n=44 hyperpriors "
                   "covariance, noise scaled by 0.01 (8e-6 measured on an H100 at 400 W)"),
    "serve": (1e-4, "abs error of mu and sigma; TF32 products measured 2.4e-3 on sigma"),
    "cli": (1e-5, "rtol and atol of tests/test_forecast_goldens.py (float64 on both sides)"),
    "chains": (1e-6, "float64 chains; only the reduction order of cross-chain means differs"),
    "sharded_lml": (1e-5, "relative; float32 at 'highest', distributed vs cuSOLVER factorization"),
    "sharded_grad": (1e-4, "max abs gradient error over max |g| at 'highest'"),
}


# --- shared helpers ----------------------------------------------------------


def emit(name: str, ok: bool, card: str, **fields) -> dict:
    """Print one PHASE line and return the phase's record."""
    parts = [f"PHASE {name}", f"ok={ok}"]
    for k, v in fields.items():
        parts.append(f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}")
    parts.append(f'card="{card}"')
    print(" ".join(parts), flush=True)
    return {"phase": name, "ok": ok, **fields}


def compile_timed(fn, *args):
    """(compiled, seconds) for a jitted ``fn`` at ``args``."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def steady_ms(fn, *args, reps: int = 5) -> float:
    """Median wall milliseconds of ``fn(*args)`` after one warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def f64_ops(fn, *args) -> tuple[int, int]:
    """(array, scalar) counts of operations in ``fn``'s jaxpr, sub-jaxprs
    included, that produce a float64 value.  With x64 on, Python-float
    constants and optax's bias correction stay float64 scalars; an f64
    array in a float32 step is a leak."""
    import jax
    import numpy as np
    from jax.extend import core as jcore

    def subjaxprs(params):
        for p in params.values():
            for q in p if isinstance(p, (tuple, list)) else (p,):
                if isinstance(q, jcore.ClosedJaxpr):
                    yield q.jaxpr
                elif isinstance(q, jcore.Jaxpr):
                    yield q

    counts = [0, 0]

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            for v in eqn.outvars:
                if getattr(v.aval, "dtype", None) == np.float64:
                    counts[v.aval.shape == ()] += 1
            for sub in subjaxprs(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return counts[0], counts[1]


def memory_fields(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "unavailable"
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return ",".join(f"{k.replace('_size_in_bytes', '')}:{getattr(ma, k, None)}" for k in keys)


def rel_grad_err(g, g_ref) -> float:
    import numpy as np

    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    return float(np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)))


# --- problems and float64 references -------------------------------------


def rbf_problem(n: int, seed: int):
    """bench.py's exact GP as float64 numpy arrays: (gp, x, y)."""
    import jax.numpy as jnp
    import numpy as np

    from bench import build_problem

    gp, x, y, _ = build_problem(n, jnp.float64, seed)
    return gp, np.asarray(x), np.asarray(y)


def ref_rbf_cov(v, xa, xb=None):
    """s exp(-(xa-xb)^2 / 2l^2) (+ sn^2 I when xb is None), v = log(s, l, sn)."""
    import jax.numpy as jnp

    s, l, sn = jnp.exp(v[0]), jnp.exp(v[1]), jnp.exp(v[2])
    same = xb is None
    xb = xa if same else xb
    d = (xa[:, 0][:, None] - xb[:, 0][None, :]) / l
    k = s * jnp.exp(-0.5 * d * d)
    if same:
        k = k + sn * sn * jnp.eye(xa.shape[0], dtype=k.dtype)
    return k


def ref_lml_dense(K, y):
    """-1/2 (y^T K^-1 y + log|K| + n log 2pi) through LU, in K's dtype."""
    import jax.numpy as jnp

    _, logdet = jnp.linalg.slogdet(K)
    return -0.5 * (y @ jnp.linalg.solve(K, y) + logdet + y.shape[0] * LOG_2PI)


def ref_rbf_lml(v, x, y):
    return ref_lml_dense(ref_rbf_cov(v, x), y)


def hyperpriors_logps(dtype):
    """(logp in ``dtype`` through gp_observe, float64 dense reference, dim)
    for the hyperpriors posterior on trend_season.csv."""
    import jax.numpy as jnp

    from gogp.gp.core import masked_cov
    from gogp.models.params import gp_observe
    from gogp.tutorial import io as tio
    from gogp.tutorial.hyperpriors import make_priors, make_study, selfcheck_data

    gp = make_study().gp
    x, y = tio.load_csv(selfcheck_data())
    y, _, _ = tio.normalize(y)
    priors = make_priors(x, y)
    xj, yj = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    mask = jnp.ones(x.shape[0], dtype)
    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    nts = gp.n_theta_simil

    def logp(v):
        return gp_observe(gp, v, x=xj, y=yj, mask=mask) + priors(v, mask)

    def ref(v):
        th = jnp.exp(v)
        K = masked_cov(gp, th[:nts], th[nts:], x64, None)
        return ref_lml_dense(K, y64) + priors(v, jnp.ones_like(y64))

    return logp, ref, gp.n_theta


# --- one-card phases ---------------------------------------------------------


def phase_lml(n: int, seed: int, card: str, reps: int = 5) -> dict:
    """jit(value_and_grad(gp_observe)) in float32 against the f64 reference."""
    import jax
    import jax.numpy as jnp

    from gogp.models.params import gp_observe

    gp, x, y = rbf_problem(n, seed)
    x32, y32 = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    v32 = jnp.zeros(gp.n_theta, jnp.float32)

    def obj(v, x, y):
        return gp_observe(gp, v, x=x, y=y)

    step = jax.jit(jax.value_and_grad(obj))
    leak = f64_ops(step, v32, x32, y32)[0] > 0
    compiled, compile_s = compile_timed(step, v32, x32, y32)
    val, g = compiled(v32, x32, y32)
    ms = steady_ms(compiled, v32, x32, y32, reps=reps)
    with jax.default_matmul_precision("highest"):
        val_hi, g_hi = jax.jit(jax.value_and_grad(obj))(v32, x32, y32)

    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    rv, rg = jax.jit(jax.value_and_grad(ref_rbf_lml))(jnp.zeros(3, jnp.float64), x64, y64)
    rv = float(rv)
    err_v = abs(float(val) - rv) / abs(rv)
    err_g = rel_grad_err(g, rg)
    err_v_hi = abs(float(val_hi) - rv) / abs(rv)
    err_g_hi = rel_grad_err(g_hi, rg)
    ok = (not leak and err_v <= TOL["lml_value"][0] and err_g <= TOL["lml_grad"][0]
          and err_v_hi <= TOL["lml_value"][0] and err_g_hi <= TOL["lml_grad"][0])
    return emit(
        f"lml_grad_n{n}", ok, card, dtype="float32", f64_array_in_jaxpr=leak,
        value_rel_err=err_v, grad_err=err_g,
        value_rel_err_at_highest=err_v_hi, grad_err_at_highest=err_g_hi,
        tol_value=TOL["lml_value"][0], tol_grad=TOL["lml_grad"][0],
        why=f'"{TOL["lml_value"][1]}; {TOL["lml_grad"][1]}"',
        precision='"JAX default for the step; backward W^T W pinned to highest"',
        compile_s=compile_s, steady_ms=ms, memory=memory_fields(compiled),
    )


def phase_train(n: int, seed: int, card: str, steps: int = 20, rate: float = 0.01) -> dict:
    """``steps`` infer.mle.adam steps in float32 against optax Adam driven
    by the float64 reference gradient."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from gogp.infer import mle
    from gogp.models.params import gp_observe

    gp, x, y = rbf_problem(n, seed)
    x32, y32 = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    v32 = jnp.zeros(gp.n_theta, jnp.float32)
    vg = jax.value_and_grad(lambda v, x, y: gp_observe(gp, v, x=x, y=y))

    @jax.jit
    def train(v0, x, y):
        return mle.adam(lambda v: vg(v, x, y), v0, iters=steps, rate=rate, threshold=0.0)

    leak = f64_ops(train, v32, x32, y32)[0] > 0
    compiled, compile_s = compile_timed(train, v32, x32, y32)
    res = compiled(v32, x32, y32)
    ms = steady_ms(compiled, v32, x32, y32, reps=2) / steps

    x64, y64 = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    ref_vg = jax.jit(jax.value_and_grad(ref_rbf_lml))
    opt = optax.adam(rate)
    v = jnp.zeros(3, jnp.float64)
    state = opt.init(v)
    for _ in range(steps):
        _, g = ref_vg(v, x64, y64)
        upd, state = opt.update(-g, state, v)
        v = optax.apply_updates(v, upd)
    err = float(np.max(np.abs(np.asarray(res.x, np.float64) - np.asarray(v))))
    moved = float(np.max(np.abs(np.asarray(v))))
    ok = (not leak and int(res.iters) == steps and err <= TOL["adam_x"][0]
          and bool(np.all(np.isfinite(np.asarray(res.x)))))
    return emit(
        f"adam{steps}_n{n}", ok, card, dtype="float32", f64_array_in_jaxpr=leak,
        steps=int(res.iters), x_abs_err=err, ref_moved=moved,
        tol=TOL["adam_x"][0], why=f'"{TOL["adam_x"][1]}"',
        precision='"JAX default"', compile_s=compile_s, steady_ms_per_step=ms,
    )


def phase_sampling(seed: int, card: str, chains: int = 64, warmup: int = 200,
                   samples: int = 32, nuts_warmup: int = 20, nuts_samples: int = 8) -> list[dict]:
    """ChEES over ``chains`` chains and a few single-chain NUTS transitions
    on the float32 hyperpriors posterior; logps at the draws checked
    against the float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gogp import infer

    logp, ref, dim = hyperpriors_logps(jnp.float32)
    ref_v = jax.jit(jax.vmap(ref))
    key = jax.random.PRNGKey(seed)
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), (chains, dim), jnp.float32)

    def logp_err(pos, lps):
        pos = np.asarray(pos, np.float64).reshape(-1, dim)
        lps = np.asarray(lps, np.float64).reshape(-1)
        want = np.asarray(ref_v(jnp.asarray(pos)))
        return float(np.max(np.abs(lps - want) / np.maximum(1.0, np.abs(want))))

    out = []
    chees = jax.jit(lambda x0, key: infer.run_chees(
        logp, x0, key, num_warmup=warmup, num_samples=samples))
    leak = f64_ops(chees, x0, key)[0] > 0
    compiled, compile_s = compile_timed(chees, x0, key)
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(x0, key))
    run_s = time.perf_counter() - t0
    pos = np.asarray(res.positions)
    err = logp_err(res.positions[-1], res.logps[-1])
    ok = (not leak and pos.shape == (samples, chains, dim) and bool(np.all(np.isfinite(pos)))
          and err <= TOL["logp"][0])
    out.append(emit(
        f"chees_c{chains}_w{warmup}_s{samples}", ok, card, dtype="float32",
        f64_array_in_jaxpr=leak, shape=list(pos.shape), accept_mean=float(np.mean(res.accept_probs)),
        logp_err=err, tol=TOL["logp"][0], why=f'"{TOL["logp"][1]}"',
        precision='"JAX default"', compile_s=compile_s, steady_s=run_s,
    ))

    v0 = jnp.zeros(dim, jnp.float32)
    nuts = jax.jit(lambda v0, key: infer.run_nuts(
        logp, v0, key, num_warmup=nuts_warmup, num_samples=nuts_samples))
    leak = f64_ops(nuts, v0, key)[0] > 0
    compiled, compile_s = compile_timed(nuts, v0, key)
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(v0, key))
    run_s = time.perf_counter() - t0
    pos = np.asarray(res.positions)
    err = logp_err(res.positions, res.logps)
    ok = (not leak and pos.shape == (nuts_samples, dim) and bool(np.all(np.isfinite(pos)))
          and err <= TOL["logp"][0])
    out.append(emit(
        f"nuts_w{nuts_warmup}_s{nuts_samples}", ok, card, dtype="float32",
        f64_array_in_jaxpr=leak, shape=list(pos.shape), accept_mean=float(np.mean(res.accept_probs)),
        logp_err=err, tol=TOL["logp"][0], why=f'"{TOL["logp"][1]}"',
        precision='"JAX default"', compile_s=compile_s, steady_s=run_s,
    ))
    return out


def phase_serving(n: int, m: int, seed: int, card: str) -> dict:
    """fit_serving + serve_predict in float32 against a direct float64 solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gogp.gp import serve
    from gogp.ops import linalg

    gp, x, y = rbf_problem(n, seed)
    x32, y32 = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    z = np.linspace(-1.0, 101.0, m)[:, None]
    z32 = jnp.asarray(z, jnp.float32)
    one = jnp.ones(1, jnp.float32)
    fit = jax.jit(lambda x, y: serve.fit_serving(gp, jnp.ones(2, jnp.float32), one, x, y))
    predict = jax.jit(lambda sp, z: serve.serve_predict(gp, sp, z))
    predict_default = jax.jit(lambda sp, z: serve.serve_predict(gp, sp, z, precision=None))

    fit_c, fit_s = compile_timed(fit, x32, y32)
    sp = fit_c(x32, y32)
    leak = f64_ops(fit, x32, y32)[0] + f64_ops(predict, sp, z32)[0] > 0
    pred_c, pred_s = compile_timed(predict, sp, z32)
    mu, sigma = pred_c(sp, z32)
    mu_d, sigma_d = predict_default(sp, z32)
    fit_ms = steady_ms(fit_c, x32, y32, reps=3)
    ms = steady_ms(pred_c, sp, z32, reps=20)

    x64, y64, z64 = (jnp.asarray(a, jnp.float64) for a in (x, y, z))
    v0 = jnp.zeros(3, jnp.float64)
    K = ref_rbf_cov(v0, x64)
    Ks = ref_rbf_cov(v0, x64, z64)
    mu_ref = Ks.T @ jnp.linalg.solve(K, y64)
    var_ref = 1.0 - jnp.sum(Ks * jnp.linalg.solve(K, Ks), axis=0)
    sigma_ref = np.sqrt(np.maximum(np.asarray(var_ref), 0.0))
    mu_ref = np.asarray(mu_ref)
    err_mu = float(np.max(np.abs(np.asarray(mu, np.float64) - mu_ref)))
    err_sigma = float(np.max(np.abs(np.asarray(sigma, np.float64) - sigma_ref)))
    err_sigma_d = float(np.max(np.abs(np.asarray(sigma_d, np.float64) - sigma_ref)))
    ok = not leak and err_mu <= TOL["serve"][0] and err_sigma <= TOL["serve"][0]
    return emit(
        f"serve_n{n}_m{m}", ok, card, dtype="float32", f64_array_in_jaxpr=leak,
        mu_abs_err=err_mu, sigma_abs_err=err_sigma, sigma_abs_err_at_default=err_sigma_d,
        tol=TOL["serve"][0], why=f'"{TOL["serve"][1]}"',
        precision=f'"serve products {linalg.ACCURATE_PRECISION}"',
        compile_s=fit_s + pred_s, fit_steady_ms=fit_ms, serve_steady_ms=ms,
    )


def phase_cli(platform: str, card: str) -> dict:
    """The barebones tutorial CLI in-process, rows against the golden CSV."""
    import numpy as np

    from gogp.tutorial import barebones

    argv = ["--platform", platform, "--seed", "0", "--iters", "200", "selfcheck"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, result = barebones.main(argv)
    wall = time.perf_counter() - t0
    got = np.asarray([[float(v) for v in row] for row in result.rows])
    want = np.loadtxt(FIXTURE, delimiter=",")
    tol = TOL["cli"][0]
    same_shape = got.shape == want.shape
    err = float(np.nanmax(np.abs(got - want))) if same_shape else float("inf")
    ok = same_shape and bool(np.allclose(got, want, rtol=tol, atol=tol, equal_nan=True))
    return emit(
        "cli_barebones", ok, card, dtype="float64", rows=got.shape[0], max_abs_err=err,
        tol=tol, why=f'"{TOL["cli"][1]}"', precision='"JAX default"',
        wall_s_with_compile=wall,
    )


# --- four-card phases --------------------------------------------------------


def gaussian_logp(v):
    """The 2-D correlated Gaussian of tests/test_parallel.py."""
    import jax.numpy as jnp

    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.5]], v.dtype)
    d = v - jnp.asarray([1.0, -2.0], v.dtype)
    return -0.5 * d @ jnp.linalg.solve(cov, d)


def _timed_run(fn, *args):
    """(result, compile seconds, run seconds) of a jitted ``fn``."""
    import jax

    c, compile_s = compile_timed(fn, *args)
    t0 = time.perf_counter()
    out = jax.block_until_ready(c(*args))
    return out, compile_s, time.perf_counter() - t0


def phase_sharded_chains(devices, seed: int, card: str, chains: int = 64,
                         warmup: int = 64, samples: int = 16, nuts_chains: int = 8,
                         nuts_warmup: int = 16, nuts_samples: int = 8) -> list[dict]:
    """run_chees_sharded / run_nuts_sharded on a (len(devices) x 1) chain
    mesh.  Against the single-device engines with the same key on the
    float64 Gaussian of tests/test_parallel.py: a GP posterior is chaotic
    enough that 1e-12 differences in the sharded logp (another batch size
    per device, another fusion) change NUTS trees, so the chain-for-chain
    equivalence is checked where it is exact.  Then ChEES over ``chains``
    chains of the float32 hyperpriors posterior, sharded, with its logps
    at the draws checked against the float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gogp import infer, parallel

    key = jax.random.PRNGKey(seed)
    mesh = parallel.make_mesh(n_chain=len(devices), n_data=1, devices=list(devices))
    mesh1 = parallel.make_mesh(n_chain=1, n_data=1, devices=[devices[0]])
    tol, why = TOL["chains"]
    tag = f"{len(devices)}x1"
    out = []

    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1), (chains, 2), jnp.float64)
    kw = dict(num_warmup=warmup, num_samples=samples)
    r4, c4, s4 = _timed_run(jax.jit(
        lambda x0, key: parallel.run_chees_sharded(gaussian_logp, x0, key, mesh, **kw)), x0, key)
    r1, c1, s1 = _timed_run(jax.jit(
        lambda x0, key: infer.run_chees(gaussian_logp, x0, key, **kw)), x0, key)
    p4, p1 = np.asarray(r4.positions), np.asarray(r1.positions)
    err = float(np.max(np.abs(p4 - p1)))
    ok = p4.shape == (samples, chains, 2) and bool(np.all(np.isfinite(p4))) and err <= tol
    out.append(emit(
        f"chees_sharded_{tag}_vs_run_chees", ok, card, dtype="float64", target="gaussian",
        max_abs_diff=err, tol=tol, why=f'"{why}"', precision='"JAX default"',
        compile_s_sharded=c4, steady_s_sharded=s4, compile_s_single=c1, steady_s_single=s1,
    ))

    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 2), (nuts_chains, 2), jnp.float64)
    kw = dict(num_warmup=nuts_warmup, num_samples=nuts_samples)
    r4, c4, s4 = _timed_run(jax.jit(
        lambda x0, key: parallel.run_nuts_sharded(gaussian_logp, x0, key, mesh, **kw)), x0, key)
    r1, c1, s1 = _timed_run(jax.jit(
        lambda x0, key: parallel.run_nuts_sharded(gaussian_logp, x0, key, mesh1, **kw)), x0, key)
    p4, p1 = np.asarray(r4.positions), np.asarray(r1.positions)
    err = float(np.max(np.abs(p4 - p1)))
    ok = p4.shape == (nuts_chains, nuts_samples, 2) and bool(np.all(np.isfinite(p4))) and err <= tol
    out.append(emit(
        f"nuts_sharded_{tag}_vs_1x1", ok, card, dtype="float64", target="gaussian",
        max_abs_diff=err, tol=tol, why=f'"{why}"', precision='"JAX default"',
        compile_s_sharded=c4, steady_s_sharded=s4, compile_s_single=c1, steady_s_single=s1,
    ))

    logp, ref, dim = hyperpriors_logps(jnp.float32)
    x0 = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 3), (chains, dim), jnp.float32)
    kw = dict(num_warmup=warmup, num_samples=samples)
    res, cs, ss = _timed_run(jax.jit(
        lambda x0, key: parallel.run_chees_sharded(logp, x0, key, mesh, **kw)), x0, key)
    pos = np.asarray(res.positions)
    want = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(pos[-1], jnp.float64)))
    err = float(np.max(np.abs(np.asarray(res.logps[-1], np.float64) - want)
                       / np.maximum(1.0, np.abs(want))))
    ok = pos.shape == (samples, chains, dim) and bool(np.all(np.isfinite(pos))) and err <= TOL["logp"][0]
    out.append(emit(
        f"chees_sharded_{tag}_hyperpriors_c{chains}", ok, card, dtype="float32",
        accept_mean=float(np.mean(res.accept_probs)), logp_err=err, tol=TOL["logp"][0],
        why=f'"{TOL["logp"][1]}"', precision='"JAX default"', compile_s=cs, steady_s=ss,
    ))
    return out


def phase_sharded_lml(devices, n: int, seed: int, card: str, block: int = 256) -> list[dict]:
    """make_sharded_lml and the row-sharded value+gradient on a
    (1 x len(devices)) data mesh against one card, float32.  Gated at
    'highest'; the JAX-default run is reported beside it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gogp import parallel
    from gogp.gp.core import masked_cov
    from gogp.models.params import gp_observe
    from gogp.ops import linalg
    from gogp.ops.distributed import make_sharded_lml
    from gogp.parallel import DATA_AXIS
    from gogp.parallel.large_n import make_rowsharded_logp, make_rowsharded_value_and_grad

    gp, x, y = rbf_problem(n, seed)
    mesh = parallel.make_mesh(n_chain=1, n_data=len(devices), devices=list(devices))
    rows_sh = NamedSharding(mesh, P(DATA_AXIS, None))
    vec_sh = NamedSharding(mesh, P(DATA_AXIS))
    dev0 = devices[0]
    x32 = jax.device_put(jnp.asarray(x, jnp.float32), dev0)
    y32 = jax.device_put(jnp.asarray(y, jnp.float32), dev0)
    v32 = jnp.zeros(gp.n_theta, jnp.float32)
    mask = jnp.ones(n, jnp.float32)

    def device_vg(x_local, y_local, m_local, v):
        x_full = jax.lax.all_gather(x_local, DATA_AXIS, tiled=True)
        logp = make_rowsharded_logp(gp, x_local, x_full, y_local, m_local, DATA_AXIS, block)
        return make_rowsharded_value_and_grad(logp)(v)

    sharded_vg = jax.jit(jax.shard_map(
        device_vg, mesh=mesh, in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS), P()),
        out_specs=(P(), P()), check_vma=False))
    single_vg = jax.jit(jax.value_and_grad(lambda v, x, y: gp_observe(gp, v, x=x, y=y)))
    sharded_lml = make_sharded_lml(mesh, DATA_AXIS, block)

    K = jax.jit(lambda x: masked_cov(gp, jnp.ones(2, jnp.float32), jnp.ones(1, jnp.float32), x, None))(x32)
    K_sh, y_sh = jax.device_put(K, rows_sh), jax.device_put(y32, vec_sh)
    xs, ms = jax.device_put(x32, rows_sh), jax.device_put(mask, vec_sh)

    out = []
    for prec in ("highest", None):
        with jax.default_matmul_precision(prec):
            lml_c, lml_cs = compile_timed(sharded_lml, K_sh, y_sh)
            core_c, core_cs = compile_timed(jax.jit(linalg.lml_core), K, y32)
            svg_c, svg_cs = compile_timed(sharded_vg, xs, y_sh, ms, v32)
            vg_c, vg_cs = compile_timed(single_vg, v32, x32, y32)
        # lml_rowsharded carries the -n/2 log 2pi that lml_core leaves out
        got_core = float(lml_c(K_sh, y_sh))
        want_core = float(core_c(K, y32)) - 0.5 * n * LOG_2PI
        (sv, sg), (wv, wg) = svg_c(xs, y_sh, ms, v32), vg_c(v32, x32, y32)
        err_core = abs(got_core - want_core) / abs(want_core)
        err_v = abs(float(sv) - float(wv)) / abs(float(wv))
        err_g = rel_grad_err(sg, wg)
        gated = prec == "highest"
        ok = (not gated) or (err_core <= TOL["sharded_lml"][0] and err_v <= TOL["sharded_lml"][0]
                             and err_g <= TOL["sharded_grad"][0])
        out.append(emit(
            f"lml_rowsharded_1x{len(devices)}_n{n}_{prec or 'default'}", ok, card,
            dtype="float32", gated=gated, core_value_rel_err=err_core,
            value_rel_err=err_v, grad_err=err_g, tol_value=TOL["sharded_lml"][0],
            tol_grad=TOL["sharded_grad"][0],
            why=f'"{TOL["sharded_lml"][1]}; {TOL["sharded_grad"][1]}"',
            precision=f'"{prec or "JAX default"}"',
            compile_s_sharded=lml_cs + svg_cs, compile_s_single=core_cs + vg_cs,
            steady_ms_sharded_lml=steady_ms(lml_c, K_sh, y_sh),
            steady_ms_single_lml=steady_ms(core_c, K, y32),
            steady_ms_sharded_vg=steady_ms(svg_c, xs, y_sh, ms, v32),
            steady_ms_single_vg=steady_ms(vg_c, v32, x32, y32),
        ))
    return out


# --- entry point ---------------------------------------------------------


def ok_line(device, count: int) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind, "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: sharded chains and the row-sharded LML only")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1

    from gogp.utils.device import query_cards, require_gpu

    cards, smi_raw = query_cards()  # before JAX touches the card

    import jax

    jax.config.update("jax_enable_x64", True)  # for the float64 references only
    devices = require_gpu(count, "chip_smoke")
    if len(cards) < count:
        raise SystemExit(f"chip_smoke: no card name and power limit ({smi_raw})")

    from gogp.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    d0 = devices[0]
    card = f"{cards[0][0]}, {cards[0][1]}"
    print(f"jax {jax.__version__}; platform {d0.platform}; device_kind {d0.device_kind}; "
          f"devices {len(jax.devices())}; compile cache {cache}", flush=True)
    for i, (name, power) in enumerate(cards):
        print(f"card {i}: name {name}; power limit {power}", flush=True)
    print(smi_raw.splitlines()[0], flush=True)

    results = []
    if args.multi:
        results += phase_sharded_chains(devices, args.seed, card)
        results += phase_sharded_lml(devices, 16384, args.seed, card)
        for d in devices:
            stats = d.memory_stats() or {}
            print(f"device {d.id}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}", flush=True)
    else:
        for n in (4096, 16384):
            results.append(phase_lml(n, args.seed, card))
        for n in (4096, 16384):
            results.append(phase_train(n, args.seed, card))
        results += phase_sampling(args.seed, card)
        results.append(phase_serving(4096, 1024, args.seed, card))
        results.append(phase_cli("gpu", card))
        stats = d0.memory_stats() or {}
        print(f"device {d0.id}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}", flush=True)

    failed = [r["phase"] for r in results if not r["ok"]]
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr, flush=True)
        return 1
    print(ok_line(d0, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
