"""Benchmark the rolling-forecast Evaluate protocol: batched vs sequential.

The reference refits serially, one prefix length at a time
(tutorial/tutorial.go:91); this framework runs ALL prefix refits as one
jit(vmap(fit)) program (SURVEY.md §3.1 notes the loop is embarrassingly
parallel, which the reference never exploits).  This measures that
architectural speedup on the hyperpriors selfcheck workload — the
reference's own end-to-end benchmark shape.

Usage: python benchmarks/evaluate_bench.py [--alg adam] [--iters 200]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gogp.utils.compile_cache import enable_compile_cache  # noqa: E402
from gogp.utils.device import require_gpu  # noqa: E402

enable_compile_cache()



def run(alg: str = "adam", iters: int = 200, seed: int = 0):
    import io as _io

    from gogp.tutorial import io as tio
    from gogp.tutorial.evaluate import EvalConfig, evaluate
    from gogp.tutorial.hyperpriors import make_study, selfcheck_data

    study = make_study()
    x, y = tio.load_csv(selfcheck_data())

    def once(batched: bool):
        cfg = EvalConfig(alg=alg, iters=iters, seed=seed, batched=batched)
        t0 = time.perf_counter()
        evaluate(study, x, y, config=cfg, wtr=_io.StringIO())
        return time.perf_counter() - t0

    # warm both compile paths, then time
    once(True)
    t_batched = min(once(True), once(True))
    once(False)
    t_seq = min(once(False), once(False))

    return {
        "metric": "evaluate_hyperpriors_walltime",
        "value": round(t_batched, 3),
        "unit": "s",
        "vs_baseline": round(t_seq / t_batched, 2),
        "baseline": "sequential per-prefix refits (the reference's loop structure)",
        "baseline_s": round(t_seq, 3),
        "n_prefixes": int(x.shape[0]),
        "alg": alg,
        "iters": iters,
        "platform": jax.devices()[0].platform,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--alg", default="adam", choices=["adam", "lbfgs"])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    require_gpu(1, "evaluate_bench.py")  # a measurement never falls back to the CPU
    print(json.dumps(run(args.alg, args.iters, args.seed)))


if __name__ == "__main__":
    main()
