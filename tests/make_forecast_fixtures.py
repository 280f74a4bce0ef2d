"""Regenerate the committed forecast-golden fixtures.

Run from the repo root after an INTENTIONAL protocol change:

    python tests/make_forecast_fixtures.py

Each fixture is the full rolling-forecast CSV of one tutorial study on its
selfcheck dataset with --seed 0, lbfgs, iters=200, CPU float64 — exactly
what tests/test_forecast_goldens.py re-runs.  With the explicit seed the
batched Evaluate is deterministic, so these pin the *numeric* protocol
(normalization, jittered re-init, masking, optimizer, prediction), the
counterpart of the reference's selfcheck smoke runs + gp_test.go goldens
(tutorial/Makefile; gp/gp_test.go:52-64,191-229).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"

# (name, study factory thunk)
def studies():
    from gogp.tutorial import anynoise, barebones, events, hyperpriors, warpedtime
    from gogp.tutorial.events import parse_events

    return [
        ("barebones", barebones.make_study, barebones.selfcheck_data),
        ("hyperpriors", hyperpriors.make_study, hyperpriors.selfcheck_data),
        ("warpedtime", warpedtime.make_study, warpedtime.selfcheck_data),
        ("anynoise", anynoise.make_study, anynoise.selfcheck_data),
        (
            "events",
            lambda: events.make_study(parse_events("1.0:1.0:0.5,4.2:6.7:0.25")),
            events.selfcheck_data,
        ),
    ]


def run_study(factory, data_fn):
    from gogp.tutorial import io as tio
    from gogp.tutorial.evaluate import EvalConfig, evaluate

    x, y = tio.load_csv(data_fn())
    cfg = EvalConfig(alg="lbfgs", iters=200, seed=0, out_of_sample=False)
    return evaluate(factory(), x, y, config=cfg)


def main():
    FIXTURE_DIR.mkdir(exist_ok=True)
    for name, factory, data_fn in studies():
        result = run_study(factory, data_fn)
        path = FIXTURE_DIR / f"forecast_{name}.csv"
        with open(path, "w") as f:
            for row in result.rows:
                f.write(",".join(f"{float(v):.10g}" for v in row) + "\n")
        print(f"wrote {path} ({len(result.rows)} rows)")


if __name__ == "__main__":
    main()
