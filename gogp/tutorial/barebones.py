"""Case study: bare-bones time-series forecasting (MLE only).

Counterpart of reference tutorial/barebones: a 2-theta scaled-Matérn32
similarity kernel (barebones/kernel/kernel.go:14-18) with uniform noise
scaled by 0.01 (kernel.go:26-31, the "prior-as-scaling" trick), the GP used
directly as the optimization model (barebones/main.go:57 — no priors).

Run:  python -m gogp.tutorial.barebones [flags] selfcheck
"""

from __future__ import annotations

from importlib import resources

from gogp.gp.core import GP
from gogp.kernels import matern32, uniform_noise
from gogp.tutorial.evaluate import Study, run_cli


def make_study() -> Study:
    return Study(
        name="barebones",
        gp=GP(ndim=1, simil=matern32.scaled(), noise=uniform_noise.scaled_by(0.01)),
    )


def selfcheck_data() -> str:
    return (
        resources.files("gogp.tutorial").joinpath("data/sine.csv").read_text()
    )


def main(argv=None):
    return run_cli(
        make_study,
        selfcheck_data(),
        "Bare-bones time series forecasting with gogp (scaled Matern32 + uniform noise).",
        argv=argv,
    )


if __name__ == "__main__":
    main()
