"""Bayesian forecast driver smoke tests (BASELINE.json configs: NUTS over
hyperpriors, ADVI/HMC on anynoise, SMC) — tiny sampler sizes, full pipeline."""

import io

import numpy as np
import pytest

from gogp.tutorial import bayes


def run_driver(args):
    import contextlib
    import sys

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bayes.main(args)
    return buf.getvalue()


@pytest.mark.parametrize(
    "study,engine",
    [
        ("hyperpriors", "nuts"),
        ("hyperpriors", "chees"),
        ("barebones", "smc"),
        ("anynoise", "advi"),
        ("barebones", "ghmc"),
        ("barebones", "advi-full"),
    ],
)
def test_engines_produce_forecast(study, engine):
    out = run_driver(
        [
            study,
            "--engine", engine,
            "--samples", "64",
            "--warmup", "60",
            "--chains", "4" if engine == "ghmc" else "2",
            "--grid", "10",
            "selfcheck",
        ]
    )
    lines = [l for l in out.strip().splitlines() if l and not l.startswith("#")]
    assert len(lines) == 10
    vals = np.asarray([[float(v) for v in l.split(",")] for l in lines])
    # z, nan, mu, sigma
    assert vals.shape[1] == 4
    assert np.all(np.isnan(vals[:, 1]))
    assert np.all(np.isfinite(vals[:, 2]))
    assert np.all(vals[:, 3] >= 0)
    assert any(l.startswith("# posterior theta mean") for l in out.splitlines())


def test_pt_chees_engine_produces_forecast():
    """--engine pt-chees: tempered ChEES ladders through the same
    forecast pipeline (small ladder: 2 ladders x 3 rungs)."""
    out = run_driver(
        [
            "barebones",
            "--engine", "pt-chees",
            "--samples", "32",
            "--warmup", "40",
            "--chains", "2",
            "--replicas", "3",
            "--grid", "10",
            "selfcheck",
        ]
    )
    lines = [l for l in out.strip().splitlines() if l and not l.startswith("#")]
    assert len(lines) == 10
    vals = np.asarray([[float(v) for v in l.split(",")] for l in lines])
    assert np.all(np.isfinite(vals[:, 2]))
    assert np.all(vals[:, 3] >= 0)


def test_warpedtime_full_joint():
    """BASELINE config: warped-input full joint inference — latent inputs
    sampled alongside thetas (free-mask pins first/last input + outputs)."""
    out = run_driver(
        [
            "warpedtime",
            "--engine", "nuts",
            "--samples", "32",
            "--warmup", "40",
            "--chains", "2",
            "--grid", "8",
            "selfcheck",
        ]
    )
    lines = [l for l in out.strip().splitlines() if l and not l.startswith("#")]
    assert len(lines) == 8
    vals = np.asarray([[float(v) for v in l.split(",")] for l in lines])
    assert np.all(np.isfinite(vals[:, 2]))
    assert np.all(vals[:, 3] >= 0)
