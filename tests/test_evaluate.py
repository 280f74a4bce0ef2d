"""Tests for the rolling-forecast driver and the five case studies.

The reference's integration level is Makefile selfchecks run twice, serial
and parallel (SURVEY.md §4.3).  Here the corresponding invariant is
batched-vmap vs sequential equivalence, plus behavioural checks the
reference never asserts programmatically.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from gogp.tutorial import anynoise, barebones, events, hyperpriors, warpedtime
from gogp.tutorial.evaluate import EvalConfig, evaluate
from gogp.tutorial.io import load_csv, normalize

CFG = dict(iters=40, seed=3)


def _sine(n=8):
    x = np.linspace(0, 3, n)
    y = np.sin(x) + 0.05 * np.cos(9 * x)
    return x.reshape(-1, 1), y


def test_batched_matches_sequential():
    x, y = _sine()
    study = barebones.make_study()
    r_b = evaluate(study, x, y, config=EvalConfig(batched=True, **CFG))
    r_s = evaluate(study, x, y, config=EvalConfig(batched=False, **CFG))
    np.testing.assert_allclose(
        np.asarray(r_b.rows, dtype=float),
        np.asarray(r_s.rows, dtype=float),
        rtol=1e-8,
        atol=1e-8,
    )


def test_rows_schema_and_lml_improves():
    x, y = _sine()
    study = barebones.make_study()
    res = evaluate(study, x, y, config=EvalConfig(**CFG))
    rows = np.asarray(res.rows, dtype=float)
    # schema: x, y_true, mu, sigma, lml0, lml, exp(theta) x3
    assert rows.shape == (8, 1 + 5 + 3)
    # y_true column is the denormalized original
    np.testing.assert_allclose(rows[:, 1], y, atol=1e-9)
    # optimization never decreases the objective (end > minopt rows)
    assert np.all(rows[1:, 5] >= rows[1:, 4] - 1e-6)
    # end=0: no data, no priors -> lml0 = lml = 0
    assert rows[0, 4] == pytest.approx(0.0, abs=1e-12)
    assert rows[0, 5] == pytest.approx(0.0, abs=1e-12)
    # sigmas positive
    assert np.all(rows[:, 3] > 0)


def test_normalization_roundtrip():
    _, y = _sine()
    yn, mean, std = normalize(y)
    np.testing.assert_allclose(yn * std + mean, y, atol=1e-12)
    # gonum stat.MeanStdDev uses the sample std (ddof=1)
    assert std == pytest.approx(np.std(y, ddof=1))


def test_no_normalize_flag():
    x, y = _sine()
    study = barebones.make_study()
    res = evaluate(study, x, y, config=EvalConfig(normalize=False, **CFG))
    assert res.mean_y == 0.0 and res.std_y == 1.0


def test_out_of_sample_rows():
    x, y = _sine()
    study = barebones.make_study()
    res = evaluate(study, x, y, config=EvalConfig(out_of_sample=True, **CFG))
    assert len(res.rows) == 8 + 7  # N + (N-1) horizon rows
    oos = np.asarray(res.rows[8:], dtype=float)
    # z = (x + x[-1])[1:], y_true = nan
    np.testing.assert_allclose(oos[:, 0], (x[:, 0] + x[-1, 0])[1:], atol=1e-12)
    assert np.all(np.isnan(oos[:, 1]))
    assert np.all(oos[:, 3] > 0)


def test_load_csv():
    x, y = load_csv("0.5,1.25\n1.5,-0.5\n")
    np.testing.assert_allclose(x, [[0.5], [1.5]])
    np.testing.assert_allclose(y, [1.25, -0.5])
    x2, y2 = load_csv("0.1,0.2,3.0\n")  # 2-D inputs
    assert x2.shape == (1, 2)


def test_hyperpriors_study_runs():
    x, y = load_csv(hyperpriors.selfcheck_data())
    x, y = x[:10], y[:10]
    res = evaluate(hyperpriors.make_study(), x, y, config=EvalConfig(**CFG))
    rows = np.asarray(res.rows, dtype=float)
    assert rows.shape == (10, 1 + 5 + 6)
    assert np.all(np.isfinite(rows[:, 2:6]))
    # priors make lml0 nonzero even at end=0
    assert rows[0, 4] != 0.0


def test_warpedtime_pins_first_last_and_outputs():
    x, y = load_csv(warpedtime.selfcheck_data())
    x, y = x[:8], y[:8]
    study = warpedtime.make_study()
    res = evaluate(study, x, y, config=EvalConfig(**CFG))
    n_theta = study.gp.n_theta
    v_last = res.v_all[-1]  # fit on first 7 points
    yn = res.y_norm
    xs = v_last[n_theta : n_theta + 8]
    ys = v_last[n_theta + 8 :]
    # outputs never move; all 8 slots equal the normalized data
    np.testing.assert_allclose(ys, yn, atol=1e-12)
    # first input and last *real* input (index 6) pinned; padding (7) pinned
    assert xs[0] == pytest.approx(x[0, 0], abs=1e-12)
    assert xs[6] == pytest.approx(x[6, 0], abs=1e-12)
    assert xs[7] == pytest.approx(x[7, 0], abs=1e-12)
    # interior inputs did move
    assert np.any(np.abs(xs[1:6] - x[1:6, 0]) > 1e-9)


def test_anynoise_pins_inputs_moves_outputs():
    x, y = load_csv(anynoise.selfcheck_data())
    x, y = x[:8], y[:8]
    study = anynoise.make_study()
    res = evaluate(study, x, y, config=EvalConfig(**CFG))
    n_theta = study.gp.n_theta
    v_last = res.v_all[-1]
    xs = v_last[n_theta : n_theta + 8]
    ys = v_last[n_theta + 8 :]
    np.testing.assert_allclose(xs, x[:, 0], atol=1e-12)  # inputs pinned
    assert np.any(np.abs(ys[:7] - res.y_norm[:7]) > 1e-9)  # latent outputs moved
    np.testing.assert_allclose(ys[7], res.y_norm[7], atol=1e-12)  # padding pinned


def test_events_kernel_discounting():
    k = events.events_kernel([(1.0, 2.5, 0.3), (3.0, 6.0, 0.5)])
    base = events.matern52_ref.scaled()
    th = jnp.asarray([0.9, 1.1])

    def kk(kern, a, b):
        return float(kern(th, jnp.asarray([a]), jnp.asarray([b])))

    # pair inside a region: no discount
    assert kk(k, 1.2, 2.0) == pytest.approx(kk(base, 1.2, 2.0))
    # pair straddling the first boundary: discounted by 0.3 (first match wins)
    assert kk(k, 0.5, 1.5) == pytest.approx(0.3 * kk(base, 0.5, 1.5))
    # pair straddling only the second event
    assert kk(k, 2.6, 3.5) == pytest.approx(0.5 * kk(base, 2.6, 3.5))
    # pair straddling both events' boundaries: first match wins -> 0.3
    assert kk(k, 0.5, 7.0) == pytest.approx(0.3 * kk(base, 0.5, 7.0))
    # order within the pair must not matter
    assert kk(k, 1.5, 0.5) == pytest.approx(kk(k, 0.5, 1.5))


def test_events_parse():
    evs = events.parse_events("1.:2.5:0.3,3:6:0.5")
    assert evs == [(1.0, 2.5, 0.3), (3.0, 6.0, 0.5)]
    assert events.parse_events("") == []
    with pytest.raises(ValueError):
        events.parse_events("1:2")


def test_cli_smoke(capsys):
    """Drive one CLI end-to-end through run_cli (stdout capture)."""
    out = io.StringIO()
    from gogp.tutorial.evaluate import run_cli

    run_cli(
        barebones.make_study,
        "0.0,0.1\n0.5,0.4\n1.0,0.9\n1.5,1.0\n2.0,0.7\n",
        "test",
        argv=["--seed", "1", "--iters", "30", "selfcheck"],
        wtr=out,
    )
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 5
    assert all(len(line.split(",")) == 9 for line in lines)
