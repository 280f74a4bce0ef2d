"""Classification case study (rolling one-step-ahead class probabilities)."""

import io

import numpy as np

from gogp.gp import likelihoods
from gogp.tutorial import io as tio
from gogp.tutorial.classify import (
    evaluate_classify,
    main,
    make_gp,
    selfcheck_data,
)


def _run(engine="laplace", iters=25, seed=0):
    x, y = tio.load_csv(selfcheck_data())
    return np.asarray(
        evaluate_classify(
            make_gp(), likelihoods.bernoulli_logit, x, y,
            engine=engine, iters=iters, seed=seed,
        )
    )


def test_schema_probs_and_improvement():
    arr = _run()
    n = arr.shape[0]
    assert arr.shape == (n, 1 + 1 + 1 + 2 + 2)  # x, y, p, lml0, lml, exp(theta) x2
    assert np.isfinite(arr).all()
    assert np.all((arr[:, 2] >= 0) & (arr[:, 2] <= 1))
    opt = arr[9:]  # rows past MINOPT
    assert np.all(opt[:, 4] >= opt[:, 3] - 1e-9)
    assert (opt[:, 4] > opt[:, 3] + 1e-9).sum() >= len(opt) - 2
    # better than a coin flip on the one-step-ahead forecasts
    p = np.clip(opt[:, 2], 1e-9, 1 - 1e-9)
    yy = opt[:, 1]
    logloss = float(-(yy * np.log(p) + (1 - yy) * np.log(1 - p)).mean())
    assert logloss < 0.63


def test_seed_determinism():
    a = _run(seed=3, iters=10)
    b = _run(seed=3, iters=10)
    c = _run(seed=4, iters=10)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_ep_engine_smoke():
    arr = _run(engine="ep", iters=8)
    assert np.isfinite(arr).all()
    assert np.all((arr[:, 2] >= 0) & (arr[:, 2] <= 1))


def test_cli_main():
    buf = io.StringIO()
    rows = main(argv=["--seed", "0", "--iters", "10", "selfcheck"], wtr=buf)
    out = buf.getvalue().strip().splitlines()
    assert len(out) == len(rows) == 40
    assert all(len(line.split(",")) == 7 for line in out)


def test_ess_engine_agrees_with_laplace():
    # exact-latent predictions vs the Gaussian approximation: same fitted
    # hyperparameters (both engines fit by the Laplace marginal), so any
    # gap is approximation error + MC noise - small for logit models
    a = _run(engine="laplace", iters=25)
    b = _run(engine="ess", iters=25)
    p_lap, p_ess = a[:, 2], b[:, 2]
    assert np.all((p_ess > 0) & (p_ess < 1))
    assert np.max(np.abs(p_ess - p_lap)) < 0.12, np.max(np.abs(p_ess - p_lap))
