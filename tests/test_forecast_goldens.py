"""End-to-end numeric goldens for the five tutorial studies.

The reference's selfchecks are smoke tests (exit-0 CSV, tutorial/Makefile);
its numeric contract lives in gp_test.go's golden tables.  Here the
committed fixtures (tests/fixtures/forecast_*.csv, written by
tests/make_forecast_fixtures.py) pin the ENTIRE Evaluate protocol
numerically: normalization, seeded jittered re-init, masking, batched
optimization, and the forecast columns, per study.  Any protocol
regression — wrong mask row, dropped exp(), changed column order, broken
seed plumbing — shows up as a gross mismatch; regenerate the fixtures only
for an intentional protocol change.

A second, fixture-free check cross-validates the optimizer itself: scipy's
independent L-BFGS-B (different implementation, different linesearch) must
not beat our compiled LBFGS by more than float noise from the same
jittered initializations.
"""

import numpy as np
import pytest

from gogp.tutorial import anynoise, barebones, events, hyperpriors, warpedtime
from gogp.tutorial.events import parse_events

from make_forecast_fixtures import FIXTURE_DIR, run_study

STUDIES = [
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


@pytest.mark.parametrize("case", STUDIES, ids=[s[0] for s in STUDIES])
def test_forecast_matches_fixture(case):
    name, factory, data_fn = case
    want = np.loadtxt(FIXTURE_DIR / f"forecast_{name}.csv", delimiter=",")
    result = run_study(factory, data_fn)
    got = np.asarray([[float(v) for v in row] for row in result.rows])
    assert got.shape == want.shape, (got.shape, want.shape)
    # inputs and true outputs are data: exact
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-9)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-9)
    # forecasts, log-densities and thetas: deterministic relaunch of the
    # same compiled x64 program.  Regeneration measured bit-identical on
    # this platform (round 4); 1e-5 leaves margin for cross-platform op
    # reordering while catching any real protocol drift (e.g. a wrong
    # jitter column), which moves values by far more.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_lbfgs_not_beaten_by_scipy():
    """Independent-optimizer cross-check (barebones, 3 prefix lengths).

    scipy L-BFGS-B maximizes the identical objective from the identical
    jittered inits; our compiled LBFGS's final log-density must match or
    beat it up to noise.  Verifies the fit quality is a property of the
    objective, not of our optimizer quirks.
    """
    import jax
    import jax.numpy as jnp
    from scipy.optimize import minimize

    from gogp.models.params import gp_observe
    from gogp.tutorial import io as tio
    from gogp.tutorial.evaluate import EvalConfig, evaluate

    study = barebones.make_study()
    gp = study.gp
    x, y = tio.load_csv(barebones.selfcheck_data())
    cfg = EvalConfig(alg="lbfgs", iters=200, seed=0)
    result = evaluate(study, x, y, config=cfg)

    xj = jnp.asarray(result.x)
    yj = jnp.asarray(result.y_norm)
    n = xj.shape[0]

    key = jax.random.PRNGKey(cfg.seed)
    jitter = 0.1 * jax.random.normal(key, (n, gp.n_theta), dtype=xj.dtype)

    for end in [5, 10, n - 1]:
        mask = jnp.asarray((np.arange(n) < end).astype(np.float64))

        def neg(v):
            return -gp_observe(gp, jnp.asarray(v), x=xj, y=yj, mask=mask)

        vg = jax.jit(jax.value_and_grad(neg))
        v0 = np.asarray(jitter[end])
        res = minimize(
            lambda v: tuple(np.asarray(t, np.float64) for t in vg(v)),
            v0, jac=True, method="L-BFGS-B",
            options={"maxiter": 500, "ftol": 1e-12, "gtol": 1e-9},
        )
        ours = float(
            gp_observe(gp, jnp.asarray(result.v_all[end]), x=xj, y=yj, mask=mask)
        )
        scipys = -float(res.fun)
        assert ours >= scipys - 1e-3, (end, ours, scipys)
