"""Seed-median ESS/s protocol aggregation (benchmarks/ess_nuts.run_protocol).

The north-star artifact must aggregate honestly: median over seeds with
non-converged seeds scoring 0 (they delivered no usable samples), per-seed
rows carried verbatim, and the e2e variant including warmup walltime.
The engine runners themselves are exercised on the card;
here they are stubbed to test the aggregation contract.
"""

import json

import pytest

from benchmarks import ess_nuts


def _stub_out(value, e2e, rhat, reason=None):
    out = {
        "value": value,
        "ess_per_sec_e2e": e2e,
        "min_ess": 100.0,
        "max_rhat": rhat,
        "walltime_s": 10.0,
        "warm_total_s": 5.0,
    }
    if reason:
        out["value_reason"] = reason
    return out


def test_protocol_median_and_convergence_count(monkeypatch):
    results = {
        0: _stub_out(10.0, 6.0, 1.005),
        1: _stub_out(30.0, 20.0, 1.002),
        2: _stub_out(None, None, 1.5, "max split-R-hat 1.5 > 1.01"),
        3: _stub_out(20.0, 12.0, 1.003),
        4: _stub_out(40.0, 25.0, 1.004),
    }

    def fake_chees(chains, warmup, samples, seed, max_steps, pops, race, probe):
        return results[seed]

    monkeypatch.setattr(ess_nuts, "run_chees_bench", fake_chees)
    out = ess_nuts.run_protocol("chees", seeds=(0, 1, 2, 3, 4), quiet=True)
    # values sorted with the failed seed as 0: [0, 10, 20, 30, 40] -> 20
    assert out["ess_per_sec_median"] == 20.0
    assert out["value"] == 20.0
    assert out["ess_per_sec_e2e_median"] == 12.0
    assert out["n_converged"] == 4
    assert out["n_seeds"] == 5
    assert out["ess_per_sec_min"] == 0.0
    assert out["ess_per_sec_max"] == 40.0
    rows = {r["seed"]: r for r in out["per_seed"]}
    assert rows[2]["ess_per_sec"] is None
    assert "reason" in rows[2]
    json.dumps(out)  # artifact must be JSON-serializable


def test_protocol_extension_converges_marginal_seed(monkeypatch):
    """A seed failing only the R-hat gate is re-run with doubled draws
    (bounded); the recorded ESS/s comes from the converged run."""
    calls = []

    def fake_chees(chains, warmup, samples, seed, max_steps, pops, race, probe):
        calls.append((seed, samples))
        if seed == 0 and samples < 4096:
            return _stub_out(
                None, None, 1.0104,
                "max bulk split-R-hat 1.0104 > 1.01: not converged")
        return _stub_out(25.0, 20.0, 1.004)

    monkeypatch.setattr(ess_nuts, "run_chees_bench", fake_chees)
    out = ess_nuts.run_protocol("chees", seeds=(0, 1), num_samples=2048,
                                quiet=True)
    rows = {r["seed"]: r for r in out["per_seed"]}
    assert rows[0]["ess_per_sec"] == 25.0
    assert rows[0]["extensions"] == 1
    assert rows[0]["samples_per_chain"] == 4096
    assert rows[1]["extensions"] == 0
    assert rows[1]["samples_per_chain"] == 2048
    assert (0, 2048) in calls and (0, 4096) in calls
    json.dumps(out)


def test_protocol_extension_bounded(monkeypatch):
    calls = []

    def fake_chees(chains, warmup, samples, seed, max_steps, pops, race, probe):
        calls.append(samples)
        return _stub_out(None, None, 1.2, "max bulk split-R-hat 1.2 > 1.01")

    monkeypatch.setattr(ess_nuts, "run_chees_bench", fake_chees)
    out = ess_nuts.run_protocol("chees", seeds=(7,), num_samples=1024,
                                max_extensions=2, quiet=True)
    assert calls == [1024, 2048, 4096]
    row = out["per_seed"][0]
    assert row["ess_per_sec"] is None
    assert row["extensions"] == 2
    assert out["ess_per_sec_median"] == 0.0


def test_protocol_crash_never_extends(monkeypatch):
    calls = []

    def fake_chees(chains, warmup, samples, seed, max_steps, pops, race, probe):
        calls.append(samples)
        raise RuntimeError("device worker restarted")

    monkeypatch.setattr(ess_nuts, "run_chees_bench", fake_chees)
    out = ess_nuts.run_protocol("chees", seeds=(0,), num_samples=2048,
                                quiet=True)
    assert calls == [2048]
    assert "RuntimeError" in out["per_seed"][0]["reason"]


def test_protocol_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        ess_nuts.run_protocol("bogus", seeds=(0,))


def test_gated_summary_fields():
    import numpy as np

    rng = np.random.default_rng(0)
    good = rng.normal(size=(8, 256, 3))
    out = ess_nuts.gated_summary(good, walltime=2.0, warm_total=1.0)
    assert out["converged"] and out["value"] is not None
    assert out["ess_per_sec_e2e"] == round(out["min_ess"] / 3.0, 2)
    stuck = good.copy()
    stuck[0, :, 0] = 7.7
    out2 = ess_nuts.gated_summary(stuck, walltime=2.0, warm_total=1.0)
    assert out2["value"] is None and "value_reason" in out2


def test_protocol_seed_crash_scores_zero(monkeypatch):
    def fake_chees(chains, warmup, samples, seed, max_steps, pops, race, probe):
        if seed == 1:
            raise RuntimeError("device worker restarted")
        return _stub_out(10.0 + seed, 8.0, 1.004)

    monkeypatch.setattr(ess_nuts, "run_chees_bench", fake_chees)
    out = ess_nuts.run_protocol("chees", seeds=(0, 1, 2), quiet=True)
    rows = {r["seed"]: r for r in out["per_seed"]}
    assert rows[1]["ess_per_sec"] is None
    assert "RuntimeError" in rows[1]["reason"]
    # values [10, 0, 12] -> median 10
    assert out["ess_per_sec_median"] == 10.0
    assert out["n_converged"] == 2
    json.dumps(out)


def test_qualifier_ranks_converged_first(monkeypatch):
    monkeypatch.setattr(
        ess_nuts, "run_chees_bench",
        lambda *a, **k: _stub_out(15.0, 10.0, 1.004))
    monkeypatch.setattr(
        ess_nuts, "run_ghmc_bench",
        lambda *a, **k: _stub_out(None, None, 1.05, "gate"))
    monkeypatch.setattr(
        ess_nuts, "run_pt_chees_bench",
        lambda *a, **k: _stub_out(None, None, 1.02, "gate"))
    q = ess_nuts.qualify_engine(quiet=True)
    assert q["winner"]["engine"] == "chees"
    assert q["winner_converged"]
    assert len(q["rows"]) == 3


def test_qualifier_falls_back_to_lowest_rhat(monkeypatch):
    monkeypatch.setattr(
        ess_nuts, "run_chees_bench",
        lambda *a, **k: _stub_out(None, None, 1.08, "gate"))
    monkeypatch.setattr(
        ess_nuts, "run_ghmc_bench",
        lambda *a, **k: _stub_out(None, None, 1.15, "gate"))
    monkeypatch.setattr(
        ess_nuts, "run_pt_chees_bench",
        lambda *a, **k: _stub_out(None, None, 1.02, "gate"))
    q = ess_nuts.qualify_engine(quiet=True)
    assert q["winner"]["engine"] == "pt-chees"
    assert not q["winner_converged"]


def test_qualifier_survives_engine_crash(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("worker crashed")

    monkeypatch.setattr(ess_nuts, "run_chees_bench", boom)
    monkeypatch.setattr(
        ess_nuts, "run_ghmc_bench",
        lambda *a, **k: _stub_out(5.0, 4.0, 1.001))
    monkeypatch.setattr(
        ess_nuts, "run_pt_chees_bench",
        lambda *a, **k: _stub_out(2.0, 1.5, 1.003))
    q = ess_nuts.qualify_engine(quiet=True)
    assert q["winner"]["engine"] == "ghmc"
    rows = {r["engine"]: r for r in q["rows"]}
    assert "RuntimeError" in rows["chees"]["reason"]
