"""Forecast plotting (the reference forecast.gp counterpart) end-to-end."""

import io

import numpy as np

from gogp.tutorial.plot import load_forecast, plot_forecast


def _csv():
    rows = []
    for i in range(12):
        x = i * 0.5
        rows.append(f"{x},{np.sin(x):.4f},{np.sin(x)*0.9:.4f},{0.2:.4f},0,0,1")
    return "\n".join(rows)


def test_load_forecast():
    x, y, mu, sigma = load_forecast(io.StringIO(_csv()))
    assert x.shape == (12, 1)
    assert np.all(sigma == 0.2)


def test_plot_forecast_writes_png(tmp_path):
    out = tmp_path / "fc.png"
    path = plot_forecast(io.StringIO(_csv()), str(out))
    assert out.exists() and out.stat().st_size > 1000
    assert path == str(out)
