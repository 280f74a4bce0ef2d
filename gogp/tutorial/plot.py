"""Forecast plotting — counterpart of the reference's gnuplot script
(tutorial/forecast.gp): posterior mean with +-1 sigma and +-1.96 sigma bands
over the observed series, from the forecast CSV emitted by the Evaluate
driver (columns: x..., y, mu, sigma, lml0, lml, theta...).

Usage:
    python -m gogp.tutorial.barebones --seed 0 selfcheck > fc.csv
    python -m gogp.tutorial.plot fc.csv forecast.png
"""

from __future__ import annotations

import sys

import numpy as np


def load_forecast(path_or_file, ndim: int = 1):
    rows = np.genfromtxt(path_or_file, delimiter=",")
    rows = np.atleast_2d(rows)
    x = rows[:, :ndim]
    y, mu, sigma = rows[:, ndim], rows[:, ndim + 1], rows[:, ndim + 2]
    return x, y, mu, sigma


def plot_forecast(path_or_file, out_path: str, ndim: int = 1, title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y, mu, sigma = load_forecast(path_or_file, ndim)
    xs = x[:, 0]
    order = np.argsort(xs)
    xs, y, mu, sigma = xs[order], y[order], mu[order], sigma[order]

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.fill_between(
        xs, mu - 1.96 * sigma, mu + 1.96 * sigma, alpha=0.15, label="95% band"
    )
    ax.fill_between(xs, mu - sigma, mu + sigma, alpha=0.25, label="+-1 sigma")
    ax.plot(xs, mu, lw=1.5, label="posterior mean")
    obs = np.isfinite(y)
    ax.plot(xs[obs], y[obs], "o", ms=4, alpha=0.8, label="observed")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    if title:
        ax.set_title(title)
    ax.legend(loc="best", frameon=False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or len(argv) > 2:
        raise SystemExit("usage: python -m gogp.tutorial.plot <forecast.csv> [out.png]")
    src = argv[0]
    out = argv[1] if len(argv) > 1 else "forecast.png"
    plot_forecast(sys.stdin if src == "-" else src, out)
    print(out)


if __name__ == "__main__":
    main()
