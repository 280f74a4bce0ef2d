"""CSV data loading and forecast output.

Counterpart of the reference's ``load`` (tutorial/tutorial.go:234-272) and
its per-row forecast output (:185-197).  A native C++ fast-path parser is
provided by gogp.utils.native when built; this module falls back to pure
Python transparently.
"""

from __future__ import annotations

import io as _io
import sys
from typing import IO, Iterable

import numpy as np


def load_csv(rdr: IO[str] | str) -> tuple[np.ndarray, np.ndarray]:
    """Parse rows of ``x0,...,xk,y`` floats -> (X (n,k), Y (n,)).

    All columns but the last are input coordinates (reference
    tutorial.go:243-263).
    """
    if isinstance(rdr, str):
        rdr = _io.StringIO(rdr)
    text = rdr.read()
    try:
        from gogp.utils.native import parse_csv as _native_parse

        data = _native_parse(text)
    except Exception:
        rows = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rows.append([float(f) for f in line.split(",")])
        if not rows:
            return np.zeros((0, 1)), np.zeros((0,))
        data = np.asarray(rows, dtype=np.float64)
    if data.size == 0:
        return np.zeros((0, 1)), np.zeros((0,))
    return data[:, :-1], data[:, -1]


def normalize(y: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Zero-mean unit-std normalization with the *sample* std (ddof=1),
    matching gonum stat.MeanStdDev (reference tutorial.go:78-86)."""
    mean = float(np.mean(y))
    std = float(np.std(y, ddof=1)) if y.size > 1 else 1.0
    return (y - mean) / std, mean, std


def write_forecast_rows(
    wtr: IO[str],
    rows: Iterable[Iterable[float]],
) -> None:
    """Write forecast rows with the reference's %f formatting
    (tutorial.go:185-197)."""
    for row in rows:
        wtr.write(",".join(_fmt(v) for v in row) + "\n")


def _fmt(v) -> str:
    fv = float(v)
    if np.isnan(fv):
        return "nan"
    return f"{fv:f}"


def progress(msg: str, end: str = "\n") -> None:
    print(msg, file=sys.stderr, end=end, flush=True)


PLATFORMS = ("cpu", "gpu")


def select_platform(name: str) -> None:
    """Apply a tutorial CLI's ``--platform``: "cpu" pins JAX to the CPU,
    "gpu" requires a GPU and exits when JAX finds none.  Both run in float64
    (the case-study datasets are tiny and the goldens are float64)."""
    import jax

    if name not in PLATFORMS:
        raise ValueError(f"unknown platform {name!r}; expected one of {PLATFORMS}")
    jax.config.update("jax_enable_x64", True)
    if name == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit(f"--platform gpu: no GPU, JAX found {jax.devices()[0].platform!r}")
