"""The GPU a measurement runs on: card names and power limits from
``nvidia-smi``, and the refusal to measure anything but a GPU.

A card may be set below its maximum power and then runs slower under load,
so every time this repository reports is printed beside the card's name and
power limit.
"""

from __future__ import annotations

import subprocess

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def parse_smi(text: str) -> list[tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power limit)], one entry per card."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, power = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), power.strip()))
    return cards


def query_cards() -> tuple[list[tuple[str, str]], str]:
    """Ask nvidia-smi for the cards; call it before JAX touches them.
    Returns the parsed cards and the raw output, or ([], reason) when
    nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [], f"nvidia-smi failed: {e}"
    if out.returncode != 0:
        return [], f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}"
    return parse_smi(out.stdout), out.stdout.strip()


def require_gpu(count: int = 1, who: str = "measurement"):
    """The first ``count`` JAX devices, which must be GPUs.  Raises
    SystemExit otherwise: a measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"{who}: needs a GPU, JAX found platform {devices[0].platform!r}")
    if len(devices) < count:
        raise SystemExit(f"{who}: needs {count} GPUs, JAX found {len(devices)}")
    return devices[:count]
