"""Profiling and phase timing.

The reference's only observability is stderr progress lines
(tutorial/tutorial.go:70-75); per SURVEY.md §5 this build adds real
tracing: ``jax.profiler`` device traces plus lightweight host-side phase
walltime counters that block on device completion so the numbers mean what
they say.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import jax


class PhaseTimer:
    """Accumulates walltime per named phase; device-synchronized."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: object = None) -> Iterator[None]:
        """Time a phase.  Pass the phase's output arrays as ``sync`` to block
        until the device work actually finished."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [
            f"{name}: {self.totals[name] * 1e3:.2f} ms "
            f"({self.counts[name]} calls, "
            f"{self.totals[name] * 1e3 / max(self.counts[name], 1):.2f} ms/call)"
            for name in sorted(self.totals)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace context — view with TensorBoard / xprof."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 10, warmup: int = 2) -> float:
    """Median walltime (ms) of a compiled callable, blocking on outputs."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]
