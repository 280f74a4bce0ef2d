"""Case study: event-discounted similarity kernel.

Counterpart of reference tutorial/events: similarity between two points is
scaled down by an event's discount factor when the pair straddles the event's
boundary, first matching event wins (events/kernel/kernel.go:36-44).  Events
are static trace-time data (closed over, SURVEY.md §2.1-11); the kernel is
non-smooth w.r.t. inputs but smooth in theta, so MLE over theta is fine.

Run:  python -m gogp.tutorial.events [flags] selfcheck
Flags: --events "from:to:discount,..." (e.g. "1.:2.5:0.3,3:6:0.5"),
       matching the reference's -events (events/main.go:31-34).
"""

from __future__ import annotations

from importlib import resources

import jax.numpy as jnp

from gogp.gp.core import GP
from gogp.kernels import Kernel, matern52_ref, uniform_noise
from gogp.tutorial.evaluate import Study, run_cli


def events_kernel(events: list[tuple[float, float, float]]) -> Kernel:
    """Scaled Matérn-5/2 with event-boundary discounting.

    ``events`` is a static list of (from, to, discount).  The reference
    applies only the *first* matching event then breaks
    (events/kernel/kernel.go:41-44); replicated with a first-match mask.
    The python loop unrolls at trace time — events are compile-time
    constants, so XLA sees pure elementwise selects.
    """
    base = matern52_ref.scaled()

    def pair(theta, xa, xb):
        k = base.pair(theta, xa, xb)
        lo = jnp.minimum(xa[0], xb[0])
        hi = jnp.maximum(xa[0], xb[0])
        matched = jnp.asarray(False)
        for frm, to, discount in events:
            crosses = ((lo < frm) & (frm <= hi)) | ((lo < to) & (to <= hi))
            apply = crosses & ~matched
            k = jnp.where(apply, k * discount, k)
            matched = matched | crosses
        return k

    return Kernel(base.n_theta, pair, f"events({len(events)})")


def parse_events(spec: str) -> list[tuple[float, float, float]]:
    """Parse "from:to:discount,..." (reference events/main.go:52-64)."""
    if not spec:
        return []
    out = []
    for ev in spec.split(","):
        parts = [float(s) for s in ev.split(":")]
        if len(parts) != 3:
            raise ValueError(f"bad event {ev!r}: want from:to:discount")
        out.append(tuple(parts))
    return out


def make_study(events: list[tuple[float, float, float]] | None = None) -> Study:
    return Study(
        name="events",
        gp=GP(
            ndim=1,
            simil=events_kernel(events or []),
            noise=uniform_noise.scaled_by(0.01),
        ),
    )


def selfcheck_data() -> str:
    return (
        resources.files("gogp.tutorial").joinpath("data/regimes.csv").read_text()
    )


def _extra_flags(ap):
    # "-events" alias: the reference CLI uses Go-style single-dash long
    # flags (events/main.go:31-34); both spellings are drop-in compatible.
    ap.add_argument(
        "--events",
        "-events",
        default="",
        help='comma separated colon connected event list "from:to:discount,..."',
    )


def main(argv=None):
    return run_cli(
        lambda a: make_study(parse_events(a.events)),
        selfcheck_data(),
        "GP with event-discounted similarity kernel.",
        extra_flags=_extra_flags,
        argv=argv,
    )


if __name__ == "__main__":
    main()
