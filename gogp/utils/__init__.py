"""Utilities: checkpoint/resume (orbax) and profiling/phase timing."""

from gogp.utils.checkpoint import restore, save
from gogp.utils.profiling import PhaseTimer, device_trace, timed

__all__ = ["PhaseTimer", "device_trace", "restore", "save", "timed"]
