"""Phase timers + optional jax.profiler traces.

The reference brackets sparse construction / factorization / solves with
``time.perf_counter()`` and prints a 7-line phase summary
(``source code/fcVM.py:1110-1140, 1620-1624``; ``fcVM.FCMacro:200-210``).
This module reproduces that as a reusable context-manager registry and adds
``jax.profiler`` trace capture for device timeline analysis.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def totals(self) -> dict:
        return dict(self._totals)

    def summary(self) -> str:
        width = max((len(k) for k in self._totals), default=0)
        lines = [
            f"{k:.<{width + 5}} {v:7.3f} seconds ({self._counts[k]}x)"
            for k, v in self._totals.items()
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (device timeline) around a block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
