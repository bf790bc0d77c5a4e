"""Profiling / per-stage timing (SURVEY.md §5 tracing row).

Reference analog: `[U:profiler.c]` DWT cycle-counter probes printed over the
USB debug console. Here: wall-clock stage timing that waits for the device
with ``jax.block_until_ready``, and a jax.profiler trace context.
"""

from __future__ import annotations

import contextlib
import time

import jax


class StageTimer:
    """Accumulates per-stage wall times across repeated blocks."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24s} {tot*1e3:9.2f} ms total  {tot/n*1e3:8.3f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/radioframe_trace"):
    """jax.profiler trace context (view with xprof/tensorboard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
