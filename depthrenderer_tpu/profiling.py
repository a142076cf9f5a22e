"""Tracing and profiling utilities.

The reference's observability is a frame timer and mesh-gen timing logs
(``utils.py:523-538``, ``render.py:538-543``); this package adds
``jax.profiler`` device traces and per-stage wall-clock timing (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import time

from .utils import log


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (view with TensorBoard / xprof).

    Usage::

        with profiling.device_trace("/tmp/trace"):
            frames = render_clip(...)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        log(f"jax.profiler trace written to {log_dir}")


class StageTimer:
    """Accumulating named-stage wall-clock timer (blocks on device results).

    Usage::

        timer = StageTimer()
        with timer.stage("raster"):
            out = render(...)
        timer.report()
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        import jax

        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            log(f"[stage] {name}: {total * 1e3:.1f} ms total, "
                f"{total / n * 1e3:.2f} ms/call over {n} calls")


class ThroughputMeter:
    """Frames/sec meter for streaming pipelines (the FrameTimer's batched cousin)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0

    def add(self, n: int = 1):
        self.frames += n

    @property
    def fps(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0
