"""Tracing / profiling hooks.

Parity: reference SURVEY.md section 5.1 — GPU timestamp query pairs per
frame + a 1 Hz statistics log + debug labels for capture tools. JAX
equivalents:

* `trace()` — context manager around `jax.profiler.trace`, producing a
  TensorBoard-loadable trace directory (the capture-tool analog);
* `annotate()` — `jax.profiler.TraceAnnotation` named ranges (the
  begin/end_debug_label analog, rz_renderer.rs:989-992);
* `FrameTimer` — wall-clock pass timing via `block_until_ready` deltas
  (the timestamp-query analog, renderer.rs:274-277).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "./out/profile"):
    """Capture a profiler trace for everything inside the block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace range (debug-label analog)."""
    return jax.profiler.TraceAnnotation(name)


class FrameTimer:
    """Per-pass wall-time via block_until_ready deltas."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            value = holder.get("result", result)
            if value is not None:
                jax.block_until_ready(value)
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        return ", ".join(f"{k}: {v * 1000:.2f}ms" for k, v in self.times.items())
