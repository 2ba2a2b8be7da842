"""Tracing / profiling harness (SURVEY.md §6).

The reference's only instrumentation is a per-step printf banner
(main.cpp:262-264) and one wall-clock difftime in the unbuildable FD
variant (main-jacobian.cpp:292-320). Here:

  * `timed(fn, *args)` — device-synchronized wall-clock of one call
    (jax.block_until_ready-bracketed, compile excluded by a warm-up call);
  * `throughput(...)` — the BASELINE metric: grid-points/s/device;
  * `trace(logdir)` — context manager around jax.profiler for XLA-level
    traces viewable in TensorBoard/XProf;
  * `StepTimer` — rolling per-segment timings for the runner's progress
    output.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax


def timed(fn: Callable, *args, warmup: bool = True,
          iters: int = 1) -> Tuple[float, object]:
    """Returns (seconds_per_call, last_result); synchronized, compile
    excluded when warmup=True."""
    if warmup:
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def throughput(fn: Callable, *args, grid_points: int,
               steps_per_call: int = 1, iters: int = 1) -> float:
    """grid-points/s/device for a stepping callable (the BASELINE metric)."""
    sec, _ = timed(fn, *args, iters=iters)
    n_dev = max(1, len(jax.devices()))
    return grid_points * steps_per_call / sec / n_dev


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace scope; view with TensorBoard's profile plugin."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Rolling wall-clock of runner segments; reports steps/s and
    grid-points/s like the reference's banner, but measured."""

    def __init__(self, grid_points: int):
        self.grid_points = grid_points
        self._last = time.perf_counter()
        self.history = []

    def lap(self, n_steps: int) -> dict:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        rec = dict(steps=n_steps, seconds=dt,
                   steps_per_s=n_steps / max(dt, 1e-12),
                   grid_points_per_s=n_steps * self.grid_points
                   / max(dt, 1e-12))
        self.history.append(rec)
        return rec
