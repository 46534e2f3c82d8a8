"""Profiling / tracing utilities.

The reference's only instrumentation is a manual `time.process_time` window
around assembly (`comparison_assembly_P1_2D_elasticity.py:77-80`,
SURVEY.md §5).  Here: wall-clock timers that synchronize the device,
throughput accounting (GDOF/s), and an optional `jax.profiler` trace hook.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Timer:
    """Device-synchronized wall-clock timer with named laps."""

    laps: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def lap(self, name: str, sync=None):
        """Context manager: `sync` is an optional object (or callable
        returning one) passed to `jax.block_until_ready` before stopping."""
        import jax

        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            target = box.get("sync", sync)
            if callable(target):
                target = target()
            if target is not None:
                jax.block_until_ready(target)
            self.laps.setdefault(name, []).append(time.perf_counter() - t0)

    def median(self, name: str) -> float:
        import numpy as np

        return float(np.median(self.laps[name]))

    def summary(self) -> Dict[str, float]:
        return {k: self.median(k) for k in self.laps}


def time_jitted(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Median wall-clock of `fn(*args)`, each call synced with
    `jax.block_until_ready`; compiles first.  Each rep pays one dispatch —
    amortize with an on-device `fori_loop` chain inside `fn` when timing
    micro-ops."""
    import jax
    import numpy as np

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def gdof_per_s(n_dofs: int, wall_s: float) -> float:
    """Throughput in billions of DOFs per second (BASELINE.md metric)."""
    return n_dofs / wall_s / 1e9


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """jax.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
