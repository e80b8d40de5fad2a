"""Observability: structured per-stage stats, timers, and profiler hooks.

The reference's observability surface is unstructured stderr prints + tqdm
(SURVEY.md §5). Here every stage additionally records structured counters and
wall times, dumped as one JSON line to stderr (SCTAG_STATS=1) or to a file
(SCTAG_STATS=/path). A stage that used JAX also records the device it ran on
(platform, device kind, count) and its device-kernel dispatches
(runtime.KERNEL_CALLS), and names the device on stderr. Device tracing: set
SCTAG_PROFILE=<dir> to wrap stage bodies in a jax.profiler trace (viewable
in TensorBoard / Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict


class StageStats:
    """Accumulates counters/timings for one stage run."""

    def __init__(self, stage: str):
        self.stage = stage
        self.counters: dict[str, float] = defaultdict(float)
        self.timers: dict[str, float] = defaultdict(float)
        self._t0 = time.perf_counter()
        from .runtime import KERNEL_CALLS

        self._kernel_calls0 = dict(KERNEL_CALLS)

    def count(self, key: str, n: float = 1) -> None:
        self.counters[key] += n

    @contextlib.contextmanager
    def timer(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[key] += time.perf_counter() - t0

    def emit(self) -> None:
        from .runtime import KERNEL_CALLS, device_summary

        record = {
            "stage": self.stage,
            "wall_s": round(time.perf_counter() - self._t0, 3),
            "counters": {k: v for k, v in sorted(self.counters.items())},
            "timers_s": {
                k: round(v, 3) for k, v in sorted(self.timers.items())
            },
        }
        if "jax" in sys.modules:  # host-only stages never import it
            dev = device_summary()
            record["device"] = dev
            record["kernel_calls"] = {
                k: v - self._kernel_calls0.get(k, 0)
                for k, v in sorted(KERNEL_CALLS.items())
            }
            print(
                f"[{self.stage}] device: {dev['platform']} "
                f"{dev['kind']} x{dev['count']}",
                file=sys.stderr,
            )
        dest = os.environ.get("SCTAG_STATS")
        if not dest:
            return
        line = json.dumps(record)
        if dest == "1":
            print(line, file=sys.stderr)
        else:
            with open(dest, "a") as f:
                f.write(line + "\n")


@contextlib.contextmanager
def stage_scope(stage: str):
    """Stats + optional jax.profiler trace around a stage body."""
    stats = StageStats(stage)
    profile_dir = os.environ.get("SCTAG_PROFILE")
    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            yield stats
    else:
        yield stats
    stats.emit()
