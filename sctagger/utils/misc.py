"""Small shared helpers (no JAX imports — usable host-side everywhere)."""

from __future__ import annotations

import threading
from typing import Iterator, Sequence

import numpy as np


def full_fast(shape, value, dtype) -> np.ndarray:
    """np.full without the first-touch page-fault cliff.

    On this host, writing into freshly malloc-backed pages (np.empty/np.full)
    faults at ~500us/page — a brand-new 16 MB np.full costs ~0.5 s — while
    calloc-backed pages (np.zeros) fault fast (CLAUDE.md "page-fault cliff").
    zeros+fill is ~2 ms for the same array, every time.
    """
    out = np.zeros(shape, dtype)
    if value:
        out.fill(value)
    return out


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def pow2_rows(n: int, lo: int) -> int:
    """Row count padded up a short power-of-two ladder starting at ``lo``,
    so data-dependent batch sizes (tie passes, escalation, fallbacks)
    compile a few shapes instead of one per size."""
    r = lo
    while r < n:
        r *= 2
    return r


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; buckets must be sorted ascending.

    Raises ValueError if ``n`` exceeds the largest bucket.
    """
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def batch_iter(n: int, batch: int) -> Iterator[tuple[int, int]]:
    """Yield (start, stop) index pairs covering range(n) in chunks of ``batch``."""
    for s in range(0, n, batch):
        yield s, min(s + batch, n)


# Cross-module phase timers (diagnostics). Model drivers accumulate wall
# times per phase here; stage drivers fold the deltas into their structured
# stats (observability.StageStats), surfaced via SCTAG_STATS.
PROF: dict[str, float] = {}
_PROF_LOCK = threading.Lock()


class prof_timer:
    """Context manager adding elapsed wall time to PROF[key] (thread-safe:
    the streaming stage-1 pipeline times phases from the parse producer, the
    encode worker, and the consumer concurrently)."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        dt = time.perf_counter() - self._t0
        with _PROF_LOCK:
            PROF[self.key] = PROF.get(self.key, 0.0) + dt
        return False


class _NullBar:
    def update(self, n: int = 1) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def progress_bar(total=None, desc: str = "", unit: str = "it"):
    """tqdm progress bar on stderr, mirroring the reference's surface
    (scTagger.py:168,282,312,444-446,704 wrap every long loop in tqdm).

    Enabled when SCTAG_PROGRESS=1, disabled when =0; by default only when
    stderr is a TTY so captured-output runs (benches, golden tests, logs)
    stay byte-clean. Returns a no-op bar when disabled or tqdm is missing.
    Use as a context manager or call .update()/.close()."""
    import os
    import sys

    flag = os.environ.get("SCTAG_PROGRESS")
    if flag == "0":
        return _NullBar()
    if flag != "1" and not sys.stderr.isatty():
        return _NullBar()
    try:
        from tqdm import tqdm
    except Exception:  # pragma: no cover - tqdm missing
        return _NullBar()
    return tqdm(total=total, desc=desc, unit=unit, file=sys.stderr)
