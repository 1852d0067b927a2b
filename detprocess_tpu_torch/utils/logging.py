"""Per-stage wall-time accounting, progress lines and device traces.

Copy of ``detprocess_tpu/utils/logging.py``: :class:`StageTimer`, the
``timer=`` argument of the shells' ``process``, adds up the host seconds
spent in each named stage (read, dispatch, drain); :func:`progress` logs
a rate line; :func:`device_trace` records a ``torch.profiler`` trace
(CPU and CUDA activities) where JAX records a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

logger = logging.getLogger("detprocess_tpu_torch")


class StageTimer:
    """Accumulates per-stage wall time and item counts.

    >>> timer = StageTimer()
    >>> with timer.stage("read"):
    ...     ...
    >>> timer.add_items("read", 1024)
    >>> timer.report()
    """

    def __init__(self):
        self._times: dict = {}
        self._items: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name] = (self._times.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def add_items(self, name: str, count: int):
        self._items[name] = self._items.get(name, 0) + count

    def add_seconds(self, name: str, seconds: float):
        """Accumulate measured time directly."""
        self._times[name] = self._times.get(name, 0.0) + seconds

    def report(self, log=True) -> dict:
        out = {}
        for name, t in self._times.items():
            entry = {"seconds": t}
            if name in self._items and t > 0:
                entry["items"] = self._items[name]
                entry["items_per_sec"] = self._items[name] / t
            out[name] = entry
            if log:
                rate = (f" ({entry['items_per_sec']:.0f} items/s)"
                        if "items_per_sec" in entry else "")
                logger.info(f"stage {name}: {t:.2f}s{rate}")
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activities, and
    CUDA ones where a card is present) and write its Chrome trace
    ``trace_<pid>.json`` into ``log_dir``; a no-op without ``log_dir``.
    Yields the profiler (None without ``log_dir``)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


def progress(total: int, every: int, t_start: float, what: str = "events"):
    """Log ``processed {total} {what} ({rate} {what}/s)`` when ``total``
    is a positive multiple of ``every`` (``t_start`` from
    ``time.perf_counter``)."""
    if total % every == 0 and total > 0:
        dt = time.perf_counter() - t_start
        rate = total / dt if dt > 0 else 0.0
        logger.info(f"processed {total} {what} ({rate:.0f} {what}/s)")
