"""Per-stage wall-time accounting.

Copy of ``detprocess_tpu/utils/logging.py::StageTimer``, the ``timer=``
argument of ``FeatureProcessing.process``: it adds up the host seconds
spent in each named stage (read, dispatch, drain).
"""

from __future__ import annotations

import contextlib
import logging
import time

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
