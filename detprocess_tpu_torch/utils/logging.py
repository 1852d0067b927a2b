"""Per-stage wall-time accounting, spans, progress lines and device traces.

Copy of ``detprocess_tpu/utils/logging.py``: :class:`StageTimer`, the
``timer=`` argument of the shells' ``process``, adds up the host seconds
spent in each named stage (read, dispatch, drain) and in each span inside
them; :func:`progress` logs a rate line; :func:`device_trace` records a
``torch.profiler`` trace (CPU and CUDA activities) where JAX records a
``jax.profiler`` one.

A span adds its seconds to the timer from any thread (the shells' reader
threads too). Where ``torch.profiler`` records the calling thread, a span
is also a ``record_function`` of its name, so that it lies on the device
trace's own clock; elsewhere it costs two clock reads and a lock.
``torch.profiler`` records only the thread that started it: under
``device_trace(log_dir, timer=...)`` the timer keeps each span's start and
end, and the spans of the other threads are written into the exported
trace on their own threads, mapped onto its clock through an anchor span
noted at the profiler's start.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from typing import Optional

import torch

logger = logging.getLogger("detprocess_tpu_torch")

ANCHOR = "trace.anchor"
_ASCII = str.maketrans({"Δ": "delta ", "χ": "chi", "²": "2"})
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled   # this thread's


class _Span:
    """One span of a :class:`StageTimer`: ``seconds`` under ``key``, and
    where the profiler records this thread a ``record_function`` of
    ``name``."""

    __slots__ = ("timer", "key", "name", "batch", "t0", "rf", "records",
                 "parent")

    def __init__(self, timer, key, name, batch):
        self.timer, self.key, self.name, self.batch = timer, key, name, batch

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.records = records = self.timer._records
        if records is not None:
            stack = self.timer._stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        timer = self.timer
        with timer._lock:
            timer._times[self.key] = (timer._times.get(self.key, 0.0)
                                      + (t1 - self.t0) * 1e-9)
        if self.records is not None:
            timer._stack().pop()
            self.records.append((self.name, threading.get_native_id(),
                                 self.t0, t1, self.parent, self.batch,
                                 self.rf is not None))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class StageTimer:
    """Accumulates per-stage and per-span wall time and item counts; safe
    to add to from several threads.

    >>> timer = StageTimer()
    >>> with timer.stage("read"):
    ...     with timer.span("read.fill", batch=0):
    ...         ...
    >>> timer.add_items("read", 1024)
    >>> timer.report()
    """

    def __init__(self):
        self._times: dict = {}
        self._items: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._records: Optional[list] = None

    def _stack(self) -> list:
        """This thread's open spans, while span records are kept."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def stage(self, name: str):
        """A top-level span: its seconds under ``name``, its profiler span
        ``stage.<name>``."""
        return _Span(self, name, "stage." + name, None)

    def span(self, name: str, batch: Optional[int] = None):
        """A span inside a stage, or on another thread: its seconds under
        ``name``; ``batch`` the index of the batch it serves, where one
        applies (kept in the span's record)."""
        return _Span(self, name, name, batch)

    def add_items(self, name: str, count: int):
        with self._lock:
            self._items[name] = self._items.get(name, 0) + count

    def add_seconds(self, name: str, seconds: float):
        """Accumulate measured time directly."""
        with self._lock:
            self._times[name] = self._times.get(name, 0.0) + seconds

    def start_records(self) -> list:
        """Keep a record of each span closed from now on: (name, native
        thread id, ``perf_counter_ns`` start and end, parent span's name,
        batch, whether the profiler recorded it); returns their list."""
        self._records = []
        return self._records

    def stop_records(self):
        self._records = None

    def report(self, log=True) -> dict:
        with self._lock:
            times, items = dict(self._times), dict(self._items)
        out = {}
        for name, t in times.items():
            entry = {"seconds": t}
            if name in items and t > 0:
                entry["items"] = items[name]
                entry["items_per_sec"] = items[name] / t
            out[name] = entry
            if log:
                rate = (f" ({entry['items_per_sec']:.0f} items/s)"
                        if "items_per_sec" in entry else "")
                logger.info(f"stage {name}: {t:.2f}s{rate}")
        return out


def span(timer: Optional[StageTimer], name: str,
         batch: Optional[int] = None):
    """``timer.span(name, batch)``, or a null context without a timer."""
    return _NULL if timer is None else timer.span(name, batch)


def layer_spans(timer: Optional[StageTimer], prefix: str):
    """A ``run_layer`` hook for ``GroupStep.forward`` and
    ``TriggerStep.forward`` that runs each layer in a span
    ``<prefix><layer>`` of ``timer``, the layer's name spelt in ASCII
    (``Δχ²`` as ``delta chi2``: the profiler exports any other name as
    "unknown"); None without a timer."""
    if timer is None:
        return None
    names: dict = {}

    def run_layer(name, fn, *args):
        span_name = names.get(name)
        if span_name is None:
            span_name = names[name] = prefix + name.translate(_ASCII)
        with timer.span(span_name):
            return fn(*args)
    return run_layer


def trace_span(name: str):
    """A ``record_function(name)`` where the profiler records this thread,
    else a null context: a span for code that has no timer."""
    return torch.profiler.record_function(name) if _profiling() else _NULL


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None,
                 timer: Optional[StageTimer] = None):
    """Profile the block with ``torch.profiler`` (CPU activities, and
    CUDA ones where a card is present) and write its Chrome trace
    ``trace_<pid>.json`` into ``log_dir``; a no-op without ``log_dir``.
    Yields the profiler (None without ``log_dir``).

    With ``timer``, the spans it times on threads the profiler does not
    record (the shells' reader threads) are written into the same trace,
    each on its own thread's ``tid``: its ``ts`` is the end of the span
    :data:`ANCHOR` entered at the profiler's start plus the span's
    ``perf_counter_ns`` distance from that moment."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    records = None
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(ANCHOR):
            pass
        t_anchor = time.perf_counter_ns()
        if timer is not None:
            records = timer.start_records()
        try:
            yield prof
        finally:
            if timer is not None:
                timer.stop_records()
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    if records:
        _merge_spans(path, records, t_anchor)


def _merge_spans(path: str, records: list, t_anchor: int):
    """Write the ``records`` the profiler did not record into the Chrome
    trace at ``path`` as complete events on their threads."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    anchor = next(e for e in events
                  if e.get("name") == ANCHOR and e.get("ph") == "X")
    ts0, pid = anchor["ts"] + anchor["dur"], anchor["pid"]
    tids = set()
    for name, tid, t0, t1, parent, batch, traced in records:
        if traced:
            continue                    # already in the trace
        args = {}
        if parent is not None:
            args["parent"] = parent
        if batch is not None:
            args["batch"] = batch
        events.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "pid": pid, "tid": tid,
                       "ts": ts0 + (t0 - t_anchor) / 1e3,
                       "dur": (t1 - t0) / 1e3, "args": args})
        tids.add(tid)
    for tid in sorted(tids):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"thread {tid} (spans)"}})
    with open(path, "w") as f:
        json.dump(trace, f)


def progress(total: int, every: int, t_start: float, what: str = "events"):
    """Log ``processed {total} {what} ({rate} {what}/s)`` when ``total``
    is a positive multiple of ``every`` (``t_start`` from
    ``time.perf_counter``)."""
    if total % every == 0 and total > 0:
        dt = time.perf_counter() - t_start
        rate = total / dt if dt > 0 else 0.0
        logger.info(f"processed {total} {what} ({rate:.0f} {what}/s)")
