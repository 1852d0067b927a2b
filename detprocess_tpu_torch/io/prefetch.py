"""Read-ahead threads.

Copy of ``detprocess_tpu/io/prefetch.py`` (pure threading):

- :class:`EventPrefetcher`: one thread keeps a bounded queue of
  ``(traces, admin)`` events of a reader filled;
- :class:`ParallelEventPrefetcher`: N threads over disjoint file subsets
  (``RawReader.split``) feed one queue; event order across subsets is
  not deterministic;
- :class:`OrderedChunkPrefetcher`: ``fn(state, chunk)`` over a chunk
  list in N threads, yielded in chunk ORDER;
- :func:`prefetch_events`: the first or the second, by ``nreaders``.

A reader error is raised on the consumer's side; ``close()`` stops the
threads.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

_SENTINEL = object()


class EventPrefetcher:
    """Iterate (traces, admin) pairs read ahead by a daemon thread;
    ``depth`` bounds the queue in events."""

    def __init__(self, reader, depth: int = 32,
                 channels: Optional[Sequence[str]] = None,
                 dtype=None, raw: bool = False):
        self._reader = reader
        self._channels = channels
        self._dtype = dtype
        self._raw = raw
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                if self._raw:
                    kw = {"dtype": None, "adctoamp": False}
                else:
                    kw = ({} if self._dtype is None
                          else {"dtype": self._dtype})
                traces, admin = self._reader.read_next_event(
                    channels=self._channels, **kw)
                if traces is None:
                    break
                while not self._stop.is_set():
                    try:
                        self._queue.put((traces, admin), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:   # raised on the consumer's side
            self._error = exc
        finally:
            # the end marker is never dropped: retry until it fits or
            # close() asks the thread to stop
            while not self._stop.is_set():
                try:
                    self._queue.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def read_next_event(self, channels=None):
        """As ``RawReader.read_next_event``: (None, None) at the end."""
        try:
            return next(self)
        except StopIteration:
            return None, None

    def close(self):
        """Stop the reader thread and drain the queue."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class ParallelEventPrefetcher:
    """N reader threads over disjoint file subsets feeding one queue.

    Build the readers with ``RawReader.split(n)``: each owns its file
    handles, and ``close()`` closes them. A worker's error ends the
    stream at once (an error marker rides the queue).
    """

    _ERROR = object()

    def __init__(self, readers: Sequence, depth: int = 32,
                 channels: Optional[Sequence[str]] = None,
                 dtype=None, raw: bool = False):
        self._readers = list(readers)
        self._channels = channels
        self._dtype = dtype
        self._raw = raw
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._done = False
        self._stop = threading.Event()
        self._live = len(readers)
        self._live_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, args=(r,), daemon=True)
            for r in self._readers]
        for t in self._threads:
            t.start()

    def _put_marker(self, marker):
        while not self._stop.is_set():
            try:
                self._queue.put(marker, timeout=0.2)
                return
            except queue.Full:
                continue

    def _run(self, reader):
        failed = False
        try:
            while not self._stop.is_set():
                if self._raw:
                    kw = {"dtype": None, "adctoamp": False}
                else:
                    kw = ({} if self._dtype is None
                          else {"dtype": self._dtype})
                traces, admin = reader.read_next_event(
                    channels=self._channels, **kw)
                if traces is None:
                    break
                while not self._stop.is_set():
                    try:
                        self._queue.put((traces, admin), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:   # raised on the consumer's side
            if self._error is None:
                self._error = exc
            failed = True
        finally:
            if failed:
                self._put_marker(self._ERROR)
            with self._live_lock:
                self._live -= 1
                last = self._live == 0
            if last:
                # only the last worker posts the end marker
                self._put_marker(_SENTINEL)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._ERROR or item is _SENTINEL:
            self._done = True
            if self._error is not None:
                err = self._error
                self.close()
                raise err
            raise StopIteration
        return item

    def read_next_event(self, channels=None):
        """As ``RawReader.read_next_event``: (None, None) at the end."""
        try:
            return next(self)
        except StopIteration:
            return None, None

    def close(self):
        """Stop the threads, drain the queue, close the readers. A reader
        whose thread did not stop within 5 s is left open rather than
        closed under a running read."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        leftover = []
        for t, r in zip(self._threads, self._readers):
            t.join(timeout=5.0)
            if t.is_alive():
                leftover.append(r)
                continue
            try:
                r.close()
            except Exception:
                pass
        self._readers = leftover


class OrderedChunkPrefetcher:
    """Run ``fn(state, chunk)`` over ``chunks`` in one thread per entry
    of ``states``, yielding the results in chunk ORDER.

    Chunk i goes to worker i % N, which pushes its results in order onto
    its own bounded queue (``depth``); the consumer takes from the queues
    in turn, which restores the order with no reassembly buffer. Each
    worker has its own ``state`` (e.g. its own buffers): workers share
    nothing.
    """

    def __init__(self, fn, chunks: Sequence, states: Sequence,
                 depth: int = 2):
        self._fn = fn
        self._chunks = list(chunks)
        self._n = max(1, len(states))
        self._queues = [queue.Queue(maxsize=max(depth, 1))
                        for _ in range(self._n)]
        self._stop = threading.Event()
        self._errors: list = []
        self._threads = [
            threading.Thread(target=self._run, args=(w, states[w]),
                             daemon=True)
            for w in range(self._n)]
        for t in self._threads:
            t.start()

    def _run(self, w: int, state):
        q = self._queues[w]
        try:
            for i in range(w, len(self._chunks), self._n):
                if self._stop.is_set():
                    return
                result = self._fn(state, self._chunks[i])
                while not self._stop.is_set():
                    try:
                        q.put(result, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:
            self._errors.append(exc)
        finally:
            while not self._stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        nyield = 0
        try:
            while nyield < len(self._chunks):
                q = self._queues[nyield % self._n]
                item = q.get()
                if item is _SENTINEL:
                    # a worker with chunks left ends early only on error
                    raise (self._errors[0] if self._errors else
                           RuntimeError("chunk reader ended early"))
                nyield += 1
                yield item
            if self._errors:
                raise self._errors[0]
        finally:
            self.close()

    def close(self):
        self._stop.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)


def prefetch_events(reader, depth: int = 32,
                    channels: Optional[Sequence[str]] = None,
                    dtype=None, raw: bool = False, nreaders: int = 1):
    """A read-ahead wrapper of ``reader``: ``raw=True`` reads stored-dtype
    traces with no conversion; ``nreaders > 1`` splits the files over that
    many threads (``reader.split``), in no fixed event order."""
    if nreaders > 1 and hasattr(reader, "split"):
        readers = reader.split(nreaders)
        if len(readers) > 1:
            return ParallelEventPrefetcher(
                readers, depth=depth, channels=channels, dtype=dtype,
                raw=raw)
    return EventPrefetcher(reader, depth=depth, channels=channels,
                           dtype=dtype, raw=raw)
