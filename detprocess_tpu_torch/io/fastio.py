"""pread(2) reads of raw event datasets.

The read half of ``detprocess_tpu/io/fastio.py``. Raw detector files
store each event as one contiguous block ([C, N] int16 ADC codes, or
float); a :class:`FastDataset` names it by ``(path, offset, shape,
dtype)``, and :class:`FastReader` serves it with ``os.preadv`` into a
preallocated buffer:

- thread-safe: ``preadv`` is a positioned syscall with no shared seek
  pointer and no library lock, so reader threads scale;
- one copy: page cache → the destination buffer, which may be the
  caller's own (``out=``, e.g. a slot of a pinned upload buffer);
- windowed and channel-subset reads are a few small positioned reads;
- a run of whole events stored back to back in one file is read as one
  :class:`FastDataset` of shape [k, C, N] at the first event's offset:
  one call for the run.

:func:`dataset_storage` and :meth:`FastReader.resolve` resolve an h5py
dataset to its block (h5py's own module is imported only when they are
called, with a dataset of an open file); ``io/rawdata.py`` indexes
pytesdaq files with them.

A dataset that is not one such block (chunked, compressed, compact,
big-endian or unallocated storage) is named by an :class:`H5Dataset`
(path, dataset name, shape, native dtype) instead, and
:meth:`FastReader.read` serves it through h5py hyperslabs, as the JAX
reader falls back to h5py (JAX ``io/rawdata.py:502-520``), into the same
destination buffers in the native form of the stored dtype: each thread
keeps its own h5py handle a file. Only machines with h5py can index such
a file, so this path adds no dependency.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np


class FastDataset(NamedTuple):
    path: str
    offset: int                     # absolute file offset of element 0
    shape: Tuple[int, ...]
    dtype: np.dtype                 # native-endian


class H5Dataset(NamedTuple):
    """An event dataset read through h5py (storage the pread path cannot
    serve)."""

    path: str
    name: str                       # the dataset's path in the file
    shape: Tuple[int, ...]
    dtype: np.dtype                 # native-endian


def dataset_storage(ds) -> Optional[Tuple[int, Tuple[int, ...], np.dtype]]:
    """(offset, shape, native dtype) of an h5py dataset stored as one
    contiguous, allocated, unfiltered, little-endian block of at most two
    dimensions, else None."""
    from h5py import h5d

    try:
        plist = ds.id.get_create_plist()
        if plist.get_layout() != h5d.CONTIGUOUS:
            return None
        if plist.get_nfilters() != 0:
            return None
        offset = ds.id.get_offset()
    except Exception:
        return None
    if offset is None:
        return None                 # storage not allocated yet
    dt = ds.dtype
    if dt.kind not in "iuf" or dt.byteorder == ">" or (
            dt.byteorder == "=" and sys.byteorder == "big"):
        return None
    if len(ds.shape) > 2:
        return None
    return int(offset), tuple(int(s) for s in ds.shape), dt.newbyteorder("=")


class FastReader:
    """pread engine with per-thread file-descriptor caches.

    Descriptors are opened read-only on first use and kept, at most
    ``max_fds`` per thread. Each thread owns its descriptors, so an
    eviction can never close a descriptor that another thread is reading
    (a shared cache could: EBADF at best, and a read of the wrong file if
    the number was reused by a concurrent open). Descriptors of threads
    that have exited are closed on the next ``_fd()`` call from any
    thread, so repeated runs with fresh reader threads cannot pile them up.
    """

    def __init__(self, max_fds: int = 128):
        self._max_fds = max_fds
        self._tls = threading.local()
        self._all_fds: set = set()       # every open fd, for close()
        self._gen = 0                    # bumped by close()
        self._lock = threading.Lock()
        self._thread_caches: list = []   # [(weakref(thread), fds dict)]
        self._entries: dict = {}         # (path, dataset) → entry or None
        self._h5_files: list = []        # every h5py handle, for close()

    def resolve(self, path: str, ds) -> Optional[FastDataset]:
        """The :class:`FastDataset` of the h5py dataset ``ds`` of the file
        at ``path``, or None where :func:`dataset_storage` refuses it; each
        (path, dataset name) is resolved once."""
        key = (path, ds.name)
        if key not in self._entries:
            storage = dataset_storage(ds)
            self._entries[key] = (None if storage is None
                                  else FastDataset(path, *storage))
        return self._entries[key]

    def _reap_dead_threads_locked(self) -> None:
        """Close the fds of exited threads (caller holds ``_lock``). Only
        fds still registered in ``_all_fds`` are closed, so numbers left
        over from before a ``close()`` are never closed twice."""
        live = []
        for ref, fds in self._thread_caches:
            t = ref()
            if t is not None and t.is_alive():
                live.append((ref, fds))
                continue
            for fd in fds.values():
                if fd in self._all_fds:
                    self._all_fds.discard(fd)
                    try:
                        os.close(fd)
                    except OSError:
                        pass
        self._thread_caches = live

    def _fd(self, path: str) -> int:
        tls = self._tls
        if getattr(tls, "gen", None) != self._gen:
            import weakref
            tls.fds = {}
            tls.gen = self._gen
            with self._lock:
                self._thread_caches.append(
                    (weakref.ref(threading.current_thread()), tls.fds))
                self._reap_dead_threads_locked()
        fd = tls.fds.get(path)
        if fd is not None:
            return fd
        if len(tls.fds) >= self._max_fds:
            old_path, old_fd = next(iter(tls.fds.items()))
            del tls.fds[old_path]
            with self._lock:
                self._all_fds.discard(old_fd)
            os.close(old_fd)             # this thread's alone
        fd = os.open(path, os.O_RDONLY)
        tls.fds[path] = fd
        with self._lock:
            self._all_fds.add(fd)
        return fd

    def _h5(self, path: str):
        """This thread's h5py handle of ``path``."""
        tls = self._tls
        if getattr(tls, "h5_gen", None) != self._gen:
            tls.h5, tls.h5_gen = {}, self._gen
        f = tls.h5.get(path)
        if f is None:
            import h5py

            f = tls.h5[path] = h5py.File(path, "r")
            with self._lock:
                self._h5_files.append(f)
        return f

    def read(self, entry, window: Optional[Tuple[int, int]] = None,
             rows=None, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Read the whole dataset, or ``window=(start, length)`` sample
        columns of a [C, N] dataset (a negative start clamps to 0, an
        overrun truncates at N), or only the channel ``rows`` (each row is
        contiguous, so bytes read follow the rows asked for); both
        combine. ``out``: a C-contiguous array of the result's shape and
        the dataset's dtype to read into. ``entry`` is a
        :class:`FastDataset` (pread) or an :class:`H5Dataset` (h5py)."""
        h5 = isinstance(entry, H5Dataset)
        if window is None and rows is None:
            out = _out(out, entry.shape, entry.dtype)
            if h5:
                self._h5(entry.path)[entry.name].read_direct(out)
            else:
                self._pread_into(self._fd(entry.path),
                                 out.reshape(-1).view(np.uint8),
                                 entry.offset, path=entry.path)
            return out
        if len(entry.shape) != 2:
            raise ValueError("windowed/row-subset fast reads need a "
                             "[C, N] dataset")
        nchan, nsamp = entry.shape
        row_list = (list(range(nchan)) if rows is None
                    else [int(r) for r in rows])
        if window is None:
            start, width = 0, nsamp
        else:
            start, length = window
            start = max(0, int(start))
            stop = min(nsamp, start + max(0, int(length)))
            width = max(0, stop - start)
        out = _out(out, (len(row_list), width), entry.dtype)
        if h5:
            # one hyperslab of the window, then the rows asked for
            if width and row_list:
                ds = self._h5(entry.path)[entry.name]
                out[...] = ds[:, start:start + width][row_list]
            return out
        fd = self._fd(entry.path)
        itemsize = entry.dtype.itemsize
        row_bytes = nsamp * itemsize
        flat = out.view(np.uint8).reshape(len(row_list), -1)
        for i, c in enumerate(row_list):
            self._pread_into(
                fd, flat[i], entry.offset + c * row_bytes + start * itemsize,
                path=entry.path)
        return out

    @staticmethod
    def _pread_into(fd: int, buf: np.ndarray, offset: int,
                    path: str = "?") -> None:
        """Fill ``buf`` (a uint8 view) from ``fd`` at ``offset``, looping
        on short reads."""
        view = memoryview(buf)
        total = len(view)
        got = 0
        while got < total:
            n = os.preadv(fd, [view[got:]], offset + got)
            if n <= 0:
                raise IOError(
                    f"short read in raw file '{path}': wanted {total} "
                    f"bytes at {offset}, got {got} — truncated dump?")
            got += n

    def close(self) -> None:
        """Close every cached fd (all threads). Concurrent readers must
        have stopped first."""
        with self._lock:
            self._gen += 1
            fds, self._all_fds = self._all_fds, set()
            self._thread_caches = []
            h5_files, self._h5_files = self._h5_files, []
        for f in h5_files:
            try:
                f.close()
            except Exception:
                pass
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _out(out, shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {tuple(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    return out
