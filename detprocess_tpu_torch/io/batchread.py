"""One batch of raw events into a host buffer: the reads of both shells'
reader threads (``pipelines/features.py``, ``pipelines/triggers.py``).

A :class:`BatchReader` holds what one ``process()`` call fixes: the
index, the channels read, the events' length (the trigger window's in the
feature shell's trigger-table mode), where the ADC conversion runs and a
host injector. :meth:`BatchReader.read` fills a buffer's rows with one
batch of events, whole or in windows:

- where whole events of every channel are read in the buffer's dtype,
  each run of events that lie back to back in one file
  (``RawIndex.runs``) is one ``os.preadv`` straight into its rows;
- every other event is read on its own, straight into its row where the
  dtypes agree: a whole event of every channel in one call, else one
  call a channel row (h5py hyperslabs for an ``H5Dataset``). An event
  whose windows in the batch cover at least ``coalesce_fraction`` of its
  trace is read once, whole, and sliced;
- where the conversion runs on the card, integer codes stay as stored
  (anything else is cast into the buffer) and the call returns the
  batch's float32 factors; on the host the stored values become float64
  amps (``stored · conv``), salted by a host injector and cast into the
  buffer, or, without an injector, are converted in the buffer's dtype.

Reads are counted at the call (``READ_COUNTS``), an ``H5Dataset`` as if
it were read by ``preadv``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from detprocess_tpu_torch.io.fastio import FastDataset
from detprocess_tpu_torch.utils.logging import span

# a batch's read counts, in the order :meth:`BatchReader.read` returns them
READ_COUNTS = ("read_calls", "read_bytes", "read_runs", "run_events")


class BatchReader:
    """Batches of the :class:`~detprocess_tpu_torch.io.rawdata.RawIndex`
    ``index`` through ``fast`` (an ``io/fastio.FastReader``).

    ``channels``: the names read, None for every stored channel;
    ``n``: the samples of a row (the events' length, or a window's);
    ``dtype``: the run's float dtype; ``host_convert``: convert on the
    host (else on the card); ``injector``: a host injector
    (``Salting.make_injector``) called on each event's float64 amps,
    which needs ``host_convert``. ``timer``: a ``utils.logging.
    StageTimer`` that times :meth:`fill`'s reads as a span ``read.fill``.
    """

    def __init__(self, index, fast, channels: Optional[Sequence[str]],
                 n: int, dtype, host_convert: bool, injector=None,
                 coalesce_fraction: float = 0.5, timer=None):
        self._index = index
        self.channels = list(index.channels if channels is None
                             else channels)
        self._fast = fast
        self._n = n
        self._host = host_convert
        self._inject = injector
        self._coalesce = coalesce_fraction
        self._timer = timer
        # per file: the channel rows read (None: every row, in one call)
        # and their float64 factors
        self._sel = []
        for f in index.files:
            sel = (None if channels is None
                   else [f.channels.index(c) for c in channels])
            self._sel.append(None if sel == list(range(len(f.channels)))
                             else sel)
        self._whole = np.asarray([s is None for s in self._sel], bool)
        self._conv = [f.conv if s is None else f.conv[s]
                      for f, s in zip(index.files, self._sel)]
        stored = (index.datasets[int(index.order[0])].dtype if len(index)
                  else np.dtype(dtype))
        # the buffers' dtype: integer codes converted on the card are
        # read as stored, anything else as ``dtype``
        self.dtype = (stored if not host_convert and stored.kind in "iu"
                      else np.dtype(dtype))
        self._conv32 = None
        if not host_convert:
            self._conv32 = np.stack([c.astype(np.float32)
                                     for c in self._conv])
            index.extents()             # built once, before the readers

    def fill(self, ring, rows, starts=None, batch=None):
        """Take a buffer of ``ring`` (an ``io/upload.BufferRing``) and
        :meth:`read` one batch into it, the reads a span ``read.fill``
        (``batch``: its number); returns (ring, buffer, read counts,
        factors or None)."""
        buf = ring.acquire()
        with span(self._timer, "read.fill", batch):
            reads, conv = self.read(buf[1], rows, starts)
        return ring, buf, reads, conv

    def read(self, arr, rows, starts=None):
        """Read the events of the index rows ``rows`` (with ``starts``:
        the windows of ``n`` samples that start there) into
        ``arr[:len(rows)]``. Returns the read counts (``READ_COUNTS``)
        and, where the conversion runs on the card, the rows' float32
        factors [len(rows), C] (else None)."""
        idx, fast, n = self._index, self._fast, self._n
        runs = (idx.runs(rows, self._whole, arr)
                if starts is None and not self._host else [])
        single = np.ones(len(rows), bool)
        nbytes = 0
        for a, b in runs:
            ds = idx.datasets[int(rows[a])]
            fast.read(FastDataset(ds.path, ds.offset,
                                  (b - a,) + tuple(ds.shape), ds.dtype),
                      out=arr[a:b])
            single[a:b] = False
            nbytes += arr[a:b].nbytes
        calls = len(runs)
        coalesce = set()
        if starts is not None:
            ev_rows, counts = np.unique(rows, return_counts=True)
            coalesce = {int(r) for r, c in zip(ev_rows, counts)
                        if c * n >= self._coalesce
                        * idx.files[int(idx.file[r])].nb_samples}
        full = {}
        for i in np.flatnonzero(single).tolist():
            row = int(rows[i])
            fi = int(idx.file[row])
            ds = idx.datasets[row]
            sel = self._sel[fi]
            nrows = ds.shape[0] if sel is None else len(sel)
            window = None if starts is None else (int(starts[i]), n)
            if window is None and ds.shape[-1] != n:
                raise ValueError(
                    f"event of {ds.shape[-1]} samples in "
                    f"{idx.files[fi].path}; the run's events have {n}")
            if window is not None and row in coalesce:
                if row not in full:
                    if len(full) >= 2:          # a few full traces at most
                        full.clear()
                    full[row] = fast.read(ds, None, rows=sel)
                    calls += 1 if sel is None else nrows
                    nbytes += full[row].nbytes
                stored = full[row][:, window[0]:window[0] + n]
            else:
                # a window is read row by row
                calls += 1 if sel is None and window is None else nrows
                nbytes += nrows * n * ds.dtype.itemsize
                if not self._host and ds.dtype == arr.dtype:
                    fast.read(ds, window, rows=sel, out=arr[i])
                    continue
                stored = fast.read(ds, window, rows=sel)
            if not self._host:
                arr[i] = stored
            elif self._inject is not None:
                # one pass: the float64 cast and the product
                amps = np.multiply(stored, self._conv[fi][:, None],
                                   dtype=np.float64)
                arr[i] = self._inject(amps, idx.admin(row),
                                      window_start=0 if window is None
                                      else window[0], channels=self.channels)
            else:
                conv = self._conv[fi][:, None].astype(arr.dtype)
                np.multiply(stored.astype(arr.dtype), conv, out=arr[i])
        counts = (calls, nbytes, len(runs), int((~single).sum()))
        if self._host:
            return counts, None
        return counts, self._conv32[idx.file[rows]]
