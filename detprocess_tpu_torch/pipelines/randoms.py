"""Randoms: random trigger times in continuous data, and their windows.

Port of ``detprocess_tpu/pipelines/randoms.py::Randoms`` (:29; the
reference's detprocess/process/randoms.py:174-788). :meth:`Randoms.process`
samples the trigger table from the index's metadata alone, with the JAX
draws in the JAX order:

- ``np.random.default_rng(seed)``: ``rng.random()`` for an event only when
  the event fraction is below 1, then ``rng.choice(nb_reduced,
  per_event, replace=False)``, sorted;
- the cap ``nrandoms``: pandas' ``df.sample(n, random_state=seed)`` is
  ``np.random.RandomState(seed).choice(len, n, replace=False)``, taken
  here without pandas and sorted stably by (series, event,
  trigger_index);
- the separation and the edges shrink to fit a short trace, and each
  event's time runs on from the last one's when it does not advance.

The JAX loop reads every event's traces for its admin; here nothing is
read. The table is a dict of numpy columns (``io/tables.to_dataframe``
makes the JAX DataFrame).

:meth:`Randoms.read_random_traces` reads each row's window ([trigger −
pretrigger, + N), with the JAX reader's clamp of a negative start to 0),
drops the windows shorter than N (those that overrun the trace), reads
the kept ones as stored (int16 codes) with ``os.preadv`` in
:data:`READERS` threads, and converts them on the device (``io/upload``:
the codes cross the bus at 2 bytes a sample). Float64 converts on the
host, as the JAX reader does. A row whose (series, dump) is in no file of the index is
refused; the JAX reader falls back to its first file.

``device=None`` means the GPU (``device.require_cuda``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.fastio import FastReader
from detprocess_tpu_torch.io.rawdata import RawIndex, extract_series_name
from detprocess_tpu_torch.io.upload import Uploader
from detprocess_tpu_torch.utils.misc import create_series_name

READERS = 4          # threads reading the windows

class Randoms:
    """Random trigger-time sampler over continuous raw data (a
    :class:`RawIndex`, or pytesdaq paths)."""

    def __init__(self, raw, processing_id: Optional[str] = None,
                 facility: int = 1, verbose: bool = True, device=None):
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._index = (raw if isinstance(raw, RawIndex)
                       else RawIndex.from_files(raw))
        self._verbose = verbose
        self._facility = facility
        self._processing_id = processing_id
        self._output_group_path: Optional[str] = None
        self.stats: dict = {}

    @property
    def index(self) -> RawIndex:
        return self._index

    @property
    def verbose(self) -> bool:
        return self._verbose

    @verbose.setter
    def verbose(self, value: bool):
        self._verbose = bool(value)

    def get_series_dict(self) -> dict:
        """{series name: [files]} of the input data."""
        out: dict = {}
        for fname in self._index.paths:
            try:
                out.setdefault(extract_series_name(fname), []).append(fname)
            except ValueError:
                continue
        return out

    def _group_dir(self) -> str:
        """The raw group's directory: the files' own, or one up when it is
        named after their series (``{group}/{series}/*``)."""
        first = self._index.paths[0]
        d = os.path.dirname(os.path.abspath(first))
        try:
            if os.path.basename(d) == extract_series_name(first):
                d = os.path.dirname(d)
        except ValueError:
            pass
        return d

    def get_base_path(self) -> str:
        return os.path.dirname(self._group_dir())

    def get_group_name(self) -> str:
        return os.path.basename(self._group_dir())

    def get_output_path(self) -> Optional[str]:
        return self._output_group_path

    # -- sampling -----------------------------------------------------------
    def process(self, random_rate: Optional[float] = None,
                nrandoms: Optional[int] = None,
                min_separation_msec: float = 100.0,
                edge_exclusion_msec: float = 50.0,
                restricted: bool = False,
                seed: Optional[int] = None,
                lgc_save: bool = False,
                output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "randoms",
                lgc_output: bool = True) -> Optional[dict]:
        """The randoms table: ``random_rate`` (Hz) sets the count an event,
        ``nrandoms`` caps the total (or, alone, spreads that count over
        the events)."""
        if random_rate is None and nrandoms is None:
            raise ValueError('"random_rate" or "nrandoms" required')
        idx = self._index
        rng = np.random.default_rng(seed)
        md = idx.get_metadata()
        fs = float(md["sample_rate"])
        nb_samples = int(md["nb_samples"])
        trace_length_sec = nb_samples / fs

        min_sep = int(np.ceil(fs * min_separation_msec * 1e-3))
        edge = int(np.ceil(fs * edge_exclusion_msec * 1e-3))
        if random_rate is not None:
            random_length_sec = 1.0 / random_rate
            per_event = max(int(round(trace_length_sec / random_length_sec)),
                            1)
            event_fraction = min(trace_length_sec / random_length_sec, 1.0)
        else:
            per_event = max(-(-nrandoms // max(len(idx), 1)), 1)
            event_fraction = 1.0

        nb_reduced = nb_samples - 2 * edge - (per_event - 1) * min_sep
        if nb_reduced <= per_event:
            # shrink the separation, then the edges, to fit the trace
            margin = 4 * per_event
            min_sep = max((nb_samples - 2 * edge - margin)
                          // max(per_event - 1, 1), 0)
            nb_reduced = nb_samples - 2 * edge - (per_event - 1) * min_sep
            if nb_reduced <= per_event:
                edge = max((nb_samples - margin
                            - (per_event - 1) * min_sep) // 2, 0)
                nb_reduced = (nb_samples - 2 * edge
                              - (per_event - 1) * min_sep)
            if nb_reduced <= per_event:
                raise ValueError(
                    f"trace too short for {per_event} randoms per event")
            if self._verbose:
                print(f"INFO: reduced randoms min separation to "
                      f"{min_sep / fs * 1e3:.1f} msec to fit the trace")

        spread = np.arange(per_event) * min_sep + edge
        rows, indices, times = [], [], []
        current_time = None
        for row in idx.order:
            event_time = float(idx.event_time[row])
            if current_time is None or event_time > current_time:
                current_time = event_time
            else:
                current_time += trace_length_sec
            if event_fraction < 1.0 and rng.random() > event_fraction:
                continue
            picks = np.sort(rng.choice(nb_reduced, size=per_event,
                                       replace=False))
            rows.append(np.full(per_event, row))
            indices.append(picks + spread)
            times.append(np.full(per_event, current_time))
        table = self._table(rows, indices, times, fs, min_separation_msec,
                            edge_exclusion_msec)

        ntab = len(table["trigger_index"])
        if nrandoms is not None and ntab > nrandoms:
            state = np.random if seed is None else np.random.RandomState(seed)
            pick = state.choice(ntab, size=nrandoms, replace=False)
            order = np.lexsort((table["trigger_index"][pick],
                                table["event_number"][pick],
                                table["series_number"][pick]))
            table = {k: v[pick[order]] for k, v in table.items()}

        if lgc_save and len(table["trigger_index"]):
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            self._output_group_path = output_path
            out_series = series_name or create_series_name(self._facility)
            path = tables.output_file_name(
                output_path, "rand", group_name, out_series, 1,
                tables.table_ext(output_format))
            tables.write_table(table, path, fmt=output_format)
            tables.write_job_summary(
                output_path, "rand", group_name, out_series, {
                    "workload": "randoms",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "randoms": int(len(table["trigger_index"])),
                    "random_rate_hz": random_rate,
                    "min_separation_msec": min_separation_msec,
                    "edge_exclusion_msec": edge_exclusion_msec,
                })
        return table if lgc_output else None

    def _table(self, rows, indices, times, fs, min_separation_msec,
               edge_exclusion_msec) -> dict:
        """The table's columns from the picks of each event."""
        idx = self._index
        row = np.concatenate(rows).astype(np.int64) if rows else \
            np.zeros(0, np.int64)
        ti = np.concatenate(indices).astype(np.int64) if indices else \
            np.zeros(0, np.int64)
        tnow = np.concatenate(times) if times else np.zeros(0)
        tt = ti / fs
        admin = [idx.files[int(f)].admin for f in idx.file[row]]
        n = len(ti)
        return {
            "series_number": np.array([a["series_number"] for a in admin],
                                      np.int64),
            "event_number": idx.event_number[row],
            "dump_number": np.array([a["dump_number"] for a in admin],
                                    np.int64),
            "event_time": np.rint(tnow + tt).astype(np.int64),
            "trigger_index": ti,
            "trigger_time": tt,
            "trigger_type": np.full(n, 3, np.int64),
            "data_type": np.array([a["data_type"] for a in admin],
                                  dtype=object),
            "group_name": np.array([a["group_name"] for a in admin],
                                   dtype=object),
            "trigger_prod_id": np.arange(1, n + 1, dtype=np.int64),
            "randoms_min_separation_time": np.full(
                n, min_separation_msec * 1e-3),
            "randoms_edge_exclusion_time": np.full(
                n, edge_exclusion_msec * 1e-3),
            "processing_id": np.array([self._processing_id or ""] * n,
                                      dtype=object),
        }

    # -- windows ------------------------------------------------------------
    def window_rows(self, table: dict, trace_length_samples: int,
                    pretrigger_length_samples: int):
        """(index rows, window starts, table rows) of the windows of
        ``table`` that lie inside their trace: a negative start reads from
        0 (the JAX reader's clamp); a window that overruns the trace is
        dropped."""
        idx = self._index
        by_dump = {}
        for fi, f in enumerate(idx.files):
            by_dump.setdefault((int(f.metadata.get("series_num", -1)),
                                int(f.metadata.get("dump_num", -1))), fi)
        rows, starts, kept = [], [], []
        for r, (ser, dump, ev, ti) in enumerate(zip(
                table["series_number"], table["dump_number"],
                table["event_number"], table["trigger_index"])):
            fi = by_dump.get((int(ser), int(dump)))
            if fi is None:
                raise ValueError(f"randoms row {r}: no file of series "
                                 f"{int(ser)}, dump {int(dump)} in the "
                                 "raw data")
            row = idx.lookup.get((fi, int(ev)))
            if row is None:
                raise KeyError(f"no event with event_num={int(ev)} in "
                               f"{idx.files[fi].path}")
            start = max(0, int(ti) - pretrigger_length_samples)
            if start + trace_length_samples > idx.files[fi].nb_samples:
                continue
            rows.append(row)
            starts.append(start)
            kept.append(r)
        return (np.asarray(rows, np.int64), np.asarray(starts, np.int64),
                np.asarray(kept, np.int64))

    def read_random_traces(self, table: dict, trace_length_samples: int,
                           pretrigger_length_samples: int,
                           channels: Optional[Sequence[str]] = None,
                           dtype=None, timer=None) -> torch.Tensor:
        """The windows [B, C, N] of the table's rows on the device, in
        amps (float32 on the GPU, float64 on the CPU unless ``dtype``
        says), the windows shorter than N left out."""
        dtype = dtype or (torch.float32 if self._device.type == "cuda"
                          else torch.float64)
        stage = timer.stage if timer is not None else (
            lambda name: nullcontext())
        n = trace_length_samples
        idx = self._index
        with stage("read"):
            rows, starts, _ = self.window_rows(table, n,
                                               pretrigger_length_samples)
        chans = idx.channels if channels is None else list(channels)
        stored = idx.datasets[0].dtype if len(idx.datasets) else np.int16
        with stage("buffer"):
            host = torch.empty((len(rows), len(chans), n),
                               dtype=torch.from_numpy(
                                   np.empty(0, stored)).dtype,
                               pin_memory=self._device.type == "cuda")
        with stage("read"):
            buf = host.numpy()
            conv = np.empty((len(rows), len(chans)))
            chan_rows = [[f.channels.index(c) for c in chans]
                         for f in idx.files]
            reader = FastReader()

            def read(part):
                for i in part:
                    fi = int(idx.file[rows[i]])
                    reader.read(idx.datasets[rows[i]], (int(starts[i]), n),
                                rows=chan_rows[fi], out=buf[i])
                    conv[i] = idx.files[fi].conv[chan_rows[fi]]

            parts = np.array_split(np.arange(len(rows)),
                                   max(1, min(READERS, len(rows))))
            try:
                with ThreadPoolExecutor(len(parts)) as pool:
                    for fut in [pool.submit(read, p) for p in parts]:
                        fut.result()
            finally:
                reader.close()
        with stage("upload"):
            if dtype == torch.float64 and self._device.type == "cpu":
                # host conversion in float64, as the JAX reader converts
                x = torch.from_numpy(buf.astype(np.float64)
                                     * conv[:, :, None])
                self.stats.update(upload_bytes=0, upload_samples=0)
            else:
                up = Uploader(self._device)
                x, copied = up.upload(host, conv, dtype)
                if copied is not None:
                    copied.synchronize()        # the host buffer is free
                self.stats.update(upload_bytes=up.bytes,
                                  upload_samples=up.samples)
        self.stats.update(windows=len(rows), dropped=len(
            table["trigger_index"]) - len(rows))
        return x
