"""Feature extraction over raw event files: the ``FeatureProcessing``
shell around the feature plan's group steps.

Port of ``detprocess_tpu/pipelines/features.py::FeatureProcessing``
(:112). The core imports torch, numpy and the standard library only: it
takes a YAML-form config dict or a ``config.yamlconfig.YamlConfig``, a
:class:`RawIndex` served by ``os.preadv`` and an in-memory
:class:`FilterData`, and returns the feature table as a dict of numpy
columns (None with ``lgc_output=False``, as JAX :1713-1715). File formats
go through adapters that import yaml, h5py or pandas when called: a list
of raw paths (``RawIndex.from_files``: pytesdaq HDF5, or flat dumps), a
setup path (``config.yamlconfig.load_yaml``: JSON, or YAML), a filter-file
path (``FilterData.load``: npz, or HDF5), a trigger-table path
(``io.tables.read_table``), dumps (``io.tables.write_table``) and
``io.tables.to_dataframe`` for the JAX table. External extractors come
from ``external_file`` (the argument wins over the config's, JAX
:156-159) under the torch contract of ``feature_group``.

A ``process()`` call:

1. **Rows.** Full-trace mode reads the index's events in order; trigger-
   table mode reads a window of the trigger geometry around each row's
   ``trigger_index``, drops rows whose file is not in the index or whose
   window leaves the trace (counted and reported), and packs the kept
   rows into batches of ``batch_size`` (only the last may be shorter).
2. **Reads.** ``nreaders`` threads (``io/prefetch.OrderedChunkPrefetcher``)
   read whole batches through ``io/batchread.BatchReader``, the trigger
   shell's reader too, into buffers of their own, yielded in batch
   order, each with its conversion factors. Only the raw channels the
   plan mixes are read. Where whole events of every channel are read in
   the stored dtype, each run of events that lie back to back in one file
   is one read straight into the batch buffer's rows. In a window-dense
   event (the batch's windows cover at least ``COALESCE_FRACTION`` of its
   trace) the event is read once and sliced.
3. **Upload.** In float32 the int16 ADC codes are read as stored into a
   ring of pinned host buffers, copied to the card ``non_blocking`` on a
   side stream behind an event that the compute stream waits on, and
   converted there (``io/upload.py``); a buffer is read into again only
   after its copy's event has completed. Float64 reads convert on the
   host (the golden-precision path), as the JAX shell does; on the card
   a float64 run takes cuFFT for its spectra (``ops/fft.rfft``'s counted
   ``cufft_rfft_f64`` route) and no hand-written kernel, whose type is
   float32.
4. **Compute.** Each trace group's :class:`GroupStep` on the batch; the
   [B] columns are stacked into one [ncol, B] tensor and copied to pinned
   memory ``non_blocking`` behind an event. ``pipeline_depth`` batches
   stay in flight.
5. **Drain.** Admin columns are numpy gathers from the index's
   per-event arrays and the trigger table's columns, whole batch at a
   time; dumps and the job summary as the JAX shell writes them.

Salting (:meth:`FeatureProcessing.set_salting`, JAX :245): a host
injector (``Salting.make_injector``) adds the salts into each event's
traces in the reader threads, on float64 reads converted on the host, as
the JAX shell does; a device injector (``Salting.make_device_injector``)
keeps the stored-dtype reads, and its plan for the batch's rows and
window starts is added on the device right after the conversion, before
the group steps. Both map the salts' channels by name onto the channels
read. ``resume`` continues the newest dump series in ``output_path``
after the rows its dumps hold (JAX :1521-1529, :1721).

The mesh (``process(mesh=...)``, a ``parallel/mesh.Mesh`` of this
process's devices; JAX :611, :1471-1478, :1609-1630): each batch's rows
are split over the shards (unevenly where they do not divide; an empty
shard is skipped, where JAX pads), each shard's rows go up on its
device's side stream, the salt plan goes with its rows, each shard runs
its own group steps (banks and kernel constants on its device) and copies
its columns to the host once; the drain gathers them in row order. This
holds in full-trace and trigger-table mode, and with ``resume``.

``device=None`` means the GPU (``device.require_cuda``); the CPU runs
only when the caller passes ``"cpu"``.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import List, Optional

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.config.yamlconfig import resolve_config
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.batchread import READ_COUNTS, BatchReader
from detprocess_tpu_torch.io.fastio import FastReader
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.prefetch import OrderedChunkPrefetcher
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.io.upload import BufferRing, Uploader
from detprocess_tpu_torch.ops.saltinject import split_injector
from detprocess_tpu_torch.parallel.collectives import bounds, check_mesh
from detprocess_tpu_torch.pipelines import feature_plan as fplan
from detprocess_tpu_torch.pipelines.feature_group import GroupStep
from detprocess_tpu_torch.pipelines.feature_plan import (  # noqa: F401
    AlgoSpec, TraceGroup)
from detprocess_tpu_torch.utils.logging import layer_spans, span
from detprocess_tpu_torch.utils.misc import create_series_name

TRIGGER_COLUMNS = ("trigger_index", "trigger_time", "trigger_delta_chi2",
                   "trigger_amplitude", "trigger_prod_id", "trigger_channel")
STAMP_COLUMNS = ("series_start_time", "group_start_time",
                 "fridge_run_start_time")


class FeatureProcessing:
    """Feature extraction over raw event files."""

    # a trigger-table event whose windows in one batch cover at least
    # this fraction of its trace is read once, whole, and sliced
    COALESCE_FRACTION = 0.5
    # batches each reader thread reads ahead of the consumer
    READ_AHEAD = 1

    def __init__(self, raw, config, filter_data=None, trigger_table=None,
                 external_file: Optional[str] = None,
                 processing_id: Optional[str] = None,
                 restricted: bool = False, calib: bool = False,
                 facility: int = 1, verbose: bool = True, device=None):
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._verbose = verbose
        self._facility = facility
        self._processing_id = processing_id
        self._restricted = restricted
        self._calib = calib

        self._index = (raw if isinstance(raw, RawIndex)
                       else RawIndex.from_files(raw))
        self._fs = self._index.sample_rate
        self._available_channels = self._index.channels

        if isinstance(trigger_table, str):
            trigger_table = tables.read_table(trigger_table)
        elif trigger_table is not None and not isinstance(trigger_table,
                                                          dict):
            # a DataFrame, or any table with columns
            trigger_table = {c: trigger_table[c].to_numpy()
                             for c in trigger_table.columns}
        self._trigger_table = (None if trigger_table is None else
                               {k: np.asarray(v)
                                for k, v in trigger_table.items()})

        self._config = resolve_config(config, self._available_channels,
                                      self._fs)
        self._feature_config = self._config["feature"]

        # the argument wins over the config's ``external_file``
        ext = external_file or (self._feature_config.get("overall", {})
                                or {}).get("external_file")
        self._extractors = (fplan.load_external_extractors(ext) if ext
                            else {})

        if isinstance(filter_data, str):
            filter_data = FilterData(verbose=verbose).load(filter_data)
        if filter_data is None:
            path = (self._feature_config.get("overall", {}) or {}).get(
                "filter_file")
            if path:
                filter_data = FilterData(verbose=verbose).load(path)
        self._filter_data = filter_data

        md = self._index.get_metadata()
        raw_n = int(md["nb_samples"])
        raw_pre = int(md.get("nb_pretrigger_samples", raw_n // 2))
        self._plan = fplan.build_plan(
            self._feature_config, self._available_channels, self._fs,
            (raw_n, raw_pre), filter_data,
            trigger_mode=self._trigger_table is not None,
            extractors=self._extractors)
        self._steps = {}
        self._injector = None
        self.stats: dict = {}

    def set_salting(self, injector):
        """Inject salts into every trace read (whole events or trigger
        windows): a host injector (``Salting.make_injector``, or any
        callable ``(traces, admin, window_start=, channels=)``; forces
        float64 reads converted on the host) or a device injector
        (``Salting.make_device_injector``; keeps the int16 upload)."""
        self._injector = injector

    # -- accessors (processing_data.py:130, :500, :1230-1279) ------------
    def get_filter_data_inst(self):
        return self._filter_data

    def get_raw_path(self):
        dirs = sorted({os.path.dirname(os.path.abspath(p))
                       for p in self._index.paths})
        return dirs[0] if len(dirs) == 1 else dirs

    def get_sample_rate(self):
        return self._fs

    def get_nb_samples(self) -> int:
        """Raw trace length, or the trigger window's in trigger-table
        mode."""
        return self._plan.raw_nb_samples

    def get_nb_pretrigger_samples(self) -> int:
        return self._plan.raw_pretrigger

    @property
    def plan(self) -> fplan.FeaturePlan:
        return self._plan

    def group_steps(self, dtype=torch.float32, device=None) -> List[GroupStep]:
        """The plan's group steps on ``device`` (default the shell's; a
        mesh's shard device), built once per device and dtype."""
        device = self._device if device is None else torch.device(device)
        if (device, dtype) not in self._steps:
            geom = (self._plan.raw_nb_samples, self._plan.raw_pretrigger)
            self._steps[(device, dtype)] = [
                GroupStep(g, self._fs, geom, device, dtype)
                for g in self._plan.groups]
        return self._steps[(device, dtype)]

    # -- rows ------------------------------------------------------------
    def _trigger_rows(self, nevents: int):
        """(event rows, window starts, table rows, dropped count) of the
        trigger table's first ``nevents`` rows (all for -1)."""
        tab = self._trigger_table
        ntab = tables.table_rows(tab)       # a table without triggers: 0
        if nevents is not None and nevents >= 0:
            ntab = min(ntab, nevents)
        n, pre = self._plan.trigger_geometry
        by_dump = {}
        for fi, f in enumerate(self._index.files):
            key = (int(f.metadata.get("series_num", -1)),
                   int(f.metadata.get("dump_num", -1)))
            by_dump.setdefault(key, fi)
        rows, starts, trows = [], [], []
        for r in range(ntab):
            fi = by_dump.get((int(tab["series_number"][r]),
                              int(tab["dump_number"][r])))
            if fi is None:
                continue
            start = int(tab["trigger_index"][r]) - pre
            if start < 0 or start + n > self._index.files[fi].nb_samples:
                continue
            ev = int(tab["event_number"][r])
            row = self._index.lookup.get((fi, ev))
            if row is None:
                raise KeyError(f"no event with event_num={ev} in "
                               f"{self._index.files[fi].path}")
            rows.append(row)
            starts.append(start)
            trows.append(r)
        return (np.asarray(rows, np.int64), np.asarray(starts, np.int64),
                np.asarray(trows, np.int64), ntab - len(rows))

    # -- process -----------------------------------------------------------
    def process(self, nevents: int = -1, batch_size: int = 256,
                dtype=np.float32, pipeline_depth: int = 4,
                lgc_save: bool = False, output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "features",
                nb_events_per_dump: Optional[int] = None,
                memory_limit=None, resume: bool = False,
                lgc_output: bool = True, mesh=None,
                nreaders: int = 1, timer=None) -> Optional[dict]:
        """Run feature extraction; returns the table as a dict of numpy
        columns (``io.tables.to_dataframe`` makes the JAX DataFrame), or
        None with ``lgc_output=False`` (the rows are then not kept).

        ``nreaders`` reader threads read whole batches, in batch order.
        In full-trace mode ``nreaders > 1`` requires ``nevents=-1`` and no
        ``resume``, as the JAX shell does. ``timer``: a
        ``utils.logging.StageTimer`` that adds up the host seconds of the
        read, dispatch and drain stages and of the spans inside them
        (README's port section names them). With ``lgc_save`` the table is
        written per dump to ``output_path`` (one dump a batch unless
        ``nb_events_per_dump`` or ``memory_limit`` say otherwise) with a
        job summary beside it; ``resume`` then skips the rows the newest
        dump series there already holds and continues its series and
        numbering (the returned table holds the new rows only). ``mesh``:
        a ``parallel/mesh.Mesh`` of this process's devices of the shell's
        type; each batch's rows are split over its shards."""
        devices = ([self._device] if mesh is None
                   else check_mesh(mesh, self._device,
                                   processes=False).devices)
        t_start = time.time()
        trigger_mode = self._trigger_table is not None
        if nreaders > 1 and not trigger_mode and (nevents >= 0 or resume):
            raise ValueError("nreaders > 1 in full-trace mode requires "
                             "processing all events (nevents=-1) "
                             "without resume")
        dtype = np.dtype(dtype)
        if dtype not in (np.float32, np.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        torch_dtype = torch.float64 if dtype == np.float64 else torch.float32
        steps = {d: self.group_steps(torch_dtype, d) for d in devices}
        on_cuda = self._device.type == "cuda"
        out_series = series_name or create_series_name(self._facility)
        skip = dump0 = 0
        if lgc_save:
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            found = (self._scan_resume(output_path, group_name, output_format)
                     if resume else None)
            if found is not None:
                out_series, skip, dump0 = found
                if self._verbose:
                    print(f"INFO: resuming series {out_series} after {skip} "
                          f"events (dump {dump0})")
        stage = (timer.stage if timer is not None
                 else (lambda name: nullcontext()))

        # stored-dtype reads in float32: int16 codes upload as stored and
        # are converted on the card; float64, and a host injector, convert
        # on the host
        inject, device_inject = split_injector(self._injector)
        raw_mode = dtype == np.float32 and inject is None
        if trigger_mode:
            rows, starts, trows, dropped = self._trigger_rows(nevents)
        else:
            rows = self._index.order
            if nevents >= 0:
                rows = rows[:nevents]
            starts = trows = None
            dropped = 0
        if skip:
            rows = rows[skip:]
            starts = None if starts is None else starts[skip:]
            trows = None if trows is None else trows[skip:]
        n = self._plan.raw_nb_samples
        series = np.asarray([f.admin["series_number"]
                             for f in self._index.files], np.int64)
        fast = FastReader()
        reader = BatchReader(self._index, fast, self._plan.read_channels, n,
                             dtype, host_convert=not raw_mode,
                             injector=inject,
                             coalesce_fraction=self.COALESCE_FRACTION,
                             timer=timer)

        chunks = [(rows[i:i + batch_size],
                   None if starts is None else starts[i:i + batch_size],
                   None if trows is None else trows[i:i + batch_size], k)
                  for k, i in enumerate(range(0, len(rows), batch_size))]
        nworkers = max(1, min(nreaders, len(chunks)))
        shape = (min(batch_size, max(len(rows), 1)), len(reader.channels), n)
        rings = [BufferRing(self.READ_AHEAD + 1, shape, reader.dtype,
                            pin=on_cuda, timer=timer)
                 for _ in range(nworkers)]
        source = OrderedChunkPrefetcher(
            lambda ring, chunk: reader.fill(ring, chunk[0], chunk[1],
                                            chunk[3]) + (chunk,),
            chunks, rings, depth=self.READ_AHEAD)
        batches = iter(source)
        uploader = Uploader(self._device, timer)
        run_layer = layer_spans(timer, "spec.")

        self.stats = {"events": 0, "dropped": int(dropped),
                      "upload_bytes": 0, "upload_samples": 0,
                      "batches": 0, "read_calls": 0, "read_bytes": 0,
                      "read_runs": 0, "run_events": 0, "pinned_bytes": 0}
        pinned_out = 0
        state = {"dump": dump0, "pending": [], "frames": [],
                 "keep": lgc_output,
                 "writer": tables.AsyncWriter() if lgc_save else None}
        inflight: List[tuple] = []

        def next_batch():
            with stage("read"):
                return next(batches, None)

        try:
            while (got := next_batch()) is not None:
                with stage("dispatch"):
                    ring, buf, reads, conv, chunk = got
                    nb = len(chunk[0])
                    for k, v in zip(READ_COUNTS, reads):
                        self.stats[k] += v
                    host_t, _ = buf
                    shards = [(d, lo, hi) for d, (lo, hi) in
                              zip(devices, bounds(nb, len(devices)))
                              if hi > lo]        # an empty shard is skipped
                    xs, copies = [], []
                    with span(timer, "dispatch.upload"):
                        for d, lo, hi in shards:
                            x, copied = uploader.upload(
                                host_t[lo:hi],
                                None if conv is None else conv[lo:hi],
                                device=d)
                            xs.append(x)
                            copies.append(copied)
                        if on_cuda:
                            ring.release(buf, copies)
                    self.stats["upload_bytes"] = uploader.bytes
                    self.stats["upload_samples"] = uploader.samples
                    parts = []
                    for x, (d, lo, hi) in zip(xs, shards):
                        rows = chunk[0][lo:hi]
                        if device_inject is not None:
                            device_inject.inject(
                                x, series[self._index.file[rows]],
                                self._index.event_number[rows],
                                window_starts=(None if chunk[1] is None
                                               else chunk[1][lo:hi]),
                                channels=reader.channels)
                        feats = {}
                        for step in steps[d]:
                            feats.update(step(x, run_layer=run_layer))
                        keys = list(feats)
                        with span(timer, "dispatch.pack"):
                            packed = (torch.stack([feats[k].to(torch_dtype)
                                                   for k in keys]) if keys
                                      else torch.empty((0, hi - lo),
                                                       dtype=torch_dtype))
                            done = None
                            if on_cuda:
                                with span(timer, "upload.pin"):
                                    out = torch.empty(packed.shape,
                                                      dtype=packed.dtype,
                                                      pin_memory=True)
                                pinned_out += out.nbytes
                                out.copy_(packed, non_blocking=True)
                                done = torch.cuda.Event(blocking=True)
                                done.record(torch.cuda.current_stream(d))
                            else:
                                out = packed
                        parts.append((out, done))
                        del feats, packed
                    if not on_cuda:
                        ring.release(buf)
                    del xs, x
                    inflight.append((keys, parts, chunk, nb))
                    self.stats["batches"] += 1
                if len(inflight) > max(pipeline_depth, 0):
                    with stage("drain"):
                        self._emit(inflight.pop(0), state, lgc_save,
                                   output_path, output_format, out_series,
                                   group_name, nb_events_per_dump,
                                   memory_limit, timer)
            with stage("drain"):
                while inflight:
                    self._emit(inflight.pop(0), state, lgc_save,
                               output_path, output_format, out_series,
                               group_name, nb_events_per_dump, memory_limit,
                               timer)
        except BaseException:
            if state["writer"] is not None:      # keep the first error
                try:
                    state["writer"].close()
                except BaseException:
                    pass
                state["writer"] = None
            raise
        finally:
            for ring in rings:
                ring.close()
            source.close()
            fast.close()
            self.stats["pinned_bytes"] = (sum(r.pinned_bytes for r in rings)
                                          + uploader.pinned_bytes
                                          + pinned_out)
        if lgc_save and state["pending"]:
            self._flush_dump(state, output_path, output_format, out_series,
                             group_name)
        if state["writer"] is not None:
            state["writer"].close()
        if dropped and self._verbose:
            print(f"INFO: dropped {dropped} triggers with out-of-bounds "
                  f"windows or unmatched files")

        total = self.stats["events"]
        wall = time.time() - t_start
        if self._verbose and total:
            print(f"INFO: processed {total} events in {wall:.1f} s "
                  f"({total / max(wall, 1e-9):.0f} events/s)")
        if lgc_save:
            tables.write_job_summary(
                output_path, self._output_prefix(), group_name, out_series, {
                    "workload": "feature",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "events": int(total),
                    "wall_sec": round(wall, 3),
                    "events_per_sec": (round(total / wall, 3)
                                       if wall else 0),
                    "dumps": int(state["dump"]),
                    "trigger_driven": trigger_mode,
                    "config_digest": tables.config_digest(
                        self._feature_config),
                    "restricted": self._restricted,
                    "calib": self._calib,
                })
        if not lgc_output:
            return None
        if not state["frames"]:
            return {}
        return tables.concat_tables(state["frames"])

    # -- drain -------------------------------------------------------------
    def _emit(self, entry, state, lgc_save, output_path, output_format,
              out_series, group_name, dump_size, memory_limit, timer=None):
        """Drain one batch: wait for its columns' copies (span
        ``drain.wait``), then make its frame and keep or write it (span
        ``drain.host``)."""
        keys, parts, chunk, nb = entry
        with span(timer, "drain.wait"):
            for _, done in parts:
                if done is not None:
                    done.synchronize()
        with span(timer, "drain.host"):
            arr = np.concatenate([out.numpy() for out, _ in parts],
                                 axis=1).astype(np.float64)
            frame = self._admin_columns(chunk[0], chunk[2])
            frame.update({k: arr[i][:nb] for i, k in enumerate(keys)})
            self.stats["events"] += nb
            if state["keep"]:
                state["frames"].append(frame)
            if lgc_save:
                state["pending"].append(frame)
                mem = _parse_memory_limit(memory_limit)
                if ((dump_size is None and mem is None)
                        or (dump_size is not None
                            and sum(tables.table_rows(t)
                                    for t in state["pending"]) >= dump_size)
                        or (mem is not None
                            and sum(tables.table_nbytes(t)
                                    for t in state["pending"]) >= mem)):
                    self._flush_dump(state, output_path, output_format,
                                     out_series, group_name)

    def _admin_columns(self, rows, trows) -> dict:
        """Admin, provenance, trigger carry-over and detector columns of
        one batch (``_emit_frame`` :1744-1785), as numpy gathers."""
        idx = self._index
        files = idx.files
        fi = idx.file[rows]
        nb = len(rows)

        def per_file(fn, dtype=None):
            return np.asarray([fn(f) for f in files], dtype)[fi]

        frame = {
            "event_number": idx.event_number[rows],
            "event_id": idx.event_id[rows],
            "event_time": idx.event_time[rows],
            "series_number": per_file(lambda f: f.admin["series_number"],
                                      np.int64),
            "dump_number": per_file(lambda f: f.admin["dump_number"],
                                    np.int64),
            "trigger_type": idx.trigger_type[rows],
        }
        tab = self._trigger_table
        if tab is not None and "trigger_type" in tab:
            tt = tab["trigger_type"][trows]
            frame["trigger_type"] = np.where(_isna(tt), frame["trigger_type"],
                                             tt)
        stamps = {k: per_file(lambda f, k=k: k in f.admin)
                  for k in ("fridge_run_number",) + STAMP_COLUMNS}
        if stamps["fridge_run_number"].any():
            frame["fridge_run_number"] = per_file(
                lambda f: f.admin.get("fridge_run_number", -1), np.int64)
        for col in STAMP_COLUMNS:
            if stamps[col].any():
                t0 = per_file(lambda f: float(f.admin.get(col, 0)),
                              np.float64)
                frame[col] = np.where(
                    stamps[col],
                    np.round(frame["event_time"] - t0).astype(np.int64),
                    np.int64(-1))
        if tab is not None:
            for col in TRIGGER_COLUMNS:
                if col in tab:
                    vals = tab[col][trows]
                    miss = _isna(vals)
                    if not miss.all():
                        if vals.dtype == object and miss.any():
                            vals = vals.copy()
                            vals[miss] = np.nan
                        frame[col] = vals
        frame["series_name"] = per_file(lambda f: f.admin["series_name"])
        frame["group_name"] = per_file(lambda f: f.admin["group_name"])
        frame["data_type"] = per_file(lambda f: f.admin["data_type"])
        frame["processing_id"] = np.array([self._processing_id or ""] * nb)
        batch_files = sorted(set(fi.tolist()))
        det_chans = sorted({c for i in batch_files
                            for c in files[i].detector_config})
        for chan in det_chans:
            for key in ("tes_bias", "output_gain"):
                if any(key in files[i].detector_config.get(chan, {})
                       for i in batch_files):
                    frame[f"{key}_{chan}"] = per_file(
                        lambda f: f.detector_config.get(chan, {}).get(
                            key, np.nan), np.float64)
        return frame

    def _output_prefix(self) -> str:
        return tables.build_prefix("feature", self._processing_id,
                                   self._restricted, self._calib)

    def _scan_resume(self, output_path, group_name, output_format):
        """(series name, rows written, last dump number) of the newest
        dump series of this group in ``output_path``, or None."""
        found = tables.newest_dumps(output_path, self._output_prefix(),
                                    group_name, output_format)
        if found is None:
            return None
        series, dumps = found
        rows = sum(tables.table_rows(tables.read_table(f)) for _, f in dumps)
        return series, rows, dumps[-1][0]

    def _flush_dump(self, state, output_path, output_format, out_series,
                    group_name):
        if not state["pending"]:
            return
        table = tables.concat_tables(state["pending"])
        state["pending"] = []
        state["dump"] += 1
        path = tables.output_file_name(
            output_path, self._output_prefix(), group_name, out_series,
            state["dump"],
            tables.table_ext(output_format))
        state["writer"].write(table, path, fmt=output_format)


def _isna(values: np.ndarray) -> np.ndarray:
    """Missing entries (NaN, None) of a column."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype == object:
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in values], bool)
    return np.zeros(values.shape, bool)


def _parse_memory_limit(limit):
    """'2GB' / '500 MB' / bytes → bytes."""
    if limit is None:
        return None
    if isinstance(limit, (int, float)):
        return float(limit)
    txt = str(limit).strip().upper().replace(" ", "")
    for suffix, mult in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3), ("B", 1)):
        if txt.endswith(suffix):
            return float(txt[: -len(suffix)]) * mult
    return float(txt)
