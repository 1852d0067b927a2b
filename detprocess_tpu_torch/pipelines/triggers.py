"""Trigger processing over continuous raw files: the ``TriggerProcessing``
shell around :class:`TriggerStep`, the batched coincidence drain and the
``EventBuilder``.

Port of ``detprocess_tpu/pipelines/triggers.py``: ``TriggerProcessing``
(:350), ``EventBuilder`` (:79) and ``get_trigger_template_info`` (:40).
The core imports torch, numpy and the standard library only; a table is a
dict of numpy columns (``io/tables.py``, ``io.tables.to_dataframe`` makes
the JAX DataFrame of it), with pandas' concatenation semantics: a column
missing from some rows is filled with NaN, which turns an int column into
float64 and leaves NaN holes in an object column.

A ``process()`` call:

1. **Reads.** The events of the :class:`RawIndex` are read in its order,
   only the raw channels that the trigger channels filter. ``nreaders``
   threads (``io/prefetch.OrderedChunkPrefetcher``) read whole batches of
   ``event_batch`` events through ``io/batchread.BatchReader``, the
   feature shell's reader too, into pinned buffers of a
   :class:`~detprocess_tpu_torch.io.upload.BufferRing` of their own,
   yielded in batch order with each event's admin dict: each run of
   events that lie back to back in one file is one read
   (``RawIndex.runs``), every other event one read (one a channel row
   where only some channels are read). Integer codes stay as stored;
   float storage is cast into the run's dtype.
   ``nreaders > 1`` needs ``nevents=-1`` and no ``resume``.
2. **Upload.** The batch's buffer is copied to the card on a side stream
   and converted there (``io/upload.Uploader``), unless a host injector
   has converted it; it is read into again only after its copy has
   completed.
3. **Compute.** Each trigger channel's :class:`TriggerStep` (built once
   per dtype and capacity) on its channel gather: base and residual trigger
   sets, batched over events. On the card a float32 run's FIR segments
   and residual basis go through the rFFT kernel, a float64 run's
   through cuFFT (``ops/fft.rfft``'s counted ``cufft_rfft_f64`` route).
4. **Device to host.** The batch's trigger sets are packed on the card
   into one int64 and one float buffer of the run's dtype and copied to
   pinned memory ``non_blocking`` behind an event: one copy a batch, no
   host read of its own. ``pipeline_depth`` batches stay in flight.
5. **Drain.** :func:`drain_batch` turns a batch of host trigger sets into
   one table: the residual combine, edge exclusion, one stable sort by
   (event, trigger index), the cross-channel coincidence merge and the
   event's metadata columns, equal to the per-event ``EventBuilder`` path.
   Dumps go through ``io.tables.AsyncWriter``; ``resume`` continues the
   newest dump series.

Salting (:meth:`TriggerProcessing.set_salting`, JAX :410): a host
injector (``Salting.make_injector``) adds the salts into each event's
float64 traces, converted on the host in the reader threads, which are
cast into the buffer and upload in the run's dtype (JAX :1047,
:1462-1473); a device injector
(``Salting.make_device_injector``) keeps the int16 upload, and its plan
for the batch's events is added on the device right after the conversion
(JAX :1528-1536). Both map the salts' channels by name onto the channels
read.

Dynamic thresholds (:meth:`TriggerProcessing.set_dynamic_threshold`,
JAX :429): a channel's merge window becomes a function of its groups'
running maximum Δχ², merged on the device by
``ops/trigger.find_triggers_dynamic_batched`` in both passes.

The mesh (``process(mesh=...)``, a ``parallel/mesh.Mesh`` of this
process's devices; JAX :720-731, :1496-1520): each batch is split over
the shards by events (unevenly where it does not divide; an empty shard
is skipped, where JAX repeats the last event to pad), each shard's rows
of the pinned buffer go to their own device on that device's side
stream, and the buffer is read into again only after every shard's copy
has finished. Each shard runs its channels' own :class:`TriggerStep`
(one a channel and device), the device injector's plan for its events,
and packs its sets with one copy to the host; the drain sees the batch in
event order, as without a mesh.

``device=None`` means the GPU (``device.require_cuda``); the CPU runs
only when the caller passes ``"cpu"``.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.config.yamlconfig import resolve_config
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.batchread import READ_COUNTS, BatchReader
from detprocess_tpu_torch.io.filterdata import FilterData, check_fs_consistent
from detprocess_tpu_torch.io.fastio import FastReader
from detprocess_tpu_torch.io.prefetch import OrderedChunkPrefetcher
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.io.upload import BufferRing, Uploader
from detprocess_tpu_torch.ops import filterbank
from detprocess_tpu_torch.ops import trigger as trig_ops
from detprocess_tpu_torch.ops.saltinject import split_injector
from detprocess_tpu_torch.parallel.collectives import bounds, check_mesh
from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep
from detprocess_tpu_torch.utils import channels as chutils
from detprocess_tpu_torch.utils.logging import layer_spans, span
from detprocess_tpu_torch.utils.misc import create_series_name

Table = tables.Table

META_COLUMNS = ("processing_id", "data_type", "group_name", "series_number",
                "event_number", "dump_number", "fridge_run_number",
                "event_time", "series_start_time", "group_start_time",
                "fridge_run_start_time", "trigger_prod_id")
STRING_META = META_COLUMNS[:3]
INT_META = META_COLUMNS[3:7]
STAMP_META = META_COLUMNS[8:11]
TRIGGER_TYPE = 4      # the continuous-data threshold trigger


def get_trigger_template_info(trigger_config: dict,
                              filter_data: FilterData) -> dict:
    """Template length and pretrigger summary for deadtime estimates
    (``triggers.py:40-76``)."""
    info = {}
    pre_list, post_list = [], []
    for trig_chan, tcfg in trigger_config.get("channels", {}).items():
        if not tcfg.get("run", True):
            continue
        chan = tcfg.get("channel_name", trig_chan)
        template_tag = tcfg.get("template_tag", "default")
        _, _, md = filter_data.get_template(chan, tag=template_tag,
                                            return_metadata=True)
        fs = md["sample_rate"]
        pre = int(md["nb_pretrigger_samples"])
        nb = int(md["nb_samples"])
        post = nb - pre
        info[trig_chan] = {
            "nb_pretrigger_samples": pre,
            "nb_posttrigger_samples": post,
            "nb_samples": nb,
            "pretrigger_length_msec": 1e3 * pre / fs,
            "posttrigger_length_msec": 1e3 * post / fs,
            "trace_length_msec": 1e3 * nb / fs,
        }
        pre_list.append(1e3 * pre / fs)
        post_list.append(1e3 * post / fs)
    if pre_list:
        info["min_pretrigger_length_msec"] = min(pre_list)
        info["max_pretrigger_length_msec"] = max(pre_list)
        info["min_posttrigger_length_msec"] = min(post_list)
        info["max_posttrigger_length_msec"] = max(post_list)
        info["min_edge_exclusion"] = min(info["min_pretrigger_length_msec"],
                                         info["min_posttrigger_length_msec"])
        info["max_edge_exclusion"] = max(info["max_pretrigger_length_msec"],
                                         info["max_posttrigger_length_msec"])
    return info


# ---------------------------------------------------------------------------
# tables with pandas semantics
# ---------------------------------------------------------------------------

def _as_table(frame) -> Table:
    """A table of ``frame``: a dict of columns or a DataFrame."""
    if isinstance(frame, dict):
        return {k: np.asarray(v) for k, v in frame.items()}
    return {c: frame[c].to_numpy() for c in frame.columns}


def _missing(v) -> bool:
    """pandas' ``isnull`` of one value."""
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _set_cell(table: Table, col: str, row: int, value):
    """``table[col][row] = value`` with pandas' upcast: an int column that
    takes a float becomes float64, a column that cannot hold the value
    becomes object."""
    arr = table[col]
    kind = arr.dtype.kind
    if kind in "iub" and not isinstance(value, (int, np.integer)):
        arr = arr.astype(np.float64 if isinstance(
            value, (float, np.floating)) and kind != "b" else object)
    elif kind in "US" or (kind == "f" and isinstance(value, str)):
        arr = arr.astype(object)
    table[col] = arr
    arr[row] = value


# ---------------------------------------------------------------------------
# EventBuilder
# ---------------------------------------------------------------------------

class EventBuilder:
    """Collects each channel's triggers of one event and merges cross-
    channel coincidences (``triggers.py:79-321``; the reference's
    core/eventbuilder.py), on tables."""

    def __init__(self):
        self._event_table: Optional[Table] = None
        self._current_trigger_id = 0
        self._current_event_time = -np.inf
        self._current_nb_samples = None
        self._trigger_objects: Dict[str, object] = {}
        self._trigger_names: List[str] = []

    def clear_event(self):
        self._event_table = None
        self._trigger_names = []

    def get_event_df(self) -> Optional[Table]:
        """The current event's table (``io.tables.to_dataframe`` makes a
        DataFrame of it)."""
        return self._event_table

    def add_trigger_object(self, trigger_name: str, trigger_object):
        """Register a trigger engine under a name: an object with a
        ``find_triggers(trace, thresh, **kwargs)`` method, a callable, or
        an :class:`~detprocess_tpu_torch.pipelines.oftrigger.
        OptimumFilterTrigger`."""
        if trigger_name in self._trigger_objects:
            raise ValueError(f'ERROR: Trigger object "{trigger_name}" '
                             "already stored!")
        self._trigger_objects[trigger_name] = trigger_object

    def get_trigger_object(self, trigger_name: str):
        if trigger_name not in self._trigger_objects:
            raise ValueError(f'ERROR: Trigger object "{trigger_name}" '
                             "does not exist!")
        return self._trigger_objects[trigger_name]

    def add_trigger_data(self, trigger_name: str, trigger_data):
        """Add one channel's triggers to the current event, once a
        channel."""
        if trigger_name in self._trigger_names:
            raise ValueError(f"ERROR: Trigger data for channel "
                             f"{trigger_name} already added!")
        self._trigger_names.append(trigger_name)
        self.add_triggers(trigger_data)

    def acquire_triggers(self, trigger_name: str, trace, thresh, **kwargs):
        """Run a registered engine on ``trace`` and file its triggers into
        the current event; returns its trigger table."""
        obj = self.get_trigger_object(trigger_name)
        if (hasattr(obj, "update_trace")
                and hasattr(obj, "get_trigger_data_df")):
            obj.update_trace(trace=trace)
            obj.find_triggers(thresh, **kwargs)
            found = obj.get_trigger_data_df()
        else:
            runner = getattr(obj, "find_triggers", None) or obj
            if not callable(runner):
                raise ValueError(
                    f'ERROR: Trigger object "{trigger_name}" is not '
                    "runnable — expected a callable, a find_triggers "
                    "method, or the OptimumFilterTrigger protocol")
            found = runner(trace, thresh, **kwargs)
        self._current_nb_samples = trace.shape[-1]
        self.add_trigger_data(trigger_name, found)
        return found

    def add_triggers(self, trigger_data):
        """Append a trigger table (or DataFrame) to the event, then a
        stable sort by ``trigger_index``: equal indices keep the order in
        which their channels were added."""
        if trigger_data is None:
            return
        part = _as_table(trigger_data)
        if tables.table_rows(part) == 0:
            return
        table = (part if self._event_table is None
                 else tables.concat_tables([self._event_table, part]))
        order = np.argsort(table["trigger_index"], kind="stable")
        self._event_table = {k: v[order] for k, v in table.items()}

    def set_current_nb_samples(self, nb):
        self._current_nb_samples = nb

    def build_event(self, event_metadata: Optional[dict] = None,
                    fs: Optional[float] = None,
                    coincident_window_msec: Optional[float] = None,
                    coincident_window_samples: Optional[int] = None,
                    nb_trigger_channels: Optional[int] = None,
                    trace_length_continuous_sec: Optional[float] = None
                    ) -> Optional[Table]:
        """Merge coincidences and add the event's metadata columns; the
        event's trigger table, or None without triggers. The event time
        chains: an event starts no earlier than the previous one ended."""
        event_metadata = dict(event_metadata or {})
        if fs is None:
            fs = event_metadata.get("sample_rate")
        if trace_length_continuous_sec is None:
            nb = self._current_nb_samples or event_metadata.get("nb_samples")
            if nb is None or fs is None:
                raise ValueError(
                    '"trace_length_continuous_sec" argument required')
            trace_length_continuous_sec = nb / fs

        event_time_start = np.nan
        if "event_time" in event_metadata:
            t = event_metadata["event_time"]
            event_time_start = max(t, self._current_event_time)
            self._current_event_time = (event_time_start
                                        + trace_length_continuous_sec)

        if self._event_table is None or not tables.table_rows(
                self._event_table):
            return None
        if nb_trigger_channels is None or nb_trigger_channels > 1:
            self._merge_coincident_triggers(
                fs=fs, coincident_window_msec=coincident_window_msec,
                coincident_window_samples=coincident_window_samples)

        table = self._event_table
        n = tables.table_rows(table)
        for key in STRING_META:
            table[key] = np.full(n, str(event_metadata.get(key, "")) or None,
                                 object)
        for key in INT_META:
            table[key] = np.full(n, event_metadata.get(key, -1), np.int64)
        finite = np.isfinite(event_time_start)
        event_times = (np.round(np.asarray(table["trigger_time"])
                                + event_time_start).astype(np.int64)
                       if finite else np.full(n, -1, np.int64))
        table["event_time"] = event_times
        for key in STAMP_META:
            start = event_metadata.get(key)
            table[key] = (event_times - np.int64(start)
                          if start is not None and finite
                          else np.full(n, -1, np.int64))
        table["trigger_prod_id"] = (np.arange(n, dtype=np.int64)
                                    + self._current_trigger_id + 1)
        self._current_trigger_id = int(table["trigger_prod_id"][-1])
        return table

    def _merge_coincident_triggers(self, fs=None,
                                   coincident_window_msec=None,
                                   coincident_window_samples=None):
        merge_window = 0
        if coincident_window_msec is not None:
            if fs is None:
                raise ValueError('sample rate "fs" needs to be provided')
            merge_window = int(coincident_window_msec * fs / 1000)
        elif coincident_window_samples is not None:
            merge_window = coincident_window_samples
        if merge_window == 0:
            return
        table = self._event_table
        idx = np.asarray(table["trigger_index"])
        d = np.asarray(table["trigger_delta_chi2"])
        names = np.asarray(table["trigger_channel"])
        drop = np.zeros(len(idx), bool)
        for inds in _coincident_groups(idx, names, merge_window):
            primary = int(inds[np.argmax(d[inds])])
            for other in inds[inds != primary]:
                other = int(other)
                other_chan = str(names[other])
                # the other channel's suffixed columns into the primary
                # row (substring rule of the reference)
                for col in list(table):
                    value = table[col][other]
                    if other_chan in col and not _missing(value):
                        _set_cell(table, col, primary, value)
                drop[other] = True
        if drop.any():
            self._event_table = {k: v[~drop] for k, v in table.items()}


def _coincident_groups(idx: np.ndarray, names: np.ndarray, window,
                       same_event: Optional[np.ndarray] = None):
    """Row groups to merge (``eventbuilder.py:336-497`` semantics): runs
    of rows whose successive ``idx`` gaps are below ``window`` (and, with
    ``same_event``, whose neighbours belong to one event); a run of one
    channel is pileup and stays; a run with a channel twice is split
    greedily into runs of distinct channels, of which those of two rows or
    more merge."""
    if len(idx) < 2:
        return []
    close = np.diff(idx) < window
    if same_event is not None:
        close &= same_event
    close = np.concatenate(([0], close.astype(np.int8), [0]))
    ranges = np.flatnonzero(np.abs(np.diff(close)) == 1).reshape(-1, 2)
    groups = []
    for lo, hi in ranges:
        inds = np.arange(lo, hi + 1)
        chans = names[lo:hi + 1]
        uniq = set(chans.tolist())
        if len(uniq) == 1:
            continue
        if len(uniq) == len(chans):
            groups.append(inds)
            continue
        cur_ch: set = set()
        cur_i: list = []
        splits = []
        for c, i in zip(chans, inds):
            if c in cur_ch:
                splits.append(cur_i)
                cur_ch, cur_i = set(), []
            cur_ch.add(c)
            cur_i.append(int(i))
        if cur_i:
            splits.append(cur_i)
        groups.extend(np.asarray(s) for s in splits if len(s) > 1)
    return groups


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------

@dataclass
class TriggerChannel:
    """One trigger channel of the config (``_TriggerChannel``,
    triggers.py:324-347): its bank, threshold, window and options."""

    name: str                   # trigger name (the table's channel label)
    channel_name: str           # raw channel, possibly 'a|b'
    chan_indices: List[int]     # rows of the raw channels in the file
    bank: filterbank.OFNxMBank
    threshold_sigma: float
    pileup_window: int
    run_residual: bool = False
    sat_amps: Optional[list] = None
    edge_exclusion_msec: Optional[float] = None
    positive_pulses: bool = True
    dynamic_threshold_function: Optional[Callable] = None
    dynamic_candidate_capacity: int = 4096
    dynamic_premerge_window: Optional[int] = None
    _kernels: dict = field(default_factory=dict, repr=False)

    @property
    def chi2_threshold(self) -> float:
        return trig_ops.chi2_threshold(self.threshold_sigma, self.bank.ntmps)

    def kernels(self, real_dtype=np.float32):
        """(trigger kernel, residual basis or None) in ``real_dtype``,
        built once."""
        key = np.dtype(real_dtype)
        if key not in self._kernels:
            kernel = trig_ops.make_trigger_kernel(self.bank,
                                                  real_dtype=real_dtype)
            self._kernels[key] = (kernel, trig_ops.make_residual_basis(kernel)
                                  if self.run_residual else None)
        return self._kernels[key]

    def step(self, capacity: int, device, dtype=torch.float32) -> TriggerStep:
        kernel, basis = self.kernels(np.float64 if dtype == torch.float64
                                     else np.float32)
        return TriggerStep(kernel, basis, self.threshold_sigma,
                           self.pileup_window, capacity, self.run_residual,
                           self.sat_amps, self.positive_pulses,
                           device=device, dtype=dtype,
                           window_fn=self.dynamic_threshold_function,
                           candidate_capacity=self.dynamic_candidate_capacity,
                           premerge_window=self.dynamic_premerge_window)


def build_channels(trigger_config: dict, filter_data: FilterData,
                   available_channels: List[str], fs: float
                   ) -> List[TriggerChannel]:
    """The trigger channels of a normalized trigger config
    (``_build_channels``, triggers.py:455-530)."""
    out = []
    for trig_name, tcfg in trigger_config["channels"].items():
        chan = tcfg["channel_name"]
        template_tag = tcfg.get("template_tag", "default")
        csd_tag = tcfg.get("csd_tag", "default")
        chans, sep = chutils.split_channel_name(chan, available_channels)
        template, _, tmeta = filter_data.get_template(
            chan, tag=template_tag, return_metadata=True)
        if sep == "|":
            csd, _, nmeta = filter_data.get_csd(chan, tag=csd_tag,
                                                return_metadata=True)
        else:
            psd, _, nmeta = filter_data.get_psd(chan, tag=csd_tag,
                                                return_metadata=True)
            csd = psd.astype(complex)
        check_fs_consistent(fs, tmeta, "template", chan, template_tag)
        check_fs_consistent(fs, nmeta, "csd/psd", chan, csd_tag)
        tlen = int(np.atleast_1d(template).shape[-1])
        clen = int(np.asarray(csd).shape[-1])
        if tlen != clen:
            raise ValueError(
                f"number of samples is not consistent between template "
                f"(={tlen}) and csd/psd (={clen}) for trigger channel {chan} "
                f"(tags '{template_tag}'/'{csd_tag}')")
        pretrig = int(tcfg.get("pretrigger_length_samples")
                      or tmeta.get("nb_pretrigger_samples")
                      or np.atleast_1d(template).shape[-1] // 2)
        bank = filterbank.make_ofnxm_bank(
            np.asarray(template), np.asarray(csd), fs, pretrig,
            ignored_frequency_peaks=tcfg.get("ignored_frequency_peaks"),
            ignore_harmonics=tcfg.get("ignore_harmonics", False))
        pileup_msec = tcfg.get("pileup_window_msec")
        pileup = (int(pileup_msec * fs / 1000) if pileup_msec is not None
                  else int(tcfg.get("pileup_window_samples", 0)))
        missing = [c for c in chans if c not in available_channels]
        if missing:
            raise ValueError(
                f"trigger channel '{trig_name}' reads raw channel(s) "
                f"{missing} not present in the raw data; available "
                f"channels: {available_channels}")
        out.append(TriggerChannel(
            name=trig_name, channel_name=chan,
            chan_indices=[available_channels.index(c) for c in chans],
            bank=bank,
            threshold_sigma=float(tcfg.get("threshold_sigma", 5.0)),
            pileup_window=pileup,
            run_residual=bool(tcfg.get("run_residual", False)),
            sat_amps=tcfg.get("saturation_amplitudes"),
            edge_exclusion_msec=tcfg.get("edge_exclusion_msec"),
            positive_pulses=bool(tcfg.get("positive_pulses", True))))
    return out


# ---------------------------------------------------------------------------
# the batched drain
# ---------------------------------------------------------------------------

@dataclass
class DrainState:
    """What the drain carries from batch to batch: the event-time chain,
    the last ``trigger_prod_id``, the livetime, the column order (the
    first-appearance union over all batches), the residual-pass triggers
    kept after the combine and edge exclusion, and the first-pass
    triggers the saturation veto kept out of the subtraction."""

    event_time: float = -np.inf
    trigger_id: int = 0
    livetime: float = 0.0
    residual_triggers: int = 0
    vetoed_triggers: int = 0
    col_order: list = field(default_factory=list)
    col_seen: set = field(default_factory=set)


def _chan_base_cols(m: int) -> List[str]:
    """One channel's unsuffixed columns, in the per-event table's order."""
    base = ["trigger_index", "trigger_time", "trigger_delta_chi2",
            "trigger_threshold_sigma", "trigger_pileup_window",
            "trigger_type"]
    base += [f"trigger_amplitude_{i}" for i in range(m)]
    if m == 1:
        base.append("trigger_amplitude")
    return base + ["trigger_channel"]


def _chan_cols(tc, m: int) -> List[str]:
    """One channel's columns: base, suffixed duplicates, edge-exclusion
    tail."""
    base = _chan_base_cols(m)
    out = base + [f"{b}_{tc.name}" for b in base]
    if tc.edge_exclusion_msec is not None:
        out += [f"trigger_edge_exclusion_time_{tc.name}",
                f"trigger_livetime_{tc.name}"]
    return out


def trigger_set_arrays(tc, ts: trig_ops.TriggerSet):
    """(indices, Δχ², amplitudes [M, k]) of one event's host trigger set,
    or (None, None, None) when empty; warns when the capacity truncated
    it or, in the dynamic mode, dropped candidate units
    (triggers.py:733-756)."""
    count = int(ts.count)
    total = int(ts.count_total)
    if total > count:
        print(f"WARNING: trigger capacity truncated {tc.name}: {total} "
              f"merged groups found, {count} kept — raise "
              f"process(capacity=...)")
    if (ts.n_above is not None
            and int(ts.n_above) > tc.dynamic_candidate_capacity):
        print(f"WARNING: dynamic-trigger candidate capacity exceeded "
              f"on {tc.name}: {int(ts.n_above)} candidate units "
              f"(above-threshold samples, or pre-merged runs when "
              f"the pre-merge engages) > "
              f"{tc.dynamic_candidate_capacity} — triggers after the "
              f"cap are unreliable; raise "
              f"set_dynamic_threshold(candidate_capacity=...)")
    if count == 0:
        return None, None, None
    return (np.asarray(ts.indices)[:count], np.asarray(ts.dchi2)[:count],
            np.asarray(ts.amplitudes)[:, :count])


def _event_view(ts: Optional[trig_ops.TriggerSet], e: int):
    if ts is None:
        return None
    return trig_ops.TriggerSet(*(None if f is None else f[e] for f in ts))


def drain_batch(channels, sets: dict, admins: List[dict], nb_samples: int,
                fs: float, state: DrainState, merge_window=0,
                processing_id: Optional[str] = None,
                timer=None) -> Optional[Table]:
    """One batch of host trigger sets → one table, equal to the per-event
    ``EventBuilder`` path (triggers.py:1149-1435).

    ``channels``: the trigger channels (``name``, ``threshold_sigma``,
    ``pileup_window``, ``edge_exclusion_msec``); ``sets``: {name: (first-
    pass set, residual set or None)}, numpy fields batched over the E
    events of ``admins``; ``nb_samples``: the events' length. Updates
    ``state``; returns None when no trigger is left. A channel's
    per-event residual combine and edge exclusion run in a span
    ``drain.combine`` of ``timer``."""
    nev = len(admins)
    event_sec = nb_samples / fs
    max_edge = max((tc.edge_exclusion_msec or 0.0 for tc in channels),
                   default=0.0)
    # every event advances the livetime and the event-time chain
    ev_meta = []                       # (admin, livetime, start)
    for admin in admins:
        state.livetime += max(event_sec - 2 * max_edge * 1e-3, 0.0)
        t = admin.get("event_time")
        if t is not None:
            start = max(t, state.event_time)
            state.event_time = start + event_sec
        else:
            start = np.nan
        ev_meta.append((admin, state.livetime, start))

    # each channel's triggers (residual combine, edge exclusion) flattened
    # with their events
    chan_flat = []                     # (ci, tc, ev, idx, d, amps [m, k])
    present = np.zeros((nev, len(channels)), bool)
    for ci, tc in enumerate(channels):
        ts_b, ts2_b = sets[tc.name]
        evs, idxs, ds, ampss = [], [], [], []
        combine = ts2_b is not None or tc.edge_exclusion_msec is not None
        with span(timer, "drain.combine") if combine else nullcontext():
            for e in range(nev):
                ts, ts2 = _event_view(ts_b, e), _event_view(ts2_b, e)
                n1 = None                # the first pass's triggers
                if ts2 is not None:
                    n1 = int(ts.count)
                    if ts2.n_vetoed is not None:
                        state.vetoed_triggers += int(ts2.n_vetoed)
                    ts = trig_ops.combine_trigger_sets(ts, ts2)
                idx, d, amps = trigger_set_arrays(tc, ts)
                if idx is None:
                    continue
                if tc.edge_exclusion_msec is not None:
                    tmin = tc.edge_exclusion_msec * 1e-3
                    tt = idx / fs
                    keep = (tt > tmin) & (tt < event_sec - tmin)
                    idx, d, amps = idx[keep], d[keep], amps[:, keep]
                    if n1 is not None:
                        n1 = int(keep[:n1].sum())
                if n1 is not None:
                    # the combine appends the residual pass's new ones
                    state.residual_triggers += len(idx) - n1
                if len(idx) == 0:
                    continue
                present[e, ci] = True
                evs.append(np.full(len(idx), e, np.int64))
                idxs.append(idx.astype(np.int64))
                ds.append(d.astype(np.float64))
                ampss.append(amps.astype(np.float64))
        if evs:
            chan_flat.append((ci, tc, np.concatenate(evs),
                              np.concatenate(idxs), np.concatenate(ds),
                              np.concatenate(ampss, axis=1)))
    if not chan_flat:
        return None

    m_by_ci = {f[0]: f[5].shape[0] for f in chan_flat}
    max_m = max(m_by_ci.values())
    ev_all = np.concatenate([f[2] for f in chan_flat])
    idx_all = np.concatenate([f[3] for f in chan_flat])
    d_all = np.concatenate([f[4] for f in chan_flat])
    rank_all = np.concatenate([np.full(len(f[2]), f[0], np.int64)
                               for f in chan_flat])
    names_all = np.concatenate([np.full(len(f[2]), f[1].name, object)
                                for f in chan_flat])
    thr = np.concatenate([np.full(len(f[2]), f[1].threshold_sigma)
                          for f in chan_flat])
    pw = np.concatenate([np.full(len(f[2]), f[1].pileup_window, np.int64)
                         for f in chan_flat])
    amp_cols = np.concatenate([
        np.concatenate([f[5], np.full((max_m - f[5].shape[0], f[5].shape[1]),
                                      np.nan)]) for f in chan_flat], axis=1)
    amp1 = None
    if any(m == 1 for m in m_by_ci.values()):
        amp1 = np.concatenate([f[5][0] if f[5].shape[0] == 1
                               else np.full(len(f[2]), np.nan)
                               for f in chan_flat])
    # one stable sort by (event, trigger index): equal indices keep the
    # channel order, as the iterated stable sorts of add_triggers do
    perm = np.argsort(ev_all * np.int64(nb_samples + 1) + idx_all,
                      kind="stable")
    ev_all, idx_all, d_all = ev_all[perm], idx_all[perm], d_all[perm]
    rank_all, names_all = rank_all[perm], names_all[perm]
    thr, pw, amp_cols = thr[perm], pw[perm], amp_cols[:, perm]
    if amp1 is not None:
        amp1 = amp1[perm]
    n = len(idx_all)

    data: dict = {"trigger_index": idx_all, "trigger_time": idx_all / fs,
                  "trigger_delta_chi2": d_all,
                  "trigger_threshold_sigma": thr,
                  "trigger_pileup_window": pw,
                  "trigger_type": np.full(n, TRIGGER_TYPE, np.int64)}
    for i in range(max_m):
        data[f"trigger_amplitude_{i}"] = amp_cols[i]
    if amp1 is not None:
        data["trigger_amplitude"] = amp1
    data["trigger_channel"] = names_all

    lts = np.array([mt[1] for mt in ev_meta])
    for ci, tc, _, _, _, amps in chan_flat:
        p = np.flatnonzero(rank_all == ci)
        for b in _chan_base_cols(amps.shape[0]):
            data[f"{b}_{tc.name}"] = _suffixed(data[b], p, n)
        if tc.edge_exclusion_msec is not None:
            col = np.full(n, np.nan)
            col[p] = tc.edge_exclusion_msec * 1e-3
            data[f"trigger_edge_exclusion_time_{tc.name}"] = col
            lv = np.full(n, np.nan)
            lv[p] = lts[ev_all[p]]
            data[f"trigger_livetime_{tc.name}"] = lv

    # the coincidence merge, within each event
    drop = np.zeros(n, bool)
    if merge_window > 0 and len(channels) > 1:
        cols = list(data)
        match = {tc.name: [c for c in cols if tc.name in c]
                 for _, tc, *_ in chan_flat}
        for inds in _coincident_groups(idx_all, names_all, merge_window,
                                       ev_all[1:] == ev_all[:-1]):
            primary = int(inds[np.argmax(d_all[inds])])
            for other in inds[inds != primary]:
                other = int(other)
                for cname in match[str(names_all[other])]:
                    v = data[cname][other]
                    if not _missing(v):
                        data[cname][primary] = v
                drop[other] = True
    if drop.any():
        data = {c: v[~drop] for c, v in data.items()}
        ev_all = ev_all[~drop]
        n = len(ev_all)

    # the metadata columns, in build_event's order
    counts = np.bincount(ev_all, minlength=nev)
    counts_nz = counts[counts > 0]
    metas = [ev_meta[e] for e in range(nev) if counts[e] > 0]

    def rep(vals, dtype):
        return np.repeat(np.array(vals, dtype=dtype), counts_nz)

    for key in STRING_META:
        data[key] = rep([str(processing_id or "") or None
                         if key == "processing_id"
                         else str(a.get(key, "")) or None
                         for a, _, _ in metas], object)
    for key in INT_META:
        data[key] = rep([a.get(key, -1) for a, _, _ in metas], np.int64)
    starts = np.repeat(np.array([s for _, _, s in metas], np.float64),
                       counts_nz)
    finite = np.isfinite(starts)
    event_times = np.where(finite, np.round(
        data["trigger_time"] + np.where(finite, starts, 0.0)),
        -1).astype(np.int64)
    data["event_time"] = event_times
    for key in STAMP_META:
        st = rep([a.get(key) if a.get(key) is not None else -1
                  for a, _, _ in metas], np.int64)
        have = rep([a.get(key) is not None for a, _, _ in metas], bool)
        data[key] = np.where(have & finite, event_times - st,
                             -1).astype(np.int64)
    data["trigger_prod_id"] = (np.arange(n, dtype=np.int64)
                               + state.trigger_id + 1)
    state.trigger_id += n

    # the column order of the per-event path: each event's channel tables
    # in config order, then the metadata; unseen columns go to the end
    for e in range(nev):
        if not present[e].any():
            continue
        for ci, tc in enumerate(channels):
            if present[e, ci]:
                for c in _chan_cols(tc, m_by_ci[ci]):
                    if c not in state.col_seen:
                        state.col_seen.add(c)
                        state.col_order.append(c)
        for c in META_COLUMNS:
            if c not in state.col_seen:
                state.col_seen.add(c)
                state.col_order.append(c)
    return {c: data[c] for c in state.col_order if c in data}


def _suffixed(base_vals: np.ndarray, p: np.ndarray, n: int) -> np.ndarray:
    """A channel's copy of a base column with pandas' concat promotion:
    where other channels' rows exist, ints become float64 with NaN and
    object columns get NaN holes."""
    if len(p) == n:
        return base_vals.copy()
    out = np.full(n, np.nan, object if base_vals.dtype == object
                  else np.float64)
    out[p] = base_vals[p]
    return out


# ---------------------------------------------------------------------------
# the shell
# ---------------------------------------------------------------------------

INT_FIELDS = ("indices", "count", "count_total", "n_above",
              "n_vetoed")


class TriggerProcessing:
    """Continuous-data triggering over raw files."""

    DEFAULT_CAPACITY = 4096
    DEFAULT_EVENT_BATCH = 8
    # events the reader threads keep read ahead of the batches
    PREFETCH_DEPTH = 16

    def __init__(self, raw, config, filter_data=None,
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

        self._config = resolve_config(config, self._available_channels,
                                      self._fs)
        self._trigger_config = self._config["trigger"]

        if isinstance(filter_data, str):
            filter_data = FilterData(verbose=verbose).load(filter_data)
        if filter_data is None:
            path = (self._trigger_config.get("overall", {}) or {}).get(
                "filter_file")
            if path:
                filter_data = FilterData(verbose=verbose).load(path)
        self._filter_data = filter_data
        self._channels = build_channels(self._trigger_config, filter_data,
                                        self._available_channels, self._fs)
        self._steps: dict = {}
        self._injector = None
        self._output_group_path: Optional[str] = None
        self.stats: dict = {}

    @property
    def channels(self) -> List[TriggerChannel]:
        return self._channels

    def get_output_path(self) -> Optional[str]:
        """Output directory of the last saved process() run."""
        return self._output_group_path

    def set_salting(self, injector):
        """Inject salts into every continuous event read: a host injector
        (``Salting.make_injector``, or any callable ``(traces, admin,
        window_start=, channels=)``; float64 reads converted on the host)
        or a device injector (``Salting.make_device_injector``; keeps the
        int16 upload)."""
        self._injector = injector

    def set_dynamic_threshold(self, channel: str, window_fn,
                              candidate_capacity: int = 4096,
                              premerge_window: Optional[int] = None):
        """Merge the trigger channel named ``channel`` (its trigger name or
        raw channel name) with a dynamic pileup window (JAX :429-453, the
        reference's ``dynamic=True``): ``window_fn`` maps a tensor of the
        groups' running maximum Δχ² to a tensor of windows in samples, in
        torch ops that ``torch.func.vmap`` runs per lane
        (``ops/trigger.WINDOW_FN_CONTRACT``; a function that does not is
        refused here with a ``ValueError``). The candidate units are
        pre-merged runs of above-threshold samples by default, which is
        exact only for a monotonic non-decreasing ``window_fn``; pass
        ``premerge_window=0`` for sample-level units, exact for any
        function. Above ``candidate_capacity`` units an event's later
        triggers are unreliable, and the drain warns."""
        trig_ops.check_window_fn(window_fn)
        for tc in self._channels:
            if tc.name == channel or tc.channel_name == channel:
                tc.dynamic_threshold_function = window_fn
                tc.dynamic_candidate_capacity = candidate_capacity
                tc.dynamic_premerge_window = premerge_window
                return
        raise ValueError(f"no trigger channel named {channel}")

    def trigger_steps(self, capacity: int = DEFAULT_CAPACITY,
                      dtype=torch.float32, device=None) -> List[TriggerStep]:
        """Each channel's :class:`TriggerStep` on ``device`` (default the
        shell's; a mesh's shard device), built once per device, capacity,
        dtype and dynamic settings (the key holds the window function
        itself, so a later ``set_dynamic_threshold`` never reuses a step of
        an earlier one)."""
        device = self._device if device is None else torch.device(device)
        key = (device, capacity, dtype) + tuple(
            (tc.dynamic_threshold_function, tc.dynamic_candidate_capacity,
             tc.dynamic_premerge_window) for tc in self._channels)
        if key not in self._steps:
            self._steps[key] = [tc.step(capacity, device, dtype)
                                for tc in self._channels]
        return self._steps[key]

    # -- reads -------------------------------------------------------------
    def _chunks(self, nevents, event_batch, resume_after):
        """The index rows of each batch in reading order: ``event_batch``
        events read at a time, at most ``nevents`` kept (all for -1), those
        at or before ``resume_after`` (series, event) left out, and a batch
        left empty dropped."""
        idx = self._index
        order = idx.order
        keep = np.ones(len(order), bool)
        if resume_after is not None:
            series = np.asarray([f.admin["series_number"] for f in idx.files],
                                np.int64)[idx.file[order]]
            event = idx.event_number[order]
            keep = (series > resume_after[0]) | (
                (series == resume_after[0]) & (event > resume_after[1]))
        chunks, pos, total = [], 0, 0
        while pos < len(order) and (nevents < 0 or total < nevents):
            want = (event_batch if nevents < 0
                    else min(event_batch, nevents - total))
            rows = order[pos:pos + want][keep[pos:pos + want]]
            pos += want
            if len(rows):
                chunks.append(rows)
                total += len(rows)
        return chunks

    # -- process -----------------------------------------------------------
    def process(self, nevents: int = -1, capacity: int = DEFAULT_CAPACITY,
                event_batch: int = DEFAULT_EVENT_BATCH,
                pipeline_depth: int = 2,
                prefetch_depth: int = PREFETCH_DEPTH,
                dtype=np.float32, lgc_save: bool = False,
                output_path: Optional[str] = None,
                output_format: str = "hdf5",
                series_name: Optional[str] = None,
                group_name: str = "trigger",
                coincident_window_msec: Optional[float] = None,
                coincident_window_samples: Optional[int] = None,
                nb_events_per_dump: Optional[int] = None,
                resume: bool = False, lgc_output: bool = True, mesh=None,
                nreaders: int = 1, timer=None) -> Optional[Table]:
        """Trigger the continuous events; returns the trigger table (a
        dict of numpy columns, {} without triggers), or None with
        ``lgc_output=False``. The reader threads keep ``prefetch_depth``
        events (at least one, or a batch a thread) read ahead of the
        batches.

        ``nreaders`` reader threads read the batches (module docstring);
        ``> 1`` needs ``nevents=-1`` and no ``resume``. ``timer``: a
        ``utils.logging.StageTimer`` that adds up the host seconds of the
        read, dispatch, drain and dump stages and of the spans inside them
        (README's port section names them). With ``lgc_save`` the table
        is written to ``output_path`` every ``nb_events_per_dump``
        continuous events (default: once, at the end) with a job summary
        beside it; ``resume`` skips the events up to the newest dump's
        last (series, event) and continues its series and numbering.
        ``mesh``: a ``parallel/mesh.Mesh`` of this process's devices of
        the shell's type; each batch is split over its shards by events
        (see the module docstring)."""
        devices = ([self._device] if mesh is None
                   else check_mesh(mesh, self._device,
                                   processes=False).devices)
        if nreaders > 1 and (nevents >= 0 or resume):
            raise ValueError("nreaders > 1 requires processing all "
                             "events (nevents=-1) without resume")
        dtype = np.dtype(dtype)
        if dtype not in (np.float32, np.float64):
            raise TypeError(f"dtype must be float32 or float64, got {dtype}")
        torch_dtype = torch.float64 if dtype == np.float64 else torch.float32
        t_start = time.time()
        overall = self._trigger_config.get("overall", {}) or {}
        if coincident_window_msec is None:
            coincident_window_msec = overall.get("coincident_window_msec")
        if coincident_window_samples is None:
            coincident_window_samples = overall.get(
                "coincident_window_samples")
        merge_window = 0
        if coincident_window_msec is not None:
            merge_window = int(coincident_window_msec * self._fs / 1000)
        elif coincident_window_samples is not None:
            # un-truncated, as the EventBuilder compares it
            merge_window = coincident_window_samples

        steps = {d: self.trigger_steps(capacity, torch_dtype, d)
                 for d in devices}
        stage = (timer.stage if timer is not None
                 else (lambda name: nullcontext()))
        out_series = series_name or create_series_name(self._facility)
        if lgc_save:
            if output_path is None:
                raise ValueError("output_path required with lgc_save")
            os.makedirs(output_path, exist_ok=True)
            self._output_group_path = output_path
        dump_num = 0
        resume_after = None
        if lgc_save and resume:
            found = self._scan_resume(output_path, group_name, output_format)
            if found is not None:
                out_series, dump_num, resume_after = found
                if self._verbose:
                    print(f"INFO: resuming series {out_series} after "
                          f"series/event {resume_after} (dump {dump_num})")

        # only the raw channels that some trigger channel filters are read
        needed = sorted({i for tc in self._channels for i in tc.chan_indices})
        read_channels = [self._available_channels[i] for i in needed]
        remap = {orig: pos for pos, orig in enumerate(needed)}
        gathers = {d: [torch.as_tensor([remap[i] for i in tc.chan_indices],
                                       device=d)
                       for tc in self._channels] for d in devices}

        on_cuda = self._device.type == "cuda"
        nb = int(self._index.get_metadata()["nb_samples"])
        # a host injector needs float64 amps on the host, which are cast
        # into the run's dtype; otherwise the conversion runs on the card
        inject, device_inject = split_injector(self._injector)
        fast = FastReader()
        reader = BatchReader(self._index, fast, read_channels, nb, dtype,
                             host_convert=inject is not None,
                             injector=inject, timer=timer)
        chunks = self._chunks(nevents, event_batch, resume_after)
        nworkers = max(1, min(nreaders, len(chunks)))
        # chunks a worker reads ahead: prefetch_depth events at least
        ahead = max(1, -(-max(prefetch_depth, 1) // (nworkers * event_batch)))
        rings = [BufferRing(ahead + 1, (event_batch, len(needed), nb),
                            reader.dtype, pin=on_cuda, timer=timer)
                 for _ in range(nworkers)]

        def fill(ring, chunk):
            """A reader thread's batch, with its events' admin dicts."""
            rows, k = chunk
            return reader.fill(ring, rows, batch=k) + (
                [self._index.admin(row) for row in rows.tolist()],)

        source = OrderedChunkPrefetcher(
            fill, [(rows, k) for k, rows in enumerate(chunks)], rings,
            depth=ahead)
        batches = iter(source)
        uploader = Uploader(self._device, timer)
        run_layer = layer_spans(timer, "step.")
        writer = tables.AsyncWriter() if lgc_save else None
        state = DrainState()
        frames: List[Table] = []
        all_frames: List[Table] = []
        inflight: list = []
        total = events_done = events_dumped = 0
        self.stats = {"events": 0, "batches": 0, "upload_bytes": 0,
                      "upload_samples": 0, "read_calls": 0, "read_bytes": 0,
                      "read_runs": 0, "run_events": 0, "pinned_bytes": 0,
                      "residual_triggers": 0, "vetoed_triggers": 0}
        pinned_sets = 0

        def drain(entry):
            nonlocal events_done
            admins, packed = entry
            with stage("drain"):
                with span(timer, "drain.wait"):
                    for p in packed:
                        _wait(p)
                with span(timer, "drain.host"):
                    sets = _merge_shards([_sets_to_host(p) for p in packed])
                    table = drain_batch(self._channels, sets, admins, nb,
                                        self._fs, state, merge_window,
                                        self._processing_id, timer)
            if table is not None:
                frames.append(table)
            events_done += len(admins)

        try:
            while True:
                with stage("read"):
                    got = next(batches, None)
                if got is None:
                    break
                with stage("dispatch"):
                    with span(timer, "dispatch.fill"):
                        ring, buf, reads, conv, admins = got
                        for key, v in zip(READ_COUNTS, reads):
                            self.stats[key] += v
                        if conv is not None:
                            conv = conv.astype(dtype)
                    total += len(admins)
                    with span(timer, "dispatch.enqueue"):
                        shards = [(d, lo, hi) for d, (lo, hi) in zip(
                            devices, bounds(len(admins), len(devices)))
                            if hi > lo]           # an empty shard is skipped
                        xs, copies = [], []
                        for d, lo, hi in shards:
                            x, copied = uploader.upload(
                                buf[0][lo:hi], None if conv is None
                                else conv[lo:hi], torch_dtype, device=d)
                            xs.append(x)
                            copies.append(copied)
                        if on_cuda:
                            ring.release(buf, copies)
                        packed = []
                        for x, (d, lo, hi) in zip(xs, shards):
                            if device_inject is not None:
                                device_inject.inject(
                                    x, [a["series_number"]
                                        for a in admins[lo:hi]],
                                    [a["event_number"]
                                     for a in admins[lo:hi]],
                                    channels=read_channels)
                            batch_sets = {
                                tc.name: step(x.index_select(1, g),
                                              run_layer=run_layer,
                                              timer=timer)
                                for tc, step, g in zip(
                                    self._channels, steps[d], gathers[d])}
                            packed.append(_pack_sets(batch_sets, torch_dtype,
                                                     timer))
                            pinned_sets += _pinned_bytes(packed[-1])
                            del x, batch_sets
                        if not on_cuda:
                            ring.release(buf)
                        del xs
                        inflight.append((admins, packed))
                self.stats["batches"] += 1
                while len(inflight) > max(pipeline_depth, 0):
                    drain(inflight.pop(0))
                if (lgc_save and nb_events_per_dump
                        and events_done - events_dumped >= nb_events_per_dump
                        and frames):
                    with stage("dump"):
                        dump_num = self._write_dump(
                            frames, output_path, output_format, out_series,
                            group_name, dump_num, writer)
                    all_frames.extend(frames)
                    frames.clear()
                    events_dumped = events_done
                if self._verbose and total % 100 < event_batch:
                    print(f"INFO: processed {total} continuous events")
            while inflight:
                drain(inflight.pop(0))
            if lgc_save and frames:
                with stage("dump"):
                    dump_num = self._write_dump(
                        frames, output_path, output_format, out_series,
                        group_name, dump_num, writer)
        except BaseException:
            if writer is not None:            # keep the first error
                try:
                    writer.close()
                except BaseException:
                    pass
                writer = None
            raise
        finally:
            for ring in rings:
                ring.close()
            source.close()
            fast.close()
        if writer is not None:
            writer.close()
        self.stats.update(events=total, upload_bytes=uploader.bytes,
                          upload_samples=uploader.samples,
                          pinned_bytes=(sum(r.pinned_bytes for r in rings)
                                        + uploader.pinned_bytes
                                        + pinned_sets),
                          residual_triggers=state.residual_triggers,
                          vetoed_triggers=state.vetoed_triggers)

        all_frames.extend(frames)
        result = tables.concat_tables(all_frames) if all_frames else {}
        ntrig = tables.table_rows(result)
        wall = time.time() - t_start
        if self._verbose:
            print(f"INFO: processed {total} continuous events, {ntrig} "
                  f"triggers in {wall:.1f} s")
        if lgc_save:
            tables.write_job_summary(
                output_path, self._trigger_prefix(), group_name, out_series, {
                    "workload": "trigger",
                    "processing_id": self._processing_id,
                    "series_name": out_series,
                    "continuous_events": int(total),
                    "triggers": int(ntrig),
                    "livetime_sec": float(state.livetime),
                    "wall_sec": round(wall, 3),
                    "events_per_sec": round(total / wall, 3) if wall else 0,
                    "dumps": int(dump_num),
                    "channels": [tc.name for tc in self._channels],
                    "thresholds_sigma": {tc.name: tc.threshold_sigma
                                         for tc in self._channels},
                    "config_digest": tables.config_digest(
                        self._trigger_config),
                    "restricted": self._restricted,
                    "calib": self._calib,
                })
        return result if lgc_output else None

    def _trigger_prefix(self) -> str:
        return tables.build_prefix("threshtrig", self._processing_id,
                                   self._restricted, self._calib)

    def _write_dump(self, frames, output_path, output_format, out_series,
                    group_name, dump_num, writer) -> int:
        table = tables.concat_tables(frames)
        if not tables.table_rows(table):
            return dump_num
        dump_num += 1
        path = tables.output_file_name(
            output_path, self._trigger_prefix(), group_name, out_series,
            dump_num, tables.table_ext(output_format))
        writer.write(table, path, fmt=output_format)
        return dump_num

    def _scan_resume(self, output_path, group_name, output_format):
        """(series name, last dump number, (series_number, event_number))
        of the newest dump series in ``output_path``, or None."""
        found = tables.newest_dumps(output_path, self._trigger_prefix(),
                                    group_name, output_format)
        if found is None:
            return None
        series, dumps = found
        last = tables.read_table(dumps[-1][1])
        key = (int(last["series_number"][-1]), int(last["event_number"][-1]))
        return series, dumps[-1][0], key


def _pack_sets(batch_sets: dict, dtype: torch.dtype, timer=None):
    """A batch's trigger sets {name: (set, set or None)} packed on their
    device into one int64 and one ``dtype`` buffer, and on the GPU copied
    to pinned memory ``non_blocking`` behind an event (the pinned buffers'
    making a span ``upload.pin`` of ``timer``): (ints, floats, layout,
    event or None)."""
    ints, floats, layout = [], [], []
    for name, pair in batch_sets.items():
        for si, ts in enumerate(pair):
            if ts is None:
                continue
            for fname, arr in zip(trig_ops.TriggerSet._fields, ts):
                if arr is None:                # n_above of a static merge
                    continue
                is_int = fname in INT_FIELDS
                (ints if is_int else floats).append(
                    arr.reshape(-1).to(torch.int64 if is_int else dtype))
                layout.append((name, si, fname, tuple(arr.shape), is_int))
    ibuf, fbuf = torch.cat(ints), torch.cat(floats)
    if ibuf.device.type != "cuda":
        return ibuf, fbuf, layout, None
    host = []
    for buf in (ibuf, fbuf):
        with span(timer, "upload.pin"):
            h = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        h.copy_(buf, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event(blocking=True)
    done.record(torch.cuda.current_stream(ibuf.device))
    return host[0], host[1], layout, done


def _merge_shards(shard_sets: List[dict]) -> dict:
    """One batch's host trigger sets from its shards' (each {name: (set,
    set or None)} over its events), concatenated along the events in shard
    order."""
    if len(shard_sets) == 1:
        return shard_sets[0]

    def cat(sets):
        if sets[0] is None:
            return None
        return trig_ops.TriggerSet(*(
            None if f is None else np.concatenate([s[i] for s in sets])
            for i, f in enumerate(sets[0])))
    return {name: tuple(cat([ss[name][k] for ss in shard_sets])
                        for k in range(2))
            for name in shard_sets[0]}


def _pinned_bytes(packed) -> int:
    """The pinned bytes of :func:`_pack_sets`' output (none on the CPU)."""
    ibuf, fbuf, _, done = packed
    return 0 if done is None else ibuf.nbytes + fbuf.nbytes


def _wait(packed):
    """Block until :func:`_pack_sets`' copy to the host has completed."""
    if packed[3] is not None:
        packed[3].synchronize()


def _sets_to_host(packed) -> dict:
    """Host trigger sets (numpy fields) from :func:`_pack_sets`' output,
    after its copy has completed."""
    ibuf, fbuf, layout, _ = packed
    _wait(packed)
    bufs = {True: ibuf.numpy(), False: fbuf.numpy()}
    offs = {True: 0, False: 0}
    fields: dict = {}
    for name, si, fname, shape, is_int in layout:
        size = int(np.prod(shape))
        fields.setdefault((name, si), {})[fname] = bufs[is_int][
            offs[is_int]:offs[is_int] + size].reshape(shape)
        offs[is_int] += size
    out: dict = {}
    for (name, si), fd in fields.items():
        out.setdefault(name, [None, None])[si] = trig_ops.TriggerSet(**fd)
    return {name: tuple(pair) for name, pair in out.items()}
