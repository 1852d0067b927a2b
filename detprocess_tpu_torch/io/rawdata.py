"""Raw events: an index of every event's bytes, and a reader over it.

Counterpart of ``detprocess_tpu/io/rawdata.py::RawReader`` built on the
read half of fastio. Where the JAX reader opens HDF5 files with h5py on
every run, the port resolves each event once into a :class:`RawIndex`:

- per file (:class:`RawFile`): path, sample rate, channel list, the
  per-channel ADC conversion ``cal / close_loop_norm``, the file admin
  (series name and number, dump number, group name, data type, fridge-run
  stamps), detector config and the metadata dict of the JAX reader's
  ``get_metadata``;
- per event: a :class:`~detprocess_tpu_torch.io.fastio.FastDataset`
  (path, offset, shape, stored dtype), or an
  :class:`~detprocess_tpu_torch.io.fastio.H5Dataset` for storage that
  pread cannot serve, and ``event_id``, ``event_number``, ``event_time``,
  ``trigger_type`` as numpy arrays, so that a batch's admin columns are
  gathers, not dicts.

Two ways to build one:

- :meth:`RawIndex.from_pytesdaq` reads pytesdaq HDF5 files with h5py,
  imported when it is called, with the JAX reader's event naming and
  fallback (``RawReader._event_dataset`` :249, ``_read_event``
  :456-560). A dataset that is not contiguous, unfiltered little-endian
  storage (chunked, compressed, compact, big-endian, unallocated) gets an
  ``fastio.H5Dataset`` entry, which every reader serves through h5py
  hyperslabs, as the JAX reader does;
- :meth:`RawIndex.from_flat` indexes flat dump files (:func:`write_flat_dump`:
  events back to back, each a C-order [C, N] block of the stored dtype),
  which need no HDF5 at all.

A flat raw group is the port's file form for machines without h5py:
:func:`write_flat_series` writes a series as pytesdaq-named dumps
``{prefix}_{series}_F{dump:04d}.bin`` beside one JSON manifest
``{prefix}_{series}.json`` that holds what :meth:`RawIndex.from_flat`
takes (channels, samples, sample rate, dtype, ADC conversion, pretrigger,
data type, facility, detector config). :meth:`RawIndex.from_files` opens
any list of raw paths: ``.hdf5`` through :meth:`~RawIndex.from_pytesdaq`,
``.bin`` through its manifest; a list that mixes the two, or a dump
without a manifest, is refused by name.

:class:`RawReader` serves ``read_next_event``, ``read_single_event``
(with ``trace_window``), ``read_many_events`` and ``rewind`` over an
index, in amps or, with ``adctoamp=False, dtype=None``, in the stored
dtype with the conversion factors in ``admin["adc_conv"]``; its admin
dicts carry the JAX reader's keys.

:class:`RawWriter` (JAX :90-220) writes pytesdaq HDF5 dumps with the JAX
writer's groups, datasets and attributes: int16 ADC codes with an
``adc_conversion_factor``, float32 otherwise; h5py is imported when a dump
is written.

:class:`RawData` (JAX ``RawData`` :566) classifies the files of a raw
group directory (pytesdaq ``.hdf5`` and flat ``.bin`` dumps) by their
name's prefix and maps each data type to its series; its queries read a
flat series' manifest, and open HDF5 files through the h5py adapter.
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from detprocess_tpu_torch.io.fastio import (FastDataset, FastReader,
                                            H5Dataset, dataset_storage)
from detprocess_tpu_torch.utils.channels import (SERIES_RE,
                                                 series_name_to_number)

FILE_STAMPS = ("fridge_run", "series_start_time", "group_start_time",
               "fridge_run_start_time")


# file-name prefixes → data type (JAX ``DATA_TYPES``)
DATA_TYPES = {
    "cont": "continuous",
    "rand": "rand",
    "calib": "calib",
    "iv": "iv",
    "didv": "didv",
    "exttrig": "exttrig",
    "threshtrig": "threshtrig",
    "treshtrig": "threshtrig",
}


def extract_series_name(filename: str) -> str:
    m = SERIES_RE.search(os.path.basename(filename))
    if not m:
        raise ValueError(f"no series name in {filename}")
    return f"I{m.group(1)}_D{m.group(2)}_T{m.group(3)}"


def series_to_number(series_name: str) -> int:
    return series_name_to_number(series_name)


def series_number_to_name(series_num: int) -> str:
    """Inverse of :func:`series_to_number`."""
    fac, daytime = divmod(int(series_num), 10**14)
    day, tme = divmod(daytime, 10**6)
    return f"I{fac}_D{day:08d}_T{tme:06d}"


@dataclass
class RawFile:
    """One raw dump file."""

    path: str
    sample_rate: float
    channels: List[str]
    conv: np.ndarray            # [C] float64: amps = stored · conv
    nb_samples: int
    admin: dict                 # the file part of every event's admin
    detector_config: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)


class RawIndex:
    """Every event of a set of raw files, resolved to its bytes.

    ``files`` in path order; ``events`` holds ``file`` (index into
    ``files``), ``event_id``, ``event_number``, ``trigger_type`` (int64)
    and ``event_time`` (float64) arrays and the ``datasets`` list of
    FastDataset or H5Dataset entries. ``order`` is the sequential reading
    order (default: row order); ``lookup`` maps (file index, event number)
    to a row.
    """

    EVENT_KEYS = ("file", "event_id", "event_number", "event_time",
                  "trigger_type")

    def __init__(self, files: Sequence[RawFile], events: dict,
                 order=None, lookup: Optional[dict] = None):
        self.files = list(files)
        self.datasets = list(events["datasets"])
        self.file = np.asarray(events["file"], np.int64)
        self.event_id = np.asarray(events["event_id"], np.int64)
        self.event_number = np.asarray(events["event_number"], np.int64)
        self.event_time = np.asarray(events["event_time"], np.float64)
        self.trigger_type = np.asarray(events["trigger_type"], np.int64)
        n = len(self.datasets)
        if any(len(getattr(self, k)) != n for k in self.EVENT_KEYS):
            raise ValueError("every event array needs one entry per dataset")
        self.order = (np.arange(n, dtype=np.int64) if order is None
                      else np.asarray(order, np.int64))
        if lookup is None:
            lookup = {}
            for row in range(n):
                lookup.setdefault((int(self.file[row]),
                                   int(self.event_number[row])), row)
        self.lookup = lookup
        self._file_pos = {f.path: i for i, f in enumerate(self.files)}

    def __len__(self) -> int:
        return len(self.order)

    @property
    def paths(self) -> List[str]:
        return [f.path for f in self.files]

    @property
    def sample_rate(self) -> float:
        return float(self.files[0].sample_rate)

    @property
    def channels(self) -> List[str]:
        return list(self.files[0].channels)

    def file_index(self, path: Optional[str]) -> int:
        return 0 if path is None else self._file_pos[path]

    def get_metadata(self, path: Optional[str] = None) -> dict:
        return self.files[self.file_index(path)].metadata

    def get_detector_config(self, path: Optional[str] = None) -> dict:
        return self.files[self.file_index(path)].detector_config

    def subset(self, rows) -> "RawIndex":
        """An index over the same files holding only ``rows``, read in
        the order given."""
        rows = np.asarray(rows, np.int64)
        events = {k: getattr(self, k)[rows] for k in self.EVENT_KEYS}
        events["datasets"] = [self.datasets[r] for r in rows]
        return RawIndex(self.files, events)

    def select_files(self, paths: Sequence[str]) -> "RawIndex":
        """An index over the events of ``paths`` only, in reading order."""
        keep = {self._file_pos[p] for p in paths}
        rows = [r for r in self.order if int(self.file[r]) in keep]
        sub = self.subset(rows)
        files = [f for i, f in enumerate(self.files) if i in keep]
        remap = {old: new for new, old in enumerate(sorted(keep))}
        events = {k: getattr(sub, k) for k in self.EVENT_KEYS}
        events["file"] = np.array([remap[int(i)] for i in sub.file],
                                  np.int64)
        events["datasets"] = sub.datasets
        return RawIndex(files, events)

    # -- builders ----------------------------------------------------------
    @classmethod
    def concat(cls, indexes: Sequence["RawIndex"]) -> "RawIndex":
        """One index over the files of ``indexes``, its events in their
        reading orders one index after the other."""
        files, events = [], {k: [] for k in cls.EVENT_KEYS + ("datasets",)}
        for idx in indexes:
            base = len(files)
            files.extend(idx.files)
            for r in idx.order:
                events["datasets"].append(idx.datasets[r])
                events["file"].append(base + int(idx.file[r]))
                for k in cls.EVENT_KEYS[1:]:
                    events[k].append(getattr(idx, k)[r])
        return cls(files, events)

    @classmethod
    def from_flat(cls, paths: Sequence[str], channels: Sequence[str],
                  nb_samples: int, sample_rate: float,
                  series_name: str, dtype=np.int16,
                  adc_conversion_factor: float = 1.0,
                  detector_config: Optional[Dict[str, dict]] = None,
                  nb_pretrigger_samples: Optional[int] = None,
                  group_name: str = "", data_type: str = "continuous",
                  facility: int = 1,
                  dump_numbers: Optional[Sequence[int]] = None
                  ) -> "RawIndex":
        """Index flat dump files (:func:`write_flat_dump`): file i of the
        sorted ``paths`` is dump ``dump_numbers[i]`` (default i + 1) of
        ``series_name``, its events are numbered 1, 2, … and the event
        time runs on from file to file at ``nb_samples / sample_rate`` an
        event."""
        dtype = np.dtype(dtype)
        detector_config = detector_config or {}
        cln = np.array([float((detector_config.get(c) or {}).get(
            "close_loop_norm", 1.0)) or 1.0 for c in channels])
        conv = float(adc_conversion_factor) / cln
        block = len(channels) * nb_samples * dtype.itemsize
        files, events = [], {k: [] for k in cls.EVENT_KEYS + ("datasets",)}
        t_event = nb_samples / sample_rate
        n_before = 0
        for i, path in enumerate(sorted(paths)):
            nev, rest = divmod(os.path.getsize(path), block)
            if rest:
                raise ValueError(f"flat dump '{path}' is not a whole number "
                                 f"of [{len(channels)}, {nb_samples}] "
                                 f"{dtype} events")
            adc = {"nb_events": nev, "nb_samples": nb_samples,
                   "nb_channels": len(channels), "sample_rate": sample_rate,
                   "channel_list": list(channels),
                   "adc_conversion_factor": float(adc_conversion_factor)}
            if nb_pretrigger_samples is not None:
                adc["nb_pretrigger_samples"] = int(nb_pretrigger_samples)
            md = {"series_name": series_name,
                  "series_num": series_to_number(series_name),
                  "dump_num": (i + 1 if dump_numbers is None
                               else int(dump_numbers[i])),
                  "facility": facility,
                  "data_type": data_type, "group_name": group_name, **adc,
                  "detector_config": detector_config}
            files.append(RawFile(
                path, float(sample_rate), list(channels), conv.copy(),
                int(nb_samples), _file_admin(md, path), detector_config, md))
            for k in range(nev):
                events["datasets"].append(FastDataset(
                    path, k * block, (len(channels), nb_samples), dtype))
                events["file"].append(i)
                events["event_id"].append(k + 1)
                events["event_number"].append(k + 1)
                events["event_time"].append((n_before + k) * t_event)
                events["trigger_type"].append(1)
            n_before += nev
        return cls(files, events)

    @classmethod
    def from_pytesdaq(cls, paths: Sequence[str] | str,
                      adc_name: str = "adc1") -> "RawIndex":
        """Index pytesdaq HDF5 raw files (imports h5py). Events are read
        in file order by their ``event_{k}`` ordinal, as the JAX reader's
        sequential path reads them; random access by event number follows
        its ``_event_dataset`` rule: ``event_{num}`` when its
        ``event_num`` attribute agrees, else the dataset whose attribute
        is ``num``."""
        import h5py

        if isinstance(paths, str):
            paths = [paths]
        files, events = [], {k: [] for k in cls.EVENT_KEYS + ("datasets",)}
        order, lookup = [], {}

        def add(fi, ds, default_num):
            a = ds.attrs
            events["datasets"].append(_fast_dataset(ds, path))
            events["file"].append(fi)
            events["event_id"].append(int(a.get("event_id", default_num)))
            events["event_number"].append(int(a.get("event_num",
                                                    default_num)))
            events["event_time"].append(float(a.get("event_time", 0.0)))
            events["trigger_type"].append(int(a.get("trigger_type", 1)))
            return len(events["file"]) - 1

        for fi, path in enumerate(sorted(paths)):
            try:
                f = h5py.File(path, "r")
            except OSError as e:
                raise OSError(f"cannot open raw file '{path}': {e} — "
                              "corrupt or truncated dump?") from None
            with f:
                g = f[adc_name]
                md = dict(f.attrs)
                md.update({k: g.attrs[k] for k in g.attrs})
                chans = [str(c) for c in g.attrs["channel_list"]]
                md["channel_list"] = chans
                det = ({c: dict(f["detconfig1"][c].attrs)
                        for c in f["detconfig1"]}
                       if "detconfig1" in f else {})
                md["detector_config"] = det
                cal = float(g.attrs.get("adc_conversion_factor", 1.0))
                cln = np.array([float(det.get(c, {}).get(
                    "close_loop_norm", 1.0)) or 1.0 for c in chans])
                files.append(RawFile(
                    path, float(md["sample_rate"]), chans, cal / cln,
                    int(md["nb_samples"]), _file_admin(md, path), det, md))
                rows = {}
                for k in range(1, int(g.attrs["nb_events"]) + 1):
                    name = f"event_{k}"
                    rows[name] = add(fi, g[name], k)
                    order.append(rows[name])
                nums = {}
                for key in g:
                    try:
                        nums[int(g[key].attrs.get("event_num", -1))] = key
                    except (ValueError, TypeError):
                        continue
                for name in list(rows):
                    if "event_num" not in g[name].attrs:
                        nums.setdefault(int(name[len("event_"):]), name)
                for num, key in nums.items():
                    name = f"event_{num}"
                    if name in g and int(g[name].attrs.get(
                            "event_num", num)) == num:
                        key = name
                    if key not in rows:
                        rows[key] = add(fi, g[key], num)
                    lookup[(fi, num)] = rows[key]
        return cls(files, events, order=order, lookup=lookup)

    @classmethod
    def from_files(cls, paths: Sequence[str] | str,
                   adc_name: str = "adc1") -> "RawIndex":
        """Index raw files by their form: pytesdaq ``.hdf5`` files through
        :meth:`from_pytesdaq` (h5py), flat ``.bin`` dumps through the
        manifest of their series (:func:`write_flat_series`), one series
        after another in name order. A list that mixes the forms, a file
        of neither, and a dump without its manifest are refused by
        name."""
        if isinstance(paths, str):
            paths = [paths]
        paths = sorted(paths)
        if not paths:
            raise ValueError("no raw files given")
        kinds = {os.path.splitext(p)[1].lower() for p in paths}
        if not kinds <= {".hdf5", ".bin"}:
            bad = [p for p in paths
                   if os.path.splitext(p)[1].lower() not in (".hdf5", ".bin")]
            raise ValueError(f"raw file '{bad[0]}' is neither a pytesdaq "
                             "'.hdf5' file nor a flat '.bin' dump")
        if kinds == {".hdf5", ".bin"}:
            raise ValueError(
                "raw files mix pytesdaq HDF5 ('"
                + next(p for p in paths if p.lower().endswith(".hdf5"))
                + "') and flat dumps ('"
                + next(p for p in paths if p.lower().endswith(".bin"))
                + "'): give one form at a time")
        if kinds == {".hdf5"}:
            return cls.from_pytesdaq(paths, adc_name)
        groups: Dict[str, List[str]] = {}
        for p in paths:
            groups.setdefault(flat_dump_parts(p)[0] + ".json", []).append(p)
        indexes = []
        for manifest, dumps in sorted(groups.items()):
            if not os.path.exists(manifest):
                raise ValueError(
                    f"flat dump '{dumps[0]}' has no manifest: expected "
                    f"'{manifest}' (write_flat_series writes it)")
            with open(manifest) as f:
                md = json.load(f)
            indexes.append(cls.from_flat(
                dumps, md["channels"], int(md["nb_samples"]),
                float(md["sample_rate"]), md["series_name"],
                dtype=np.dtype(md["dtype"]),
                adc_conversion_factor=float(md["adc_conversion_factor"]),
                detector_config=md.get("detector_config") or {},
                nb_pretrigger_samples=md.get("nb_pretrigger_samples"),
                group_name=md.get("group_name", ""),
                data_type=md.get("data_type", "continuous"),
                facility=int(md.get("facility", 1)),
                dump_numbers=[flat_dump_parts(p)[1] for p in dumps]))
        return indexes[0] if len(indexes) == 1 else cls.concat(indexes)


FLAT_DUMP_RE = re.compile(r"^(.*)_F(\d+)\.bin$")


def flat_dump_parts(dump_path: str):
    """(``{directory}/{prefix}_{series}``, dump number) of a flat dump
    ``{prefix}_{series}_F{dump}.bin``; its manifest is the first part
    with ``.json``."""
    m = FLAT_DUMP_RE.match(dump_path)
    if not m:
        raise ValueError(f"flat dump '{dump_path}' is not named "
                         "'{prefix}_{series}_F{dump:04d}.bin'")
    return m.group(1), int(m.group(2))


def _file_admin(md: dict, path: str) -> dict:
    """The file part of an event's admin dict (JAX ``_read_event``)."""
    admin = {"series_name": str(md.get("series_name", "")),
             "series_number": int(md.get("series_num", 0)),
             "dump_number": int(md.get("dump_num", 0)),
             "group_name": str(md.get("group_name", "")),
             "data_type": str(md.get("data_type", "")),
             "file_name": path}
    for key in FILE_STAMPS:
        if key in md:
            admin["fridge_run_number" if key == "fridge_run"
                  else key] = int(md[key])
    return admin


def _fast_dataset(ds, path: str):
    """The FastDataset of an h5py dataset stored as one contiguous,
    allocated, unfiltered, little-endian block
    (``fastio.dataset_storage``), else its H5Dataset, which the readers
    serve through h5py (chunked, compressed, compact, big-endian or
    unallocated storage)."""
    storage = dataset_storage(ds)
    if storage is None:
        return H5Dataset(path, ds.name, tuple(int(s) for s in ds.shape),
                         ds.dtype.newbyteorder("="))
    return FastDataset(path, *storage)


def write_flat_dump(path: str, stored: np.ndarray, append: bool = False):
    """Write events [E, C, N] of a stored dtype back to back as a flat
    dump (append to ``path`` with ``append``)."""
    with open(path, "ab" if append else "wb") as f:
        np.ascontiguousarray(stored).tofile(f)


def write_flat_series(directory: str, prefix: str, series_name: str,
                      dumps, channels: Sequence[str], sample_rate: float,
                      adc_conversion_factor: float = 1.0,
                      detector_config: Optional[Dict[str, dict]] = None,
                      nb_pretrigger_samples: Optional[int] = None,
                      data_type: Optional[str] = None,
                      facility: Optional[int] = None,
                      group_name: Optional[str] = None):
    """Write a series of a flat raw group: dump k of ``dumps`` (an array
    [E, C, N] of stored values, or an iterable of such chunks appended in
    turn) as ``{prefix}_{series_name}_F{k:04d}.bin`` (k from 1), and the
    manifest ``{prefix}_{series_name}.json``. ``data_type`` defaults to
    the prefix's (:data:`DATA_TYPES`), ``facility`` to the series name's,
    ``group_name`` to the directory's name. Returns (manifest path, dump
    paths)."""
    os.makedirs(directory, exist_ok=True)
    channels = [str(c) for c in channels]
    paths, shape, dtype = [], None, None
    for k, dump in enumerate(dumps, start=1):
        path = os.path.join(directory, f"{prefix}_{series_name}_F{k:04d}.bin")
        chunks = [dump] if isinstance(dump, np.ndarray) else dump
        first = True
        for chunk in chunks:
            chunk = np.asarray(chunk)
            if chunk.ndim != 3 or chunk.shape[1] != len(channels):
                raise ValueError(
                    f"a dump chunk must be [events, {len(channels)}, "
                    f"samples], got {list(chunk.shape)}")
            if shape is None:
                shape, dtype = chunk.shape[2], chunk.dtype
            elif chunk.shape[2] != shape or chunk.dtype != dtype:
                raise ValueError("every chunk of a series needs the same "
                                 "trace length and dtype")
            write_flat_dump(path, chunk, append=not first)
            first = False
        if first:
            raise ValueError(f"dump {k} of {series_name} holds no events")
        paths.append(path)
    if not paths:
        raise ValueError(f"no dumps given for series {series_name}")
    if data_type is None:
        data_type = next((dt for key, dt in DATA_TYPES.items()
                          if prefix.startswith(key)), "unknown")
    if facility is None:
        facility = int(SERIES_RE.search(series_name).group(1))
    manifest = {
        "series_name": series_name, "channels": channels,
        "nb_samples": int(shape), "sample_rate": float(sample_rate),
        "dtype": np.dtype(dtype).name,
        "adc_conversion_factor": float(adc_conversion_factor),
        "nb_pretrigger_samples": (None if nb_pretrigger_samples is None
                                  else int(nb_pretrigger_samples)),
        "data_type": data_type, "facility": int(facility),
        "group_name": (os.path.basename(os.path.normpath(directory))
                       if group_name is None else group_name),
        "detector_config": {str(c): {str(k): _json_value(v)
                                     for k, v in cfg.items()}
                            for c, cfg in (detector_config or {}).items()},
    }
    mpath = os.path.join(directory, f"{prefix}_{series_name}.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
    return mpath, paths


def _json_value(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class RawWriter:
    """Write pytesdaq-format raw files: one HDF5 dump of events per
    :meth:`write_dump` call (JAX ``RawWriter``)."""

    def __init__(self, path: str, series_name: str, sample_rate: float,
                 channels: Sequence[str], prefix: str = "cont",
                 facility: int = 1, group_name: str = "group",
                 data_type: str = "continuous", adc_name: str = "adc1",
                 nb_pretrigger_samples: Optional[int] = None,
                 detector_config: Optional[Dict[str, dict]] = None,
                 fridge_run: Optional[int] = None,
                 series_start_time: Optional[int] = None,
                 group_start_time: Optional[int] = None,
                 fridge_run_start_time: Optional[int] = None,
                 adc_conversion_factor: Optional[float] = None):
        self.path = path
        self.series_name = series_name
        self.sample_rate = float(sample_rate)
        self.channels = list(channels)
        self.prefix = prefix
        self.facility = facility
        self.group_name = group_name
        self.data_type = data_type
        self.adc_name = adc_name
        self.nb_pretrigger_samples = nb_pretrigger_samples
        self.detector_config = detector_config or {}
        self.fridge_run = fridge_run
        self.series_start_time = series_start_time
        self.group_start_time = group_start_time
        self.fridge_run_start_time = fridge_run_start_time
        # with a factor (volts/bit), traces are stored as int16 codes
        # rint(amps · close_loop_norm / cal), which readers turn back
        # into amps · cal / close_loop_norm
        self.adc_conversion_factor = adc_conversion_factor
        os.makedirs(path, exist_ok=True)

    def _close_loop_norms(self) -> np.ndarray:
        return np.array([
            float((self.detector_config.get(c) or {}).get(
                "close_loop_norm", 1.0)) or 1.0
            for c in self.channels])

    def file_name(self, dump_num: int) -> str:
        return os.path.join(
            self.path,
            f"{self.prefix}_{self.series_name}_F{dump_num:04d}.hdf5")

    def write_dump(self, traces: np.ndarray, dump_num: int = 1,
                   event_times: Optional[np.ndarray] = None,
                   trigger_types: Optional[np.ndarray] = None,
                   start_time: float = 0.0) -> str:
        """Write ``traces`` [nb_events, C, N] (float amps) as dump
        ``dump_num``; returns the file's path."""
        import h5py

        traces = np.asarray(traces)
        nb_events, nchan, nsamp = traces.shape
        if nchan != len(self.channels):
            raise ValueError(
                f"traces have {nchan} channels, writer configured with "
                f"{len(self.channels)}")
        cln = self._close_loop_norms()
        if self.adc_conversion_factor is None:
            # readers always return stored·cal/close_loop_norm, so float
            # storage (cal = 1) holds amps·close_loop_norm
            stored = (traces * cln[None, :, None]).astype(np.float32)
        else:
            conv = float(self.adc_conversion_factor) / cln
            codes = np.rint(traces / conv[None, :, None])
            if np.abs(codes).max(initial=0) > np.iinfo(np.int16).max:
                raise ValueError(
                    "int16 ADC overflow: max |code| "
                    f"{np.abs(codes).max():.0f} > 32767 — raise "
                    "adc_conversion_factor (volts/bit) or "
                    "close_loop_norm")
            stored = codes.astype(np.int16)
        fname = self.file_name(dump_num)
        with h5py.File(fname, "w") as f:
            f.attrs["series_name"] = self.series_name
            f.attrs["series_num"] = series_to_number(self.series_name)
            f.attrs["dump_num"] = dump_num
            f.attrs["facility"] = self.facility
            f.attrs["data_type"] = self.data_type
            f.attrs["data_purpose"] = self.data_type
            f.attrs["group_name"] = self.group_name
            f.attrs["daq_version"] = "detprocess_tpu"
            for key in FILE_STAMPS:
                val = getattr(self, key)
                if val is not None:
                    f.attrs[key] = int(val)
            g = f.create_group(self.adc_name)
            g.attrs["nb_events"] = nb_events
            g.attrs["nb_samples"] = nsamp
            g.attrs["nb_channels"] = nchan
            g.attrs["sample_rate"] = self.sample_rate
            if self.nb_pretrigger_samples is not None:
                g.attrs["nb_pretrigger_samples"] = int(
                    self.nb_pretrigger_samples)
            g.attrs["channel_list"] = self.channels
            g.attrs["adc_conversion_factor"] = (
                1.0 if self.adc_conversion_factor is None
                else float(self.adc_conversion_factor))
            g.attrs["dataset_prefix"] = "event_"
            for i in range(nb_events):
                ds = g.create_dataset(f"event_{i + 1}", data=stored[i])
                ds.attrs["event_id"] = i + 1
                ds.attrs["event_num"] = i + 1
                ds.attrs["event_time"] = (
                    start_time + (event_times[i] if event_times is not None
                                  else i * nsamp / self.sample_rate))
                ds.attrs["trigger_type"] = (
                    int(trigger_types[i]) if trigger_types is not None else 1)
            dc = f.create_group("detconfig1")
            dc.attrs["channel_list"] = self.channels
            for chan, cfg in self.detector_config.items():
                cg = dc.create_group(chan)
                for k, v in cfg.items():
                    cg.attrs[k] = v
        return fname


class RawReader:
    """Event reader over a :class:`RawIndex` (or raw file paths, indexed
    with :meth:`RawIndex.from_files`)."""

    def __init__(self, index: RawIndex | Sequence[str] | str,
                 adc_name: str = "adc1"):
        if not isinstance(index, RawIndex):
            index = RawIndex.from_files(index, adc_name)
        self.index = index
        self.adc_name = adc_name
        self._pos = 0
        self._fast = FastReader()

    @property
    def files(self) -> List[str]:
        return self.index.paths

    @property
    def raw_path(self):
        """The directory of the raw files, or the sorted list of their
        directories where they are several."""
        dirs = sorted({os.path.dirname(os.path.abspath(f))
                       for f in self.files})
        return dirs[0] if len(dirs) == 1 else dirs

    @property
    def sample_rate(self) -> float:
        return self.index.sample_rate

    @property
    def channels(self) -> List[str]:
        return self.index.channels

    def get_metadata(self, file_name: Optional[str] = None) -> dict:
        return self.index.get_metadata(file_name)

    def get_detector_config(self, file_name: Optional[str] = None) -> dict:
        return self.index.get_detector_config(file_name)

    def nb_events(self, file_name: Optional[str] = None) -> int:
        """The events of ``file_name`` (default: the first file)."""
        return int(self.get_metadata(file_name)["nb_events"])

    def total_events(self) -> int:
        return len(self.index)

    def split(self, n: int) -> List["RawReader"]:
        """At most ``n`` readers over disjoint file subsets: series
        round-robin over readers, or files round-robin when there are
        fewer series than readers (JAX ``RawReader.split``)."""
        files = self.files
        n = max(1, min(int(n), len(files)))
        if n == 1:
            return [RawReader(self.index, self.adc_name)]
        groups: Dict[str, List[str]] = {}
        for f in files:
            groups.setdefault(extract_series_name(f), []).append(f)
        subsets: List[List[str]] = [[] for _ in range(n)]
        if len(groups) >= n:
            for i, k in enumerate(sorted(groups)):
                subsets[i % n].extend(groups[k])
        else:
            for i, f in enumerate(files):
                subsets[i % n].append(f)
        return [RawReader(self.index.select_files(s), self.adc_name)
                for s in subsets if s]

    def rewind(self):
        self._pos = 0

    def close(self):
        self._fast.close()

    def read_next_event(self, channels: Optional[Sequence[str]] = None,
                        dtype=np.float64, adctoamp: bool = True):
        """(traces [C, N], admin) of the next event in reading order, or
        (None, None) at the end."""
        if self._pos >= len(self.index):
            return None, None
        row = int(self.index.order[self._pos])
        self._pos += 1
        return self.read_row(row, channels, None, adctoamp, dtype)

    def read_single_event(self, event_index: int,
                          file_name: Optional[str] = None,
                          channels: Optional[Sequence[str]] = None,
                          trace_window: Optional[tuple] = None,
                          adctoamp: bool = True, dtype=np.float64):
        """Random access by event number in ``file_name`` (default: the
        first file); ``trace_window=(start, length)`` reads a window."""
        fi = self.index.file_index(file_name)
        row = self.index.lookup.get((fi, int(event_index)))
        if row is None:
            raise KeyError(f"no event with event_num={event_index} in "
                           f"{self.index.files[fi].path}")
        return self.read_row(row, channels, trace_window, adctoamp, dtype)

    def read_many_events(self, nevents: Optional[int] = None,
                         channels: Optional[Sequence[str]] = None):
        """Up to ``nevents`` events from the start, in reading order:
        (traces [B, C, N] in amps, float64; admin dicts). Rewinds before
        and after."""
        out, admins = [], []
        self.rewind()
        while nevents is None or len(out) < nevents:
            traces, admin = self.read_next_event(channels)
            if traces is None:
                break
            out.append(traces)
            admins.append(admin)
        self.rewind()
        if not out:
            return np.zeros((0, 0, 0)), []
        return np.stack(out), admins

    def read_row(self, row: int, channels=None, trace_window=None,
                 adctoamp: bool = True, dtype=np.float64):
        """(traces, admin) of index row ``row``."""
        if dtype is None and adctoamp:
            raise ValueError(
                "dtype=None (stored-dtype raw mode) requires "
                "adctoamp=False — converting to amps needs a float "
                "dtype; pass e.g. dtype=np.float32")
        idx = self.index
        f = idx.files[int(idx.file[row])]
        chans = (None if channels is None
                 else [f.channels.index(c) for c in channels])
        arr = self._fast.read(idx.datasets[row], trace_window, rows=chans)
        conv = f.conv if chans is None else f.conv[chans]
        traces = arr if dtype is None else arr.astype(dtype)
        if adctoamp:
            traces = traces * conv[:, None].astype(dtype)
        admin = dict(f.admin)
        admin.update(event_id=int(idx.event_id[row]),
                     event_number=int(idx.event_number[row]),
                     event_time=float(idx.event_time[row]),
                     trigger_type=int(idx.trigger_type[row]))
        if not adctoamp:
            admin["adc_conv"] = conv.astype(np.float32)
        return traces, admin


class RawData:
    """The raw files of a group directory (``{group}/*.hdf5`` and flat
    ``{group}/*.bin`` dumps, else the same one directory down), classified
    by their name's prefix (:data:`DATA_TYPES`; ``restricted`` in the
    prefix marks restricted data) and mapped ``{data type: {series:
    [files]}}``."""

    def __init__(self, raw_path: str, data_type: str = "continuous",
                 series: Optional[Sequence[str]] = None,
                 restricted: bool = False):
        self.raw_path = raw_path
        self.data_type = data_type
        self.restricted = restricted
        self._series_filter = set(series) if series else None
        self._file_map: Dict[str, Dict[str, List[str]]] = {}
        files = _raw_files(raw_path)
        if not files:
            files = _raw_files(os.path.join(raw_path, "*"))
        for afile in files:
            dtype = self._classify(afile)
            if dtype is None:
                continue
            try:
                name = extract_series_name(afile)
            except ValueError:
                continue
            if self._series_filter and name not in self._series_filter:
                continue
            self._file_map.setdefault(dtype, {}).setdefault(
                name, []).append(afile)

    def _classify(self, filename: str) -> Optional[str]:
        prefix = os.path.basename(filename).split("_I")[0]
        if ("restricted" in prefix) != self.restricted:
            return None
        for key, dtype in DATA_TYPES.items():
            if prefix.startswith(key):
                return dtype
        return "unknown"

    @property
    def verbose(self) -> bool:
        return getattr(self, "_verbose", True)

    def get_group_name(self) -> str:
        return os.path.basename(os.path.normpath(self.raw_path))

    def get_base_path(self) -> str:
        return os.path.dirname(os.path.normpath(self.raw_path))

    def get_facility(self) -> Optional[int]:
        """The facility number of the first series name ('I{fac}_…')."""
        for dtype_map in self._file_map.values():
            for name in dtype_map:
                m = SERIES_RE.search(name)
                if m:
                    return int(m.group(1))
        return None

    def describe(self):
        print(f"Raw data group: {self.get_group_name()}")
        print(f"Base path: {self.get_base_path()}")
        print("Number of series:")
        for dtype, series_map in sorted(self._file_map.items()):
            if series_map:
                label = ("restricted " if self.restricted else "") + dtype
                print(f" - {label} data: {len(series_map)} series")

    def get_series_list(self, data_type: Optional[str] = None) -> List[str]:
        return sorted(self._file_map.get(data_type or self.data_type, {}))

    def get_data_files(self, data_type: Optional[str] = None,
                       series: Optional[str] = None) -> Dict[str, List[str]]:
        series_map = self._file_map.get(data_type or self.data_type, {})
        if series is not None:
            return {series: series_map.get(series, [])}
        return dict(series_map)

    def get_data_config(self, data_type: Optional[str] = None,
                        series: Optional[str] = None) -> dict:
        """{series: {"channel_list", "detector_config", "overall"}} from
        each series' first file (a flat series' manifest, or the h5py
        adapter)."""
        out = {}
        for name, files in self.get_data_files(data_type, series).items():
            if not files:
                continue
            md = RawIndex.from_files(files[:1]).get_metadata()
            out[name] = {
                "channel_list": list(md.get("channel_list", [])),
                "detector_config": md.get("detector_config", {}),
                "overall": {k: v for k, v in md.items()
                            if k != "detector_config"},
            }
        return out

    def get_available_channels(self, data_type: Optional[str] = None,
                               series: Optional[str] = None) -> List[str]:
        for cfg in self.get_data_config(data_type, series).values():
            return list(cfg["channel_list"])
        return []

    def get_sample_rate(self, data_type: Optional[str] = None,
                        series: Optional[str] = None) -> float:
        for cfg in self.get_data_config(data_type, series).values():
            return float(cfg["overall"]["sample_rate"])
        return float("nan")

    def get_duration(self, series: Optional[str] = None,
                     data_type: Optional[str] = None,
                     include_nb_events: bool = False):
        """Total duration in seconds of the events of the series' files
        (with their count)."""
        files = [f for flist in self.get_data_files(data_type,
                                                    series).values()
                 for f in flist]
        nb_events, duration = 0, 0.0
        if files:
            index = RawIndex.from_files(files)
            nb_events = sum(int(f.metadata.get("nb_events", 0))
                            for f in index.files)
            first = index.files[0]
            duration = first.nb_samples / first.sample_rate * nb_events
        if include_nb_events:
            return duration, nb_events
        return duration

    def get_traces(self, series_nums, event_nums, channels=None,
                   adctoamp: bool = True, include_metadata: bool = False):
        """Events ``event_nums`` (by event number, searched through each
        series' files) of series ``series_nums`` (numbers or names) →
        [nevents, C, N]."""
        if not isinstance(series_nums, (list, tuple, np.ndarray)):
            series_nums = [series_nums]
        if not isinstance(event_nums, (list, tuple, np.ndarray)):
            event_nums = [event_nums]
        if len(series_nums) == 1 and len(event_nums) > 1:
            series_nums = list(series_nums) * len(event_nums)
        if len(series_nums) != len(event_nums):
            raise ValueError("series_nums and event_nums must align")
        readers: Dict[str, RawReader] = {}
        traces, admins = [], []
        for ser, ev in zip(series_nums, event_nums):
            name = (ser if isinstance(ser, str)
                    else series_number_to_name(ser))
            reader = readers.get(name)
            if reader is None:
                files = [f for dtype_map in self._file_map.values()
                         for f in dtype_map.get(name, [])]
                if not files:
                    raise KeyError(f"series {name} not in this group")
                reader = readers[name] = RawReader(sorted(files))
            for fname in reader.files:
                try:
                    tr, admin = reader.read_single_event(
                        int(ev), fname, channels=channels,
                        adctoamp=adctoamp)
                    break
                except KeyError:
                    continue
            else:
                raise KeyError(f"event_num {ev} not found in series {name}")
            traces.append(tr)
            admins.append(admin)
        for reader in readers.values():
            reader.close()
        stacked = np.stack(traces) if traces else np.zeros((0, 0, 0))
        return (stacked, admins) if include_metadata else stacked


def _raw_files(directory: str) -> List[str]:
    """The pytesdaq and flat raw files of ``directory`` (a glob pattern
    allowed), sorted."""
    return sorted(glob.glob(os.path.join(directory, "*.hdf5"))
                  + glob.glob(os.path.join(directory, "*.bin")))
