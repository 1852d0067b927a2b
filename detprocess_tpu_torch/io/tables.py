"""Feature tables: dicts of numpy columns, their dump files and the job
summary.

Counterpart of ``detprocess_tpu/io/tables.py``. The core works on a
table as a dict ``{column: [rows] numpy array}``:

- :func:`output_file_name` (:82), :func:`build_prefix` (:197),
  :func:`config_digest` (:142), :func:`write_job_summary` (:93, JSON) and
  :class:`AsyncWriter` (:210) are copies;
- :func:`concat_tables` stacks tables row-wise as ``pd.concat`` does
  (a column missing from a part is filled with NaN).

Adapters, importing h5py or pandas when called:

- :func:`write_vaex_hdf5` (:29) writes vaex's column layout
  ``/table/columns/{column}/data`` with h5py; :func:`write_table` also
  writes parquet (through pandas);
- :func:`read_table` reads either back as a table;
- :func:`write_parquet` and :func:`read_parquet` (:74, :78) on a table,
  and :func:`count_rows` (:183), which counts a file's rows from its
  metadata alone (npz too);

and one form of the port's own, for machines without h5py or pandas:
:func:`write_npz_table` writes a table as one ``numpy.savez`` of its
columns (string and object columns as unicode, with a boolean mask where
values are missing), and :func:`read_npz_table` gives back what
:func:`read_vaex_hdf5` gives for the same table. ``write_table``,
``read_table`` and :func:`newest_dumps` take it as the format "npz";
- :func:`to_dataframe` makes a ``pandas.DataFrame`` of a table.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

Table = Dict[str, np.ndarray]


def output_file_name(output_dir: str, prefix: str, group_name: str,
                     series_name: str, dump_num: int,
                     ext: str = "hdf5") -> str:
    name = f"{prefix}_{group_name}_{series_name}_F{dump_num:04d}.{ext}"
    return os.path.join(output_dir, name)


def build_prefix(base: str, processing_id=None, restricted: bool = False,
                 calib: bool = False) -> str:
    """Output-file prefix [{processing_id}_]base[_restricted|_calib]."""
    prefix = f"{processing_id}_{base}" if processing_id else base
    if restricted:
        prefix += "_restricted"
    elif calib:
        prefix += "_calib"
    return prefix


def config_digest(config_dict) -> str:
    """Stable short hash of a nested config mapping."""
    import hashlib
    import json

    def norm(o):
        if isinstance(o, dict):
            return {str(k): norm(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [norm(v) for v in o]
        if isinstance(o, (str, int, float, bool)) or o is None:
            return o
        return str(o)

    blob = json.dumps(norm(config_dict), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


ACCUMULATED_SUMMARY_KEYS = ("events", "triggers", "continuous_events",
                            "wall_sec", "livetime_sec")


def write_job_summary(output_dir: str, prefix: str, group_name: str,
                      series_name: str, summary: dict) -> str:
    """Write ``{prefix}_{group}_{series}_summary.json`` beside the dumps;
    counts and times add up over runs into the same series, with an
    ``invocations`` counter. Returns the path."""
    import json

    path = os.path.join(
        output_dir, f"{prefix}_{group_name}_{series_name}_summary.json")
    prior = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prior = json.load(f)
        except Exception:
            prior = {}
    for key in ACCUMULATED_SUMMARY_KEYS:
        if key in summary and isinstance(prior.get(key), (int, float)):
            summary[key] = type(summary[key])(summary[key] + prior[key])
    summary["invocations"] = int(prior.get("invocations", 0)) + 1
    wall = summary.get("wall_sec") or 0
    for count_key in ("events", "continuous_events"):
        if count_key in summary and wall:
            summary["events_per_sec"] = round(summary[count_key] / wall, 3)
            break

    def default(o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        return str(o)

    with open(path, "w") as f:
        json.dump(summary, f, indent=2, default=default)
    return path


def table_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def concat_tables(parts: List[Table]) -> Table:
    """Row-wise concatenation as ``pd.concat`` does it: columns in order
    of first appearance, a column missing from a part filled with NaN for
    its rows (ints become float64; booleans and strings become object)."""
    if len(parts) == 1:
        return dict(parts[0])
    keys = list(dict.fromkeys(k for p in parts for k in p))
    out = {}
    for k in keys:
        cols = [np.asarray(p[k]) if k in p else None for p in parts]
        if any(c is None for c in cols) and any(
                c.dtype.kind in "bUS" for c in cols if c is not None):
            cols = [None if c is None else c.astype(object) for c in cols]
        out[k] = np.concatenate([np.full(table_rows(p), np.nan) if c is None
                                 else c for c, p in zip(cols, parts)])
    return out


def table_nbytes(table: Table) -> int:
    return sum(int(np.asarray(v).nbytes) for v in table.values())


def _is_missing(x) -> bool:
    return x is None or (isinstance(x, (float, np.floating)) and np.isnan(x))


def write_vaex_hdf5(table: Table, path: str):
    """Write a table in vaex's HDF5 column layout (imports h5py). String
    columns are UTF-8 bytes; missing values (None, NaN) in an object
    column are written as empty bytes with a boolean ``mask`` beside."""
    import h5py

    with h5py.File(path, "w") as f:
        cols = f.require_group("table").require_group("columns")
        for name, arr in table.items():
            arr = np.asarray(arr)
            g = cols.create_group(str(name))
            if arr.dtype.kind in "OUST":
                missing = np.array([_is_missing(x) for x in arr], bool)
                data = np.asarray(
                    [b"" if m else (x if isinstance(x, bytes)
                                    else str(x).encode())
                     for x, m in zip(arr, missing)], dtype="S")
                g.create_dataset("data", data=data)
                if missing.any():
                    g.create_dataset("mask", data=missing)
            else:
                g.create_dataset("data", data=arr)


def read_vaex_hdf5(path: str) -> Table:
    import h5py

    with h5py.File(path, "r") as f:
        cols = f["table"]["columns"]
        data = {}
        for name in cols:
            arr = cols[name]["data"][...]
            if arr.dtype.kind == "S":
                arr = np.char.decode(arr, "utf-8")
                if "mask" in cols[name]:
                    mask = cols[name]["mask"][...].astype(bool)
                    arr = arr.astype(object)
                    arr[mask] = None
            data[name] = arr
    return data


def to_dataframe(table: Table):
    """The table as a ``pandas.DataFrame`` (imports pandas)."""
    import pandas as pd

    return pd.DataFrame(table)


NPZ_TABLE_FORMAT = "detprocess_tpu_torch.table/1"


def write_npz_table(table: Table, path: str):
    """Write a table as one ``.npz``: column k under ``c{k}``, string
    and object columns as unicode (missing values as "" with a boolean
    ``m{k}`` mask beside), the names in order under ``__columns__``."""
    arrays = {"__format__": np.array(NPZ_TABLE_FORMAT),
              "__columns__": np.array([str(c) for c in table], dtype=str)}
    for k, arr in enumerate(table.values()):
        arr = np.asarray(arr)
        if arr.dtype.kind in "OUST":
            missing = np.array([_is_missing(x) for x in arr], bool)
            arr = np.array(["" if m else (x.decode() if isinstance(x, bytes)
                                          else str(x))
                            for x, m in zip(arr, missing)], dtype=str)
            if missing.any():
                arrays[f"m{k}"] = missing
        arrays[f"c{k}"] = arr
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_npz_table(path: str) -> Table:
    with np.load(path, allow_pickle=False) as z:
        if "__format__" not in z or str(z["__format__"]) != NPZ_TABLE_FORMAT:
            raise ValueError(f"'{path}' is not a table file of this package")
        data = {}
        for k, name in enumerate(z["__columns__"].tolist()):
            arr = z[f"c{k}"]
            if f"m{k}" in z:
                arr = arr.astype(object)
                arr[z[f"m{k}"]] = None
            data[name] = arr
    return data


TABLE_EXTENSIONS = {"hdf5": "hdf5", "parquet": "parquet", "npz": "npz"}


def table_ext(fmt: str) -> str:
    """The file extension of an output format ('hdf5', 'parquet' or
    'npz'); any other is refused."""
    if fmt not in TABLE_EXTENSIONS:
        raise ValueError(f"unknown table format: {fmt}")
    return TABLE_EXTENSIONS[fmt]


def write_table(table: Table, path: str, fmt: Optional[str] = None):
    """Write ``table`` as vaex-layout HDF5 ('hdf5'), parquet or npz (by
    default the form of the path's suffix)."""
    fmt = fmt or ("parquet" if path.endswith(".parquet")
                  else "npz" if path.endswith(".npz") else "hdf5")
    if fmt == "hdf5":
        write_vaex_hdf5(table, path)
    elif fmt == "parquet":
        write_parquet(table, path)
    elif fmt == "npz":
        write_npz_table(table, path)
    else:
        raise ValueError(f"unknown table format: {fmt}")


def newest_dumps(output_dir: str, prefix: str, group_name: str,
                 output_format: str = "hdf5"):
    """(series name, [(dump number, path)] in dump order) of the newest
    dump series of ``{prefix}_{group_name}`` in ``output_dir`` (the
    latest series name), or None: what a resumed run continues."""
    import glob
    import re

    ext = table_ext(output_format)
    rx = re.compile(re.escape(prefix) + "_" + re.escape(group_name)
                    + r"_(.+)_F(\d+)\." + ext + "$")
    by_series: Dict[str, list] = {}
    for f in sorted(glob.glob(os.path.join(
            output_dir, f"{prefix}_{group_name}_*.{ext}"))):
        m = rx.match(os.path.basename(f))
        if m:
            by_series.setdefault(m.group(1), []).append((int(m.group(2)), f))
    if not by_series:
        return None
    series = sorted(by_series)[-1]
    return series, sorted(by_series[series])


def read_table(path: str) -> Table:
    """A table file (vaex-layout HDF5, parquet or npz) as a table."""
    if path.endswith(".npz"):
        return read_npz_table(path)
    if path.endswith(".parquet"):
        return read_parquet(path)
    return read_vaex_hdf5(path)


def write_parquet(table: Table, path: str):
    """Write a table (or a DataFrame) as parquet, through pandas."""
    (table if hasattr(table, "to_parquet")
     else to_dataframe(table)).to_parquet(path)


def read_parquet(path: str) -> Table:
    """A parquet file as a table, through pandas."""
    import pandas as pd

    df = pd.read_parquet(path)
    return {c: df[c].to_numpy() for c in df.columns}


def count_rows(path: str) -> int:
    """The rows of a table file without reading its data: npz from its
    first column's header, parquet from its metadata (pyarrow), HDF5 from
    its first column's shape (h5py)."""
    if path.endswith(".npz"):
        import zipfile

        with zipfile.ZipFile(path) as zf:
            if "c0.npy" not in zf.namelist():
                return 0
            with zf.open("c0.npy") as f:
                fmt = np.lib.format
                read = (fmt.read_array_header_1_0
                        if fmt.read_magic(f) == (1, 0)
                        else fmt.read_array_header_2_0)
                return int(read(f)[0][0])
    if path.endswith(".parquet"):
        import pyarrow.parquet as pq

        return pq.ParquetFile(path).metadata.num_rows
    import h5py

    with h5py.File(path, "r") as f:
        cols = f["/table/columns"]
        for name in cols:
            return int(cols[name]["data"].shape[0])
    return 0


class AsyncWriter:
    """Background-thread table writer, so that dump writes overlap the
    device's work. ``write()`` enqueues (at most ``depth`` dumps held);
    ``close()`` drains the queue and raises the first write error. After
    an error nothing more is written, so the dumps on disk stay a gapless
    prefix."""

    def __init__(self, depth: int = 2):
        import queue
        import threading

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._error: Optional[BaseException] = None
        self._sentinel = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is self._sentinel:
                return
            table, path, fmt = item
            try:
                if self._error is None:
                    write_table(table, path, fmt=fmt)
            except BaseException as exc:  # raised again from close()
                self._error = exc

    def write(self, table: Table, path: str, fmt: Optional[str] = None):
        if self._error is not None:
            raise self._error
        self._queue.put((table, path, fmt))

    def close(self):
        """Drain pending writes; raise the first write error."""
        if self._thread.is_alive():
            self._queue.put(self._sentinel)
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
