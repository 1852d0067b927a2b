"""Offline merging of per-channel feature tables by a global timestamp.

Port of ``detprocess_tpu/pipelines/merge.py`` (the reference example
examples/trigger/merge_feature_files.py:1-206) onto the port's column
tables (dicts of numpy columns): :func:`spicestamp` (:25),
:func:`merge_feature_tables` (:62) and :func:`merge_feature_files`
(:147), with the JAX matching (stamps sorted, a group chained off its
last record within the window) and its duplicate rule (of several rows of
one table in a group, the largest Δχ² wins, or the smallest χ² when the
table has only a plain χ² column). A ``pandas.DataFrame`` is taken as a
table through ``io/filterdata.as_table``, which needs no pandas import;
the result is a table (``io/tables.to_dataframe`` makes the DataFrame).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import as_table

_EVENT_CAP = 10**6          # max events per series
_TRACE_CAP = 10**9          # max samples per continuous trace


def spicestamp(table, fs: float,
               series_rank: Optional[dict] = None) -> np.ndarray:
    """A unique stamp per trigger: ``(rank(series)·1e6 + event_number)·1e9
    + trigger_index`` when the table has series, event and trigger-index
    columns (so a window in samples only compares triggers of one
    continuous event), else ``event_time·fs + trigger_index``."""
    table = as_table(table)
    if ("series_number" in table and "event_number" in table
            and "trigger_index" in table):
        series = table["series_number"]
        if series_rank is None:
            uniq = sorted(set(int(x) for x in series))
            series_rank = {s: i for i, s in enumerate(uniq)}
        rank = np.array([series_rank[int(x)] for x in series],
                        dtype=np.int64)
        event = np.asarray(table["event_number"]).astype(np.int64)
        tidx = np.asarray(table["trigger_index"]).astype(np.int64)
        return ((rank * _EVENT_CAP + event) * _TRACE_CAP
                + tidx).astype(np.float64)
    stamp = np.asarray(table["event_time"], dtype=np.float64) * fs
    if "trigger_index" in table:
        stamp = stamp + np.asarray(table["trigger_index"], dtype=np.float64)
    return stamp


def _isna(value) -> bool:
    return value is None or (isinstance(value, (float, np.floating))
                             and np.isnan(value))


def _column(cells: list) -> np.ndarray:
    """The cells of one output column as an array: their common type when
    none is missing, else float64 with NaN (numbers) or object with None
    (anything else)."""
    missing = [_isna(v) for v in cells]
    if not any(missing):
        return np.asarray(cells)
    present = [v for v, m in zip(cells, missing) if not m]
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in present):
        return np.array([np.nan if m else v
                         for v, m in zip(cells, missing)], dtype=float)
    return np.array([None if m else v for v, m in zip(cells, missing)],
                    dtype=object)


def _chi2_column(table, delta_chi2_column):
    """(column, larger is better) of a table's duplicate rule."""
    if delta_chi2_column and delta_chi2_column in table:
        return delta_chi2_column, True
    for c in table:
        if "delta_chi2" in c:
            return c, True
    for c in table:
        if "chi2" in c:
            return c, False     # plain chi2: smaller is better
    return None, True


def merge_feature_tables(frames: Sequence, fs: float,
                         merge_window_samples: int = 100,
                         delta_chi2_column: Optional[str] = None
                         ) -> tables.Table:
    """Merge feature tables on the global stamp.

    Rows whose stamps chain within ``merge_window_samples`` (each against
    the group's last record, so a burst spaced under the window is one
    group) become one row: the columns united, a later table filling what
    an earlier one has missing, and ``merge_nb_matched`` the number of
    tables in the group. Of several rows of one table in a group the
    largest ``delta_chi2_column`` (default: the first column containing
    'delta_chi2') wins; with only a plain 'chi2' column the smallest."""
    frames = [t for t in (as_table(f) for f in frames)
              if tables.table_rows(t)]
    if not frames:
        return {}

    all_series = sorted({int(x) for t in frames if "series_number" in t
                         for x in t["series_number"]})
    srank = {s: i for i, s in enumerate(all_series)} or None

    records = []
    for fi, t in enumerate(frames):
        for ri, s in enumerate(spicestamp(t, fs, series_rank=srank)):
            records.append((float(s), fi, ri))
    records.sort()

    groups: List[List[tuple]] = []
    for rec in records:
        if groups and rec[0] - groups[-1][-1][0] <= merge_window_samples:
            groups[-1].append(rec)
        else:
            groups.append([rec])

    rows = []
    for group in groups:
        merged = {}
        by_frame: dict = {}
        for _, fi, ri in group:
            by_frame.setdefault(fi, []).append(ri)
        for fi, ris in by_frame.items():
            t = frames[fi]
            if len(ris) > 1:
                col, larger_is_better = _chi2_column(t, delta_chi2_column)
                if col is not None:
                    vals = np.asarray(t[col])[ris]
                    pick = (np.argmax(vals) if larger_is_better
                            else np.argmin(vals))
                    ris = [ris[int(pick)]]
            for col, arr in t.items():
                val = arr[ris[0]]
                if col not in merged or _isna(merged[col]):
                    merged[col] = val
        merged["merge_nb_matched"] = len(by_frame)
        rows.append(merged)

    columns = list(dict.fromkeys(c for r in rows for c in r))
    return {c: _column([r.get(c) for r in rows]) for c in columns}


def merge_feature_files(paths: Sequence[str], fs: float,
                        merge_window_samples: int = 100,
                        output_path: Optional[str] = None) -> tables.Table:
    """Read the table files (``io/tables.read_table``: HDF5, parquet or
    npz), merge them, and write the result to ``output_path`` in its
    suffix's form when given."""
    frames = [tables.read_table(p) for p in paths]
    out = merge_feature_tables(frames, fs, merge_window_samples)
    if output_path:
        tables.write_table(out, output_path)
    return out
