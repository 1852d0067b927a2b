"""Host helpers: series names, list and range utilities, the linear-segment
test of IV-sweep state tagging, the two-pole pulse and the host PSD peak
finder.

Copies of ``detprocess_tpu/utils/misc.py`` (the reference's
detprocess/utils/utils.py and arg_utils.py), host numpy:
``create_series_name``, ``create_directory`` :22, ``unique_list``,
``is_empty`` :39, ``find_linear_segment`` :48, ``build_range_str`` :85,
``twopole`` :101, ``hyphen_range`` :114, ``extract_list`` :127,
``convert_to_seconds`` :140, ``get_dataframe_series_list`` :151 (which
also finds the port's ``.npz`` dumps) and ``find_psd_peaks`` :177
(scipy imported when it is called).
"""

from __future__ import annotations

import glob
import os
import re
from datetime import datetime
from typing import List

import numpy as np


def create_series_name(facility: int, now: datetime | None = None) -> str:
    """'I{facility}_D{yyyymmdd}_T{hhmmss}'."""
    now = now or datetime.now()
    return f"I{facility}_D{now.strftime('%Y%m%d')}_T{now.strftime('%H%M%S')}"


def create_directory(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def unique_list(alist) -> list:
    """Order-preserving de-duplication."""
    if not isinstance(alist, (list, np.ndarray)):
        alist = [alist]
    seen = set()
    out = []
    for item in alist:
        if item not in seen:
            out.append(item)
        seen.add(item)
    return out


def is_empty(param) -> bool:
    """None, or a sized value of length 0."""
    if param is None:
        return True
    try:
        return len(param) == 0
    except TypeError:
        return False


def find_linear_segment(x, y, tolerance: float = 0.05) -> List[int]:
    """Indices of the initial linear segment of (x, y) within
    ``tolerance``: both are standardised on their first 3 points, a line
    is fitted through those (``np.polyfit``), and the walk goes on until
    the deviation exceeds ``tolerance`` on two consecutive points (or on
    the last one). Fewer than 3 points, or a deviation above
    ``tolerance / 10`` among the first 3, give no segment."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    if len(x) < 3:
        return []
    if len(x) != len(y):
        raise ValueError("x and y must have the same length")

    xs = (x - np.mean(x[:3])) / np.std(x[:3])
    ys = (y - np.mean(y[:3])) / np.std(y[:3])
    slope, intercept = np.polyfit(xs[:3], ys[:3], 1)
    deviations = np.abs(ys - (slope * xs + intercept))

    index_list: List[int] = []
    n = len(deviations)
    for idx in range(n):
        dev = deviations[idx]
        if idx < 3 and dev > tolerance / 10:
            return []
        if dev > tolerance:
            if n > idx + 1:
                if deviations[idx + 1] > tolerance:
                    break
            else:
                break
        else:
            index_list.append(idx)
    return index_list


def build_range_str(data_list) -> str:
    """Integers as an underscore-joined run string, [1, 2, 3, 5] →
    '1-3_5' (the inverse of :func:`hyphen_range`)."""
    data_list = sorted(int(v) for v in data_list)
    runs: List[List[int]] = []
    for val in data_list:
        if runs and val == runs[-1][-1] + 1:
            runs[-1].append(val)
        else:
            runs.append([val])
    return "_".join(f"{r[0]}-{r[-1]}" if len(r) > 1 else str(r[0])
                    for r in runs)


def twopole(t, rtau, ftau, amp0, t0):
    """amp0·(e^−(t−t0)/ftau − e^−(t−t0)/rtau), negative values zeroed; a
    fall time not above the rise time becomes 1.001·rtau first."""
    t = np.asarray(t, dtype=float)
    if ftau <= rtau:
        ftau = rtau * 1.001
    pulse = amp0 * (np.exp(-(t - t0) / ftau) - np.exp(-(t - t0) / rtau))
    return np.where(pulse > 0, pulse, 0.0)


def hyphen_range(s: str) -> List[int]:
    """'1-3,5' → [1, 2, 3, 5]."""
    out: List[int] = []
    for part in s.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def extract_list(arg) -> List[str]:
    """A command-line list argument with comma-separated entries split
    and stripped, empty entries dropped."""
    if arg is None:
        return []
    if isinstance(arg, str):
        arg = [arg]
    out: List[str] = []
    for item in arg:
        out.extend(str(item).split(","))
    return [s.strip() for s in out if s.strip()]


def convert_to_seconds(s: str) -> float:
    """'10s', '5m', '2h', '1d' (or a bare number of seconds) in seconds."""
    m = re.fullmatch(r"\s*([\d.]+)\s*([smhd]?)\s*", s)
    if not m:
        raise ValueError(f"cannot parse time string: {s}")
    value, unit = float(m.group(1)), m.group(2) or "s"
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}[unit]
    return value * mult


def get_dataframe_series_list(file_path) -> List[str]:
    """The series names ``I…_D…_T…`` of the dataframe dumps
    ``{prefix}_{group}_{series}_F{dump}`` (``.hdf5`` or ``.npz``) in a
    directory, unique, in file-name order."""
    if not os.path.isdir(file_path):
        raise ValueError("ERROR: Expecting a directory!")
    files = sorted(glob.glob(os.path.join(file_path, "*.hdf5"))
                   + glob.glob(os.path.join(file_path, "*.npz")))
    if not files:
        raise ValueError(f"ERROR: No HDF5 files found in {file_path}")
    series_list = []
    for afile in files:
        name = os.path.basename(afile)
        start = name.find("_I")
        end = name.find("_F")
        if start < 0 or end < 0 or end <= start:
            continue
        series = name[start + 1:end]
        if series not in series_list:
            series_list.append(series)
    return series_list


def find_psd_peaks(f, psd, fmin=100.0, fmax=1000.0, npeaks=1,
                   min_separation_hz=0.0, min_prominence=None):
    """Up to ``npeaks`` of the highest ``scipy.signal.find_peaks`` peaks
    of ``psd`` within [fmin, fmax] (at least ``min_separation_hz`` apart,
    of ``min_prominence`` when given), highest first, as dicts of freq,
    amplitude, prominence, left and right base frequencies and index.
    Without a bin in the band, the bin nearest to it; without a peak, the
    band's maximum."""
    from scipy.signal import find_peaks as _find_peaks

    f = np.asarray(f)
    y = np.asarray(psd)
    band = (f >= fmin) & (f <= fmax)
    if not np.any(band):
        distances = np.where(f < fmin, fmin - f,
                             np.where(f > fmax, f - fmax, 0.0))
        idx = int(np.argmin(distances))
        return [{"freq": float(f[idx]), "amplitude": float(y[idx]),
                 "prominence": 0.0, "left_base_freq": float(f[idx]),
                 "right_base_freq": float(f[idx]), "index": idx}]
    fb = f[band]
    yb = y[band]
    offset = int(np.flatnonzero(band)[0])
    df = np.median(np.diff(fb)) if len(fb) > 1 else 1.0
    distance = max(int(round(min_separation_hz / df)), 1)
    kwargs = {"distance": distance}
    kwargs["prominence"] = (min_prominence if min_prominence is not None
                            else (None, None))
    idxs, props = _find_peaks(yb, **kwargs)
    if len(idxs) == 0:
        imax = int(np.argmax(yb))
        return [{"freq": float(fb[imax]), "amplitude": float(yb[imax]),
                 "prominence": 0.0, "left_base_freq": float(fb[imax]),
                 "right_base_freq": float(fb[imax]),
                 "index": imax + offset}]
    order = np.argsort(yb[idxs])[::-1][:npeaks]
    prom = props.get("prominences")
    lb = props.get("left_bases")
    rb = props.get("right_bases")
    out = []
    for k in order:
        i = idxs[k]
        out.append({
            "freq": float(fb[i]),
            "amplitude": float(yb[i]),
            "prominence": float(prom[k]) if prom is not None else 0.0,
            "left_base_freq": (float(fb[lb[k]]) if lb is not None
                               else float(fb[i])),
            "right_base_freq": (float(fb[rb[k]]) if rb is not None
                                else float(fb[i])),
            "index": int(i) + offset,
        })
    return out
