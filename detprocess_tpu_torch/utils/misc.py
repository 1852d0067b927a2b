"""Series names, an order-preserving de-duplication, and the linear-segment
test of IV-sweep state tagging.

Copies of ``create_series_name``, ``unique_list`` and
``find_linear_segment`` :48 from ``detprocess_tpu/utils/misc.py`` (the
reference's detprocess/utils/utils.py:28-52, :418-434 and :304-356),
host numpy.
"""

from __future__ import annotations

from datetime import datetime
from typing import List

import numpy as np


def create_series_name(facility: int, now: datetime | None = None) -> str:
    """'I{facility}_D{yyyymmdd}_T{hhmmss}'."""
    now = now or datetime.now()
    return f"I{facility}_D{now.strftime('%Y%m%d')}_T{now.strftime('%H%M%S')}"


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
