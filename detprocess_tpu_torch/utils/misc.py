"""Series names and an order-preserving de-duplication.

Copies of ``create_series_name`` and ``unique_list`` from
``detprocess_tpu/utils/misc.py`` (the reference's
detprocess/utils/utils.py:28-52 and :418-434).
"""

from __future__ import annotations

from datetime import datetime

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
