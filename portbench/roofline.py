"""The least time a kernel's work can take on the card, from the
operations and bytes that the traffic's transforms need.

A copy of ``chip_smoke.bound()``: each input read once and each output
written once at the card's HBM rate, the float32 operations at its
non-tensor-core rate (5·M·log2 M for the packed M = N/2-point complex
FFT, 10 a bin for the untangle; the fused no-delay fit adds |X|² (3) and
6 a bin and slot for its two sums), the larger of the two. Peaks are the
data sheet's (``peaks.json``), for the card by name.
"""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def peaks(card: str):
    """(HBM bytes/s, float32 operations/s) of the card, or None."""
    with open(PEAKS) as f:
        table = json.load(f)
    entry = table.get(card)
    return None if entry is None else (entry["hbm_bytes_per_s"],
                                       entry["fp32_flops_per_s"])


def work(kernel: str, n: int, batch: int, nslots: int = 1):
    """(float32 operations, bytes) of one call on ``batch`` traces of
    length ``n``."""
    m = n // 2
    ops = batch * (5 * m * np.log2(m) + 10 * m)
    if kernel == "rfft":
        nbytes = batch * (4 * n + 8 * (m + 1))
    elif kernel == "fused_nodelay_of":
        nbytes = batch * (4 * n + 16 * nslots) + 12 * nslots * (m + 1)
        ops += batch * (m + 1) * (3 + 6 * nslots)
    else:
        raise ValueError(f"no work model for {kernel!r}")
    return float(ops), float(nbytes)


def bound_seconds(kernel: str, calls, card: str):
    """The least seconds of ``calls`` [[count, batch, n, (slots)]] on the
    card, and which peak bounds them ("bytes" or "operations"); None for
    a card without peaks."""
    pk = peaks(card)
    if pk is None:
        return None
    hbm, flops = pk
    t_bytes = t_ops = 0.0
    for call in calls:
        count, batch, n = call[:3]
        ops, nbytes = work(kernel, n, batch, *call[3:])
        t_bytes += count * nbytes / hbm
        t_ops += count * ops / flops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
