"""Frequency-range helpers of the PSD features.

Copy of ``cleanup_freq_ranges`` and ``get_ind_freq_ranges`` from
``detprocess_tpu/utils/freq.py`` (the reference's
detprocess/utils/utils.py:437-504). The range names (``"10000_50000"``)
are part of the feature column names.
"""

from __future__ import annotations

import numpy as np


def cleanup_freq_ranges(f_lims):
    """Normalize a list of frequency limits into (ranges, name stubs):
    each limit is a number or a [low, high] pair; |values|, low ≤ high,
    duplicates by name dropped."""
    if not isinstance(f_lims, list):
        f_lims = [f_lims]
    freq_ranges, range_names = [], []
    for freq_range in f_lims:
        if isinstance(freq_range, (int, float)):
            freq_range = [freq_range]
        f_low = abs(freq_range[0])
        if len(freq_range) == 2:
            f_high = abs(freq_range[1])
            if f_low > f_high:
                f_low, f_high = f_high, f_low
            name = f"{round(f_low)}_{round(f_high)}"
            if name not in range_names:
                freq_ranges.append([f_low, f_high])
                range_names.append(name)
        else:
            name = f"{round(f_low)}"
            if name not in range_names:
                freq_ranges.append([f_low])
                range_names.append(name)
    return freq_ranges, range_names


def get_ind_freq_ranges(freq_ranges, freqs):
    """Map frequency ranges to [low, high) index ranges on the axis
    ``freqs`` (nearest bins; a range of one bin is widened by one)."""
    freqs = np.asarray(freqs)
    idx_ranges = []
    for freq_range in freq_ranges:
        f_low = abs(freq_range[0])
        ind_low = int(np.argmin(np.abs(freqs - f_low)))
        ind_high = ind_low + 1
        if len(freq_range) == 2:
            ind_high = int(np.argmin(np.abs(freqs - abs(freq_range[1]))))
        if ind_low > ind_high:
            ind_low, ind_high = ind_high, ind_low
        if ind_low == ind_high:
            if ind_high < len(freqs) - 1:
                ind_high += 1
            elif ind_low > 0:
                ind_low -= 1
            else:
                raise ValueError("frequency range too narrow or outside bounds")
        idx_ranges.append([ind_low, ind_high])
    return idx_ranges


def folded_freqs(n: int, fs: float) -> np.ndarray:
    """The folded, DC-dropped frequency axis [n//2] of the PSD features."""
    return np.abs(np.fft.fftfreq(n, 1.0 / fs)[: n // 2 + 1])[1:]
