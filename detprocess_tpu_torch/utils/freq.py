"""Frequency-axis helpers: frequency axes, folding and unfolding
spectra, the sample rate of a frequency axis, and the frequency ranges of
the PSD features.

Copy of ``detprocess_tpu/utils/freq.py`` (the reference's
detprocess/utils/utils.py:437-556). The range names (``"10000_50000"``)
are part of the feature column names. This module is the one home of the
fold: :func:`fold_half` serves numpy arrays here and in
``io/filterdata``, and tensors on the card in
``ops/spectral.fold_spectrum``.
"""

from __future__ import annotations

import numpy as np


def fftfreq(n: int, fs: float) -> np.ndarray:
    """Two-sided FFT frequencies in Hz (numpy ordering)."""
    return np.fft.fftfreq(n, d=1.0 / fs)


def rfftfreq(n: int, fs: float) -> np.ndarray:
    """The non-negative frequencies of an rfft of length ``n``, in Hz."""
    return np.fft.rfftfreq(n, d=1.0 / fs)


def fold_half(psd, n: int):
    """``psd[..., :n//2+1]`` with every bin but DC, and Nyquist for even
    ``n``, doubled: a numpy array or a torch tensor (on its device) of
    the dtype it was given."""
    nfold = n // 2 + 1
    folded = psd[..., :nfold] * 2
    folded[..., 0] = psd[..., 0]
    if n % 2 == 0:
        folded[..., nfold - 1] = psd[..., nfold - 1]
    return folded


def fold_spectrum(psd: np.ndarray, fs: float):
    """Fold a two-sided PSD onto the non-negative frequencies (all bins
    but DC, and Nyquist for even N, doubled): (freqs, folded)."""
    psd = np.asarray(psd)
    n = psd.shape[-1]
    freqs = np.abs(np.fft.fftfreq(n, d=1.0 / fs)[:n // 2 + 1])
    return freqs, fold_half(psd, n)


def unfold_spectrum(psd_folded: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`fold_spectrum`: the two-sided PSD of length
    ``n``."""
    psd_folded = np.asarray(psd_folded, dtype=float)
    nfold = n // 2 + 1
    if psd_folded.shape[-1] != nfold:
        raise ValueError(
            f"folded PSD length {psd_folded.shape[-1]} inconsistent with n={n}"
        )
    half = np.array(psd_folded, copy=True)
    if n % 2 == 0:
        half[..., 1:-1] /= 2.0
        negative = half[..., 1:-1][..., ::-1]
    else:
        half[..., 1:] /= 2.0
        negative = half[..., 1:][..., ::-1]
    return np.concatenate([half, negative], axis=-1)


def estimate_sampling_rate(freq_array: np.ndarray) -> float:
    """Sample rate from a one- or two-sided frequency axis."""
    freq_sorted = np.unique(np.sort(np.asarray(freq_array)))
    positive = freq_sorted[freq_sorted > 0]
    if positive.size == 0:
        raise ValueError("no positive frequencies; cannot infer sampling rate")
    df = positive[0]
    if freq_sorted[0] < 0:
        n = len(freq_array)
    else:
        n = 2 * (len(freq_array) - 1)
    return n * df


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
