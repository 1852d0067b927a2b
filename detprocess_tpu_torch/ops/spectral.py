"""Spectral operations: Welch PSD and CSD estimates, periodograms, spectrum
folding, and the zero-phase low-pass of the trigger path.

Counterpart of ``detprocess_tpu/ops/spectral.py``: ``periodogram`` :62,
``welch_psd`` :150, ``welch_csd`` :250, ``fold_spectrum`` :40 and
``lowpass_filter`` :288 (the Butterworth low-pass that the saturation veto
reads, reference qetpy.utils.lowpassfilter in
detprocess/core/oftrigger.py:627-633, and that ``rftau`` applies as its RC
filter).

Conventions (QETpy's, as the JAX module states them):

- PSDs are two-sided, in A²/Hz, on numpy's ``fftfreq`` axis:
  ``psd = mean |FFT(x)|² / (N·fs)``;
- ``csd[i, j, k] = mean(FFT(x_i)_k · conj(FFT(x_j)_k)) / (N·fs)``.

The JAX functions transform the full complex spectrum (a TPU layout
choice). Here every spectrum is the half spectrum of ``ops/fft.rfft``
(the hand-written kernel on CUDA tensors for N in 256 … 32768, cuFFT
otherwise); the means are taken over it and mirrored onto the two-sided
axis: S[N−k] = S[k], CSD[..., N−k] = conj(CSD[..., k]), as for any real
input. The ``hann`` window is numpy's symmetric ``hanning`` (what
``jnp.hanning`` computes), with the estimate scaled by 1/mean(w²).
"""

from __future__ import annotations

import numpy as np
import torch

from detprocess_tpu_torch.ops import fft
from detprocess_tpu_torch.utils.freq import fold_half


def window_and_scale(n: int, name, dtype: torch.dtype, device):
    """(window [n] or None, power scale 1/mean(w²)) of ``name``: None
    (boxcar) or ``"hann"``."""
    if name is None:
        return None, 1.0
    if name != "hann":
        raise ValueError(f"unknown window: {name}")
    w = torch.as_tensor(np.hanning(n), dtype=dtype, device=device)
    return w, float(1.0 / torch.mean(w * w))


def half_spectrum(traces: torch.Tensor, window_name=None):
    """(rfft of the windowed traces [..., N/2 + 1], the window's power
    scale)."""
    w, scale = window_and_scale(traces.shape[-1], window_name,
                                traces.dtype, traces.device)
    return fft.rfft(traces if w is None else traces * w), scale


def mirror(half: torch.Tensor, n: int, conj: bool = False) -> torch.Tensor:
    """The two-sided [..., n] spectrum of a real signal's half spectrum
    [..., n//2 + 1]: bin n−k is bin k (conjugated with ``conj``)."""
    neg = half[..., 1:n - half.shape[-1] + 1].flip(-1)
    return torch.cat([half, neg.conj() if conj else neg], dim=-1)


def mean_psd(spectra: torch.Tensor, n: int, fs: float,
             scale: float = 1.0) -> torch.Tensor:
    """Two-sided PSD [..., n]: the mean of |X|² over the trace axis (−2)
    of half spectra ``spectra`` [..., B, n//2 + 1]."""
    power = spectra.real ** 2 + spectra.imag ** 2
    return mirror(power.mean(dim=-2), n) * (scale / (n * fs))


def mean_csd(spectra: torch.Tensor, n: int, fs: float,
             scale: float = 1.0) -> torch.Tensor:
    """Two-sided CSD [C, C, n] of half spectra [B, C, n//2 + 1]:
    ``mean_b X_i · conj(X_j)``."""
    csd = torch.einsum("bik,bjk->ijk", spectra, spectra.conj())
    return mirror(csd, n, conj=True) * (scale / (n * fs * spectra.shape[0]))


def periodogram(traces: torch.Tensor, fs: float) -> torch.Tensor:
    """Two-sided periodogram of each trace, |FFT|² / (N·fs); shape kept."""
    n = traces.shape[-1]
    x = fft.rfft(traces)
    return mirror(x.real ** 2 + x.imag ** 2, n) / (n * fs)


def welch_psd(traces: torch.Tensor, fs: float, window=None) -> torch.Tensor:
    """Mean two-sided PSD of ``traces`` [..., B, N] over the trace axis;
    ``window`` None (boxcar, QETpy's default) or ``"hann"``."""
    spectra, scale = half_spectrum(traces, window)
    return mean_psd(spectra, traces.shape[-1], fs, scale)


def welch_csd(traces: torch.Tensor, fs: float, window=None) -> torch.Tensor:
    """Mean CSD [C, C, N] of ``traces`` [B, C, N], Hermitian in the
    channel axes."""
    spectra, scale = half_spectrum(traces, window)
    return mean_csd(spectra, traces.shape[-1], fs, scale)


def fold_spectrum(psd: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Fold a two-sided PSD (last axis) onto the non-negative frequencies:
    every bin but DC, and Nyquist for even N, doubled."""
    return fold_half(psd, psd.shape[-1] if n is None else n)


def lowpass_filter(traces: torch.Tensor, cut_off_freq: float, fs: float,
                   order: int = 2) -> torch.Tensor:
    """Zero-phase Butterworth low-pass over the last axis, applied in the
    frequency domain: filtfilt's transfer function |H(f)|², the gain
    1 / (1 + (f/fc)^(2·order)), on the half spectrum of ``ops/fft.rfft``.
    Circular, like the JAX function: it differs from filtfilt's reflect
    padding only near the trace edges, which triggering excludes."""
    return lowpass_from_spectrum(fft.rfft(traces), traces.shape[-1],
                                 cut_off_freq, fs, order)


def lowpass_from_spectrum(vhalf: torch.Tensor, n: int, cut_off_freq: float,
                          fs: float, order: int = 2) -> torch.Tensor:
    """:func:`lowpass_filter` of the length-``n`` traces whose half
    spectrum ``vhalf`` already is."""
    # the gain in float64 on the spectrum's device (one small kernel, not
    # a host computation and copy of N/2+1 values per call)
    f = torch.fft.rfftfreq(n, d=1.0 / fs, dtype=torch.float64,
                           device=vhalf.device)
    gain = (1.0 / (1.0 + (f / cut_off_freq) ** (2 * order))).to(
        vhalf.real.dtype)
    return fft.irfft(vhalf * gain, n)
