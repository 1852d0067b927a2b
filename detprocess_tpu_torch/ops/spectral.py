"""Spectral helpers of the trigger path and the pulse fits.

Counterpart of ``detprocess_tpu/ops/spectral.py::lowpass_filter`` :288:
the zero-phase Butterworth low-pass that the saturation veto reads
(reference: qetpy.utils.lowpassfilter, scipy butter + filtfilt, in
detprocess/core/oftrigger.py:627-633) and that ``rftau`` applies as its RC
filter.
"""

from __future__ import annotations

import torch

from detprocess_tpu_torch.ops import fft


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
