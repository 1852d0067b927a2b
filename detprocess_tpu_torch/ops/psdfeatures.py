"""Per-event PSD features on the natural half spectrum: band amplitudes,
peak finding and the phase at the peaks.

Counterpart of the half-spectrum functions of
``detprocess_tpu/ops/psdfeatures.py`` (the reference's
FeatureExtractors.psd_amp / psd_peaks / phase,
detprocess/core/algorithms.py:952-1343). They read ṽ_h = ``ops/fft.rfft``
of the trace, which on the card is the hand-written rFFT kernel's output:

- the folded per-event PSD is |ṽ_k|²/(N·fs), doubled but at DC and (even
  N) Nyquist; the amplitude spectral density is its square root with DC
  dropped;
- peaks are strict local maxima in a band, picked greedily from the
  highest with ±distance suppression (scipy find_peaks semantics), or the
  band's largest bins when it holds no local maximum; missing peaks carry
  the framework's sentinel −999999.0.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

SENTINEL = -999999.0


def event_psd_folded_half(vr_h: torch.Tensor, fs: float, n: int):
    """(asd [..., N//2], dc [...]) of the half spectrum ``vr_h``
    [..., N//2+1]."""
    psd = (vr_h.real ** 2 + vr_h.imag ** 2) / (n * fs)
    # made on the device: a host copy would wait for the stream's work
    scale = torch.full((n // 2 + 1,), 2.0, dtype=psd.dtype,
                       device=psd.device)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    folded = psd * scale
    return torch.sqrt(folded[..., 1:]), torch.sqrt(folded[..., 0])


def psd_amp_half(vr_h: torch.Tensor, fs: float, n: int,
                 ind_ranges) -> torch.Tensor:
    """Mean folded ASD over each [low, high) index range of the folded,
    DC-dropped axis (``utils/freq.get_ind_freq_ranges``): [..., nranges]."""
    asd, _ = event_psd_folded_half(vr_h, fs, n)
    return torch.stack([asd[..., lo:hi].mean(dim=-1) for lo, hi in ind_ranges],
                       dim=-1)


def band_mask(freqs_fold: np.ndarray, freq_range) -> np.ndarray:
    """Boolean band over the folded axis for a [low, high] or [f] range;
    the bin nearest ``low`` when the band holds no bin (features.py
    :1040-1046)."""
    band = np.zeros(len(freqs_fold), dtype=bool)
    flo = freq_range[0]
    fhi = freq_range[1] if len(freq_range) == 2 else freq_range[0]
    band[(freqs_fold >= flo) & (freqs_fold <= fhi)] = True
    if not band.any():
        band[np.argmin(np.abs(freqs_fold - flo))] = True
    return band


def _local_max_mask(y: torch.Tensor) -> torch.Tensor:
    """Strict local maxima; the first and last bins never are."""
    inf = torch.full_like(y[..., :1], math.inf)
    left = torch.cat([inf, y[..., :-1]], dim=-1)
    right = torch.cat([y[..., 1:], inf], dim=-1)
    return (y > left) & (y > right)


def find_peaks_topk(y: torch.Tensor, band, npeaks: int,
                    distance_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy top-``npeaks`` peaks of ``y`` [..., F] in the boolean band
    [F] (an array, or a tensor on ``y``'s device) with ±``distance_bins``
    suppression: (indices [..., npeaks], -1 where missing; values [...,
    npeaks], SENTINEL where missing)."""
    band_t = torch.as_tensor(band, dtype=torch.bool, device=y.device)
    localmax = _local_max_mask(y) & band_t
    any_local = localmax.any(dim=-1, keepdim=True)
    candidates = torch.where(any_local, localmax, band_t)
    neg_inf = torch.full_like(y, -math.inf)
    work = torch.where(candidates, y, neg_inf)
    pos = torch.arange(y.shape[-1], device=y.device)
    idxs, vals = [], []
    for _ in range(npeaks):
        idx = torch.argmax(work, dim=-1)
        val = torch.gather(work, -1, idx[..., None])[..., 0]
        good = torch.isfinite(val)
        suppress = (pos - idx[..., None]).abs() <= max(distance_bins, 0)
        work = torch.where(suppress, neg_inf, work)
        idxs.append(torch.where(good, idx, torch.full_like(idx, -1)))
        vals.append(torch.where(good, val, torch.full_like(val, SENTINEL)))
    return torch.stack(idxs, dim=-1), torch.stack(vals, dim=-1)


def _peak_freqs(idxs: torch.Tensor, n: int, fs: float,
                dtype) -> torch.Tensor:
    # utils/freq.folded_freqs, made on the device with numpy's arithmetic
    k = torch.arange(1, n // 2 + 1, dtype=torch.float64, device=idxs.device)
    freqs = (k * (1.0 / (n * (1.0 / fs)))).to(dtype)
    return torch.where(idxs >= 0, freqs[idxs.clamp(min=0)],
                       torch.full(idxs.shape, SENTINEL, dtype=dtype,
                                  device=idxs.device))


def psd_peaks_half(vr_h: torch.Tensor, fs: float, n: int, band,
                   npeaks: int, distance_bins: int):
    """Top-``npeaks`` ASD peaks in ``band`` (folded, DC-dropped axis):
    (peak freqs [..., npeaks], peak amps [..., npeaks], dc amp [...])."""
    asd, dc_amp = event_psd_folded_half(vr_h, fs, n)
    idxs, amps = find_peaks_topk(asd, band, npeaks, distance_bins)
    return _peak_freqs(idxs, n, fs, asd.dtype), amps, dc_amp


def phase_at_peaks_half(vr_h: torch.Tensor, fs: float, n: int,
                        band, npeaks: int, distance_bins: int,
                        pretrigger: int = 0, threshold_factor: float = 0.0):
    """Phase (radians) of the spectrum at the ASD peaks in ``band``,
    referenced to the pretrigger sample (ṽ_k·e^{2πik·pretrigger/N}); bins
    below ``threshold_factor``·max|ṽ| give SENTINEL. Returns (peak freqs,
    phases), each [..., npeaks].

    The reference factor: k·pretrigger is reduced mod N in integers and
    the angle formed in float64, so that the factor is exact to float64
    at every k (the JAX function forms k·(pretrigger/N) in the run's
    dtype, a few milliradians off in float32 at N = 32768)."""
    asd, _ = event_psd_folded_half(vr_h, fs, n)
    idxs, _ = find_peaks_topk(asd, band, npeaks, distance_bins)
    mag = vr_h.abs()
    thr = mag.max(dim=-1, keepdim=True).values * threshold_factor
    # the phases only at the peaks' bins (folded index + 1)
    safe = idxs.clamp(min=0) + 1
    v = torch.gather(vr_h, -1, safe)
    kp = (torch.arange(n // 2 + 1, dtype=torch.int64, device=vr_h.device)
          * (int(pretrigger) % n)) % n
    angle = (2.0 * math.pi / n) * kp.to(torch.float64)
    factor = torch.polar(torch.ones_like(angle), angle).to(vr_h.dtype)
    phase = torch.angle(v * factor[safe])
    keep = (idxs >= 0) & (torch.gather(mag, -1, safe) >= thr)
    phases = torch.where(keep, phase, torch.full_like(phase, SENTINEL))
    return _peak_freqs(idxs, n, fs, asd.dtype), phases
