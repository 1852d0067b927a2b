"""dIdV square-wave lock-in: cuts, period folding and the complex dIdV(f)
at the square wave's odd harmonics.

Port of ``detprocess_tpu/ops/lockin.py`` (``DIDVData`` :28,
``fold_periods`` :43, ``process_didv_traces`` :50), the counterpart of
qetpy.DIDV.processtraces (reference call sites core/didv.py:1635-1645,
process/ivprocess.py:606-661). The traces [B, N] stay on the caller's
device, where the trace work runs in float64, as the JAX package does it
in numpy float64:

- the quality cuts (``ops/autocuts.autocuts_didv``);
- the folding into whole periods, the period mean, the offset and its
  error;
- the spectra of the mean period and of every period (``torch.fft.rfft``
  in float64: the JAX function takes them with ``np.fft``, not with a
  Pallas kernel, and the period, fs/sgfreq = 12500 samples at 1.25 MHz
  and 100 Hz, is no length of the hand-written kernel; the half spectrum
  suffices, every odd harmonic lies below n/2);
- the scatter of each harmonic across periods.

The edge detection (a circular box-difference correlation and the first
largest |score|) and the sign test act on one period vector and the
harmonics; they run on the host in float64.

Conventions:
- ``sgfreq`` [Hz] square-wave frequency; a trace holds whole periods of
  period_bins = fs/sgfreq samples, which must be an integer;
- ``sgamp`` [A] is half the peak-to-peak bias-current square wave through
  the shunt; the voltage excitation is δV = sgamp·rsh;
- the square wave's phase comes from the detected switching edge of the
  mean response.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from detprocess_tpu_torch.ops import autocuts as cuts


class DIDVData(NamedTuple):
    freqs: np.ndarray        # odd-harmonic frequencies [Hz]
    didv: np.ndarray         # complex dIdV at those frequencies [1/Ω]
    weights: np.ndarray      # per-frequency fit weights (1/σ)
    mean_period: np.ndarray  # period-folded mean response [A]
    offset: float            # DC current offset [A]
    offset_err: float
    fs: float
    sgfreq: float
    sgamp: float
    rsh: float
    nb_periods: int
    nb_traces_kept: int


def fold_periods(traces: torch.Tensor, period_bins: int) -> torch.Tensor:
    """[B, N] → [B·nper, period_bins] whole-period segments."""
    b, n = traces.shape
    nper = n // period_bins
    return traces[:, : nper * period_bins].reshape(b * nper, period_bins)


def period_bins_of(fs: float, sgfreq: float) -> int:
    """fs/sgfreq as an int, or a ValueError when it is not one."""
    period_bins = int(round(fs / sgfreq))
    if abs(fs / sgfreq - period_bins) > 1e-6:
        raise ValueError(
            f"square-wave period ({fs/sgfreq:.3f} samples) must be an "
            f"integer number of samples")
    return period_bins


def process_didv_traces(traces, fs: float, sgfreq: float,
                        sgamp: float, rsh: float,
                        nsigma_cut: float = 2.5,
                        apply_cuts: bool = True) -> DIDVData:
    """Lock-in average and dIdV(f) of raw traces [B, N] (a tensor on its
    device, or a numpy array, taken on the CPU), in float64."""
    x = torch.as_tensor(traces).to(torch.float64)
    period_bins = period_bins_of(fs, sgfreq)

    if apply_cuts and x.shape[0] > 3:
        mask = cuts.autocuts_didv(x, nsigma=nsigma_cut)
        if int(mask.sum()) >= 2:
            x = x[mask]
    nkept = x.shape[0]

    periods = fold_periods(x, period_bins)
    nper = periods.shape[0]
    mean_period_d = periods.mean(dim=0)
    offset_d = mean_period_d.mean()
    offset_err_d = (periods.mean(dim=-1).std(correction=0)
                    / math.sqrt(max(nper, 1)))
    n = period_bins
    harmonics = np.arange(1, n // 2, 2)
    harm_d = torch.as_tensor(harmonics, device=x.device)
    resp_d = torch.fft.rfft(mean_period_d - offset_d)[harm_d]
    # per-harmonic scatter across periods: the population std of a
    # complex array, √mean|z − z̄|², over the periods
    per = torch.fft.rfft(periods - periods.mean(dim=-1, keepdim=True),
                         dim=-1)[:, harm_d]
    dev = per - per.mean(dim=0, keepdim=True)
    scatter_d = torch.sqrt((dev.real ** 2 + dev.imag ** 2).mean(dim=0))

    mean_period = mean_period_d.cpu().numpy()
    offset = float(offset_d)
    offset_err = float(offset_err_d)
    resp_h = resp_d.cpu().numpy()
    scatter = scatter_d.cpu().numpy() / np.sqrt(max(nper, 1))

    # ideal ±sgamp/2 square wave (current through the shunt → volts)
    t = np.arange(n)
    square = np.where(t < n // 2, 0.5, -0.5) * (sgamp * rsh)

    # Square-wave phase: the response switches at each edge through the
    # fast electrical time constant. A box-difference matched filter (the
    # mean of the next W samples less that of the previous W) peaks at
    # the step; its first largest |score| gives the edge.
    w_box = max(min(32, n // 8), 1)
    kernel = np.concatenate([np.full(w_box, 1.0 / w_box),
                             np.full(w_box, -1.0 / w_box)])
    # circular correlation: the score at i uses samples [i−W, i+W)
    pad = np.concatenate([mean_period, mean_period[: 2 * w_box]])
    score = np.correlate(pad, kernel[::-1], mode="valid")[: n]
    shift = (int(np.argmax(np.abs(score))) + w_box) % n
    square = np.roll(square, shift)
    sq_fft = np.fft.fft(square)

    # odd harmonics below Nyquist
    freqs = harmonics * sgfreq
    didv = resp_h / sq_fft[harmonics]

    denom = np.abs(sq_fft[harmonics])
    sigma = np.clip(np.abs(scatter) / np.clip(denom, 1e-30, None), 1e-30,
                    None)
    weights = 1.0 / sigma

    # The detected edge may be the opposite switching edge (a half-period
    # ambiguity, a sign flip at odd harmonics). Re dVdI → Rl+R0(1+β) > 0
    # once ωτ₁ ≳ 1: test a weighted mid-band (low harmonics can have
    # Re dVdI < 0 at high loop gain, the top ones are noise).
    nh = len(didv)
    lo = max(3, nh // 60)
    hi = max(lo + 5, nh // 6)
    if lo >= nh:
        # a very short period gives only a few odd harmonics: test them all
        lo, hi = 0, nh
    band = slice(lo, min(hi, nh))
    re_dvdi = (1.0 / didv[band]).real
    if np.average(re_dvdi, weights=weights[band] ** 2) < 0:
        didv = -didv

    return DIDVData(freqs=freqs, didv=didv, weights=weights,
                    mean_period=mean_period, offset=offset,
                    offset_err=offset_err, fs=fs, sgfreq=sgfreq,
                    sgamp=sgamp, rsh=rsh, nb_periods=nper,
                    nb_traces_kept=nkept)
