"""Batched time-domain pulse fits (rftau).

Counterpart of ``detprocess_tpu/ops/pulsefit.py::rftau`` :40 (the
reference's FeatureExtractors.rftau, detprocess/core/algorithms.py
:1345-1430): RC-filter the trace, take the baseline just before the
pulse, then fit the two-pole pulse

    amp·(exp(−(t−t0)/ftau) − exp(−(t−t0)/rtau)),  0 before t0,

over a window around the nominal trigger, per event, by the batched
Levenberg–Marquardt of ``ops/lm.py``. Times are in samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from detprocess_tpu_torch.ops import lm, spectral

LOWER_WINDOW = 800    # samples before t0 (algorithms.py:1401)
UPPER_WINDOW = 1600   # samples after t0


class RFTauResult(NamedTuple):
    risetime: torch.Tensor   # samples
    falltime: torch.Tensor   # samples
    amplitude: torch.Tensor  # max of the fitted pulse
    chisq: torch.Tensor      # mean squared residual over the window


def _twopole(t, rtau, ftau, amp, t0):
    tp = t - t0
    pulse = amp * (torch.exp(-tp / ftau.abs()) - torch.exp(-tp / rtau.abs()))
    zero = torch.zeros_like(pulse)
    return torch.where(tp > 0, torch.maximum(pulse, zero), zero)


def rftau(traces: torch.Tensor, fs: float, rtau0: float = 30.0,
          ftau0: float = 100.0, t0_index: Optional[int] = None,
          rc_cutoff: float = 50e3, max_iter: int = 40,
          spectrum: Optional[torch.Tensor] = None) -> RFTauResult:
    """Rise and fall times of a batch [B, N]. The RC filter is the
    first-order zero-phase low-pass ``ops/spectral``; ``spectrum``, the
    traces' half spectrum when the caller has it, saves its forward
    transform."""
    b, n = traces.shape
    if t0_index is None:
        t0_index = n // 2 - 10
    t0_index = int(t0_index)
    lw = min(LOWER_WINDOW, t0_index)
    uw = min(UPPER_WINDOW, n - t0_index)
    if spectrum is None:
        filtered = spectral.lowpass_filter(traces, rc_cutoff, fs, order=1)
    else:
        filtered = spectral.lowpass_from_spectrum(spectrum, n, rc_cutoff,
                                                  fs, order=1)
    base = filtered[:, t0_index - lw:t0_index].mean(dim=-1, keepdim=True)
    window = filtered[:, t0_index - lw:t0_index + uw] - base
    dt, dev = traces.dtype, traces.device
    t_win = torch.arange(t0_index - lw, t0_index + uw, dtype=dt, device=dev)

    def residual(params, y):
        return _twopole(t_win, params[0], params[1], params[2],
                        params[3]) - y

    x0 = torch.stack([torch.full((b,), rtau0, dtype=dt, device=dev),
                      torch.full((b,), ftau0, dtype=dt, device=dev),
                      window.max(dim=-1).values,
                      torch.full((b,), float(t0_index), dtype=dt,
                                 device=dev)], dim=-1)
    res = lm.batched_lm(residual, x0, (window,), max_iter=max_iter)
    p = res.params
    t_full = torch.arange(n, dtype=dt, device=dev)
    fitted = _twopole(t_full, p[:, 0, None], p[:, 1, None], p[:, 2, None],
                      p[:, 3, None])
    return RFTauResult(p[:, 0].abs(), p[:, 1].abs(),
                       fitted.max(dim=-1).values,
                       2.0 * res.cost / (lw + uw))
