"""Windowed trace statistics — baseline, integral, max/min, energy absorbed.

Counterpart of ``detprocess_tpu/ops/tracestats.py`` (the reference's
detprocess/core/algorithms.py:651-949). A feature over window
``[min_index, max_index]`` reduces ``trace[min:max]`` (max exclusive; the
default max is ``nb_samples - 1``, so the last sample is excluded).
"""

from __future__ import annotations

import torch


def _trapz(y: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Trapezoidal integral over the last axis."""
    return dx * (torch.sum(y, dim=-1) - 0.5 * (y[..., 0] + y[..., -1]))


def baseline(traces: torch.Tensor, window_min_index: int = 0,
             window_max_index: int | None = None) -> torch.Tensor:
    """Mean of trace[min:max]."""
    if window_max_index is None:
        window_max_index = traces.shape[-1] - 1
    return torch.mean(traces[..., window_min_index:window_max_index], dim=-1)


def integral(traces: torch.Tensor, fs: float, window_min_index: int = 0,
             window_max_index: int | None = None) -> torch.Tensor:
    """trapz(trace[min:max]) / fs."""
    if window_max_index is None:
        window_max_index = traces.shape[-1] - 1
    return _trapz(traces[..., window_min_index:window_max_index]) / fs


def maximum(traces: torch.Tensor, window_min_index: int = 0,
            window_max_index: int | None = None) -> torch.Tensor:
    if window_max_index is None:
        window_max_index = traces.shape[-1] - 1
    return torch.amax(traces[..., window_min_index:window_max_index], dim=-1)


def minimum(traces: torch.Tensor, window_min_index: int = 0,
            window_max_index: int | None = None) -> torch.Tensor:
    if window_max_index is None:
        window_max_index = traces.shape[-1] - 1
    return torch.amin(traces[..., window_min_index:window_max_index], dim=-1)


def energyabsorbed(traces: torch.Tensor, fs: float, vb: float, i0: float,
                   rl: float, window_min_index: int = 0,
                   window_max_index: int | None = None) -> torch.Tensor:
    """Energy absorbed by the TES: baseline from trace[:min];
    p0 = δi·(vb − 2·i0·rl) − δi²·rl integrated with dx = 1/fs."""
    if window_max_index is None:
        window_max_index = traces.shape[-1]
    base = torch.mean(traces[..., :window_min_index], dim=-1, keepdim=True)
    i_trace = traces[..., window_min_index:window_max_index] - base
    p0 = i_trace * (vb - 2.0 * i0 * rl) - i_trace ** 2 * rl
    return _trapz(p0, dx=1.0 / fs)
