"""Analytic TES pulse templates (host numpy, float64).

Copy of ``detprocess_tpu/models/pulse.py`` (qetpy's
make_template_twopole/threepole/fourpole/sum_twopoles as used by
detprocess/core/template.py:327-447). It is a copy, not an import,
because importing the JAX package needs JAX.

Functional forms (t' = t - t0, pulse zero for t' < 0):

- two-pole:   p(t') = A·(exp(-t'/τ_f1) − exp(-t'/τ_r))
- three-pole: adds B·(exp(-t'/τ_f2) − exp(-t'/τ_r))
- four-pole:  adds C·(exp(-t'/τ_f3) − exp(-t'/τ_r))
- sum of two-poles: Σ_i A_i·(exp(-t'/τ_fi) − exp(-t'/τ_ri))

``normalize=True`` scales the result to unit peak height.
"""

from __future__ import annotations

import numpy as np


def _normalize(pulse: np.ndarray, normalize: bool) -> np.ndarray:
    if normalize:
        peak = np.max(np.abs(pulse))
        if peak > 0:
            pulse = pulse / peak
    return pulse


def make_template_twopole(t, A, tau_r, tau_f, t0=0.0, fs=None,
                          normalize=True) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    tp = t - t0
    pulse = np.where(
        tp >= 0,
        A * (np.exp(-tp / tau_f) - np.exp(-tp / tau_r)),
        0.0,
    )
    return _normalize(pulse, normalize)


def make_template_threepole(t, A, B, tau_r, tau_f1, tau_f2, t0=0.0, fs=None,
                            normalize=True) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    tp = t - t0
    pulse = np.where(
        tp >= 0,
        A * (np.exp(-tp / tau_f1) - np.exp(-tp / tau_r))
        + B * (np.exp(-tp / tau_f2) - np.exp(-tp / tau_r)),
        0.0,
    )
    return _normalize(pulse, normalize)


def make_template_fourpole(t, A, B, C, tau_r, tau_f1, tau_f2, tau_f3, t0=0.0,
                           fs=None, normalize=True) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    tp = t - t0
    pulse = np.where(
        tp >= 0,
        A * (np.exp(-tp / tau_f1) - np.exp(-tp / tau_r))
        + B * (np.exp(-tp / tau_f2) - np.exp(-tp / tau_r))
        + C * (np.exp(-tp / tau_f3) - np.exp(-tp / tau_r)),
        0.0,
    )
    return _normalize(pulse, normalize)


def make_template_sum_twopoles(t, amplitudes, rise_times, fall_times,
                               t0=0.0, normalize=True) -> np.ndarray:
    t = np.asarray(t, dtype=np.float64)
    tp = t - t0
    pulse = np.zeros_like(t)
    for a, tr, tf in zip(amplitudes, rise_times, fall_times):
        pulse += np.where(tp >= 0,
                          a * (np.exp(-tp / tf) - np.exp(-tp / tr)), 0.0)
    return _normalize(pulse, normalize)


def make_template(
    sample_rate: float,
    trace_length_samples: int,
    pretrigger_length_samples: int,
    A: float = 1.0,
    B: float | None = None,
    C: float | None = None,
    tau_r: float | None = None,
    tau_f1: float | None = None,
    tau_f2: float | None = None,
    tau_f3: float | None = None,
) -> np.ndarray:
    """Template with the pole count inferred from which of A/B/C are given
    (Template.create_template logic, detprocess/core/template.py:327-401)."""
    if tau_r is None:
        raise ValueError('"tau_r" required')
    dt = 1.0 / sample_rate
    t = np.arange(trace_length_samples) * dt
    t0 = pretrigger_length_samples * dt
    if B is not None and C is not None:
        return make_template_fourpole(t, A, B, C, tau_r, tau_f1, tau_f2,
                                      tau_f3, t0=t0)
    if B is not None:
        return make_template_threepole(t, A, B, tau_r, tau_f1, tau_f2, t0=t0)
    return make_template_twopole(t, A, tau_r, tau_f1, t0=t0)
