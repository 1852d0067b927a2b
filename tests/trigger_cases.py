"""Trigger configurations and continuous traces shared by the port's
trigger parity tests (tests/test_torch_trigger*.py).

Two banks, both built with the JAX package's ``make_ofnxm_bank`` in
float64:

- ``"1x1"``: one channel, one two-pole template, flat PSD 4e-18 A²/Hz;
- ``"2x2"``: two channels and two templates (a fast and a slow pulse, each
  seen in both channels), with a CSD whose cross-channel terms carry a
  frequency-dependent phase: channel 1's noise is channel 0's delayed by
  3 samples plus its own (the construction of
  tests/test_ofnxm.py::test_exact_recovery_phase_correlated_csd, written
  analytically).
"""

import numpy as np

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb

FS = 1.25e6
PSD = 4e-18


def templates(nt, pretrig, case):
    t1 = jpulse.make_template(FS, nt, pretrig, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    if case == "1x1":
        return t1[None, None, :]
    t2 = jpulse.make_template(FS, nt, pretrig, A=1.0, tau_r=8e-6,
                              tau_f1=50e-6)
    tm = np.zeros((2, 2, nt))
    tm[0, 0], tm[1, 0] = t1, 0.5 * t1
    tm[0, 1], tm[1, 1] = 0.3 * t2, t2
    return tm


def csd(nt, case):
    """Two-sided CSD [C, C, Nt] of white noise of PSD ``PSD`` per channel;
    for "2x2", channel 1 = 0.6·(channel 0 delayed 3 samples) + 0.8·own."""
    if case == "1x1":
        return np.full((1, 1, nt), PSD, complex)
    f = np.fft.fftfreq(nt)
    ph = np.exp(-2j * np.pi * f * 3)
    out = np.zeros((2, 2, nt), complex)
    out[0, 0] = PSD
    out[1, 1] = PSD * (0.36 + 0.64)
    out[1, 0] = PSD * 0.6 * ph
    out[0, 1] = np.conj(out[1, 0])
    return out


def bank(nt, pretrig, case):
    return jfb.make_ofnxm_bank(templates(nt, pretrig, case), csd(nt, case),
                               FS, pretrig)


def noise(rng, events, nchan, length, case):
    """White noise of PSD ``PSD`` [E, C, L], correlated as ``csd`` says."""
    sigma = np.sqrt(PSD * FS)
    w = rng.standard_normal((events, nchan, length)) * sigma
    if case == "2x2":
        w[:, 1] = 0.6 * np.roll(w[:, 0], 3, axis=-1) + 0.8 * w[:, 1]
    return w


def add_pulse(trace, tmpl, pretrig, index, amps):
    """Add Σ_m amps[m]·tmpl[:, m] with its trigger point at ``index`` to
    ``trace`` [C, L] in place (clipped at the trace end)."""
    start = index - pretrig
    seg = np.einsum("cmn,m->cn", tmpl, np.atleast_1d(amps))
    n = min(seg.shape[-1], trace.shape[-1] - start)
    trace[:, start:start + n] += seg[:, :n]
