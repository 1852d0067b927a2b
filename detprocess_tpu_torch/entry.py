"""Entry points: the of1x1 feature step and the continuous-data trigger
step on one device.

- :func:`entry` is the counterpart of ``__graft_entry__.entry()`` of the
  JAX package: the same trace length (16384 samples at fs = 1.25 MHz,
  pretrigger n/2), template, 1/f noise PSD and example batch, here as a
  :class:`FeatureStep` module and its example arguments on an explicit
  device.
- :func:`trigger_entry` is the trigger configuration of
  ``benchmarks/trigger_stages.py:44-61`` (8 continuous events of
  1,250,000 samples, 4096-sample template, flat noise PSD, pileup window
  125 samples, 5σ) as a residual-mode :class:`TriggerStep` and a batch of
  its noise.
"""

from __future__ import annotations

import numpy as np
import torch

from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import filterbank, trigger
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep
from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep

FS = 1.25e6
CHANNEL = "chan1"

# trigger configuration (benchmarks/trigger_stages.py:42-52)
TRIGGER_NT = 4096
TRIGGER_PRETRIG = 1024
TRIGGER_PSD = 4e-18           # flat two-sided noise PSD, A²/Hz
TRIGGER_EVENTS = 8
TRIGGER_L = 1_250_000
TRIGGER_WINDOW = 125
TRIGGER_SIGMA = 5.0
# saturation level of the 50 kHz low-passed trace, in amplitude
# resolutions: far above the 10σ pulses of the smoke run, so that the
# veto runs on every batch and vetoes only what saturates
TRIGGER_SAT_RESOLUTIONS = 1000.0


def build_bank(n: int, pretrig: int, fs: float = FS):
    """Two-pole template (τ_r 20 µs, τ_f 200 µs) and the 1/f PSD
    1e-20·(1 + 100 Hz/|f|) A²/Hz; returns (OF1x1Bank, template, psd)."""
    template = pulse.make_template(fs, n, pretrig, A=1.0, tau_r=20e-6,
                                   tau_f1=200e-6)
    f = np.abs(np.fft.fftfreq(n, 1 / fs))
    f[0] = f[1]
    psd = 1e-20 * (1.0 + 100.0 / f)
    bank = filterbank.make_of1x1_bank(template, psd, fs, pretrig)
    return bank, template, psd


def entry(device, dtype=torch.float32):
    """Return ``(step, (traces,))``: a :class:`FeatureStep` for one channel
    and an example batch [16, 1, 16384] on ``device``."""
    n = 16384
    pretrig = n // 2
    batch = 16
    bank, template, _ = build_bank(n, pretrig)
    step = FeatureStep(filterbank.bank_to_torch(bank, device, dtype),
                       [CHANNEL], FS, pretrig, n)
    rng = np.random.default_rng(0)
    traces = (rng.standard_normal((batch, n)) * 1e-8
              + 2e-6 * template[None, :]).astype(np.float32)
    x = torch.as_tensor(traces[:, None, :], dtype=dtype, device=device)
    return step, (x,)


def build_trigger(fs: float = FS, real_dtype=np.float32):
    """Two-pole template (τ_r 20 µs, τ_f 200 µs, Nt 4096, pretrigger 1024),
    the flat PSD 4e-18 A²/Hz, the NxM bank, the trigger kernel and its
    residual basis; returns (kernel, basis, template)."""
    template = pulse.make_template(fs, TRIGGER_NT, TRIGGER_PRETRIG, A=1.0,
                                   tau_r=20e-6, tau_f1=200e-6)
    psd = np.full(TRIGGER_NT, TRIGGER_PSD)
    bank = filterbank.make_ofnxm_bank(template, psd.astype(complex), fs,
                                      TRIGGER_PRETRIG)
    kernel = trigger.make_trigger_kernel(bank, real_dtype=real_dtype)
    return kernel, trigger.make_residual_basis(kernel), template


def trigger_entry(device, dtype=torch.float32):
    """Return ``(step, (traces,))``: a residual-mode :class:`TriggerStep`
    with the saturation veto on, and a batch of white noise [8, 1,
    1250000] of the configuration's PSD on ``device``."""
    kernel, basis, _ = build_trigger(
        real_dtype=np.float64 if dtype == torch.float64 else np.float32)
    sat = TRIGGER_SAT_RESOLUTIONS * float(kernel.resolution[0])
    step = TriggerStep(kernel, basis, TRIGGER_SIGMA, TRIGGER_WINDOW,
                       run_residual=True, sat_amps=[sat], device=device,
                       dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((TRIGGER_EVENTS, 1, TRIGGER_L), generator=gen,
                    device=device, dtype=dtype) * np.sqrt(TRIGGER_PSD * FS)
    return step, (x,)
