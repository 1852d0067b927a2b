"""Entry point: the of1x1 feature step on one device.

Counterpart of ``__graft_entry__.entry()`` of the JAX package: the same
trace length (16384 samples at fs = 1.25 MHz, pretrigger n/2), template,
1/f noise PSD and example batch, here as a :class:`FeatureStep` module and
its example arguments on an explicit device.
"""

from __future__ import annotations

import numpy as np
import torch

from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import filterbank
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep

FS = 1.25e6
CHANNEL = "chan1"


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
