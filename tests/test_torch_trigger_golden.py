"""An analytic golden of the continuous-data trigger under correlated noise,
in float64 on the CPU, independent of the JAX package.

Two channels and two templates (a slow and a fast pulse, each seen in
both channels). Each channel's noise is white; channel 1's is 0.6 times
channel 0's delayed by 5 samples plus 0.8 times its own, so the CSD has a
cross term with a frequency-dependent phase, C₁₀(f) = 0.6·PSD·e^{−2πif·5},
which the trigger bank is built from. For noise that the bank describes:

- the amplitudes read at the injected pulses' trigger points scatter by
  ``kernel.resolution`` = √diag(W⁻¹), without bias;
- Δχ² = qᵀW⁻¹q on pure noise follows χ² with M = 2 degrees of freedom,
  whose CDF is 1 − e^{−x/2} (a Kolmogorov–Smirnov test at a fixed seed,
  on samples 2048 apart, further than the filter is long).

The statistical limits are 5 standard errors of the estimate (the mean of
n values: σ/√n; a standard deviation: σ/√(2n)), and a KS p-value above
1e-3.
"""

import math

import numpy as np
import pytest
import torch

from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import filterbank, trigger

torch.set_num_threads(1)

FS = 1.25e6
NT, PRETRIG = 1024, 256
PSD = 4e-18
DELAY, MIX = 5, 0.6
EVENTS, L = 16, 131072
SPACING = 2048             # pulses and noise samples: > the filter length
NSIGMA = 5.0


def _templates():
    t1 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                             tau_f1=60e-6)
    t2 = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=8e-6,
                             tau_f1=30e-6)
    tm = np.zeros((2, 2, NT))
    tm[0, 0], tm[1, 0] = t1, 0.5 * t1
    tm[0, 1], tm[1, 1] = 0.3 * t2, t2
    return tm


def _csd():
    ph = np.exp(-2j * np.pi * np.fft.fftfreq(NT) * DELAY)
    out = np.zeros((2, 2, NT), complex)
    out[0, 0] = out[1, 1] = PSD
    out[1, 0] = MIX * PSD * ph
    out[0, 1] = np.conj(out[1, 0])
    return out


def _noise(rng):
    w = rng.standard_normal((EVENTS, 2, L)) * math.sqrt(PSD * FS)
    w[:, 1] = (MIX * np.roll(w[:, 0], DELAY, axis=-1)
               + math.sqrt(1 - MIX ** 2) * w[:, 1])
    return w


@pytest.fixture(scope="module")
def kernel():
    bank = filterbank.make_ofnxm_bank(_templates(), _csd(), FS, PRETRIG)
    k = trigger.make_trigger_kernel(bank, real_dtype=np.float64)
    np.testing.assert_allclose(k.resolution, bank.resolution, rtol=1e-12)
    return k


def _filter(x, kernel):
    q = trigger.of_fir(torch.as_tensor(x), kernel)
    d, a = trigger.delta_chi2(q, kernel.iw_matrix)
    return d.numpy(), a.numpy()


def test_amplitude_scatter_equals_the_resolution(kernel):
    x = _noise(np.random.default_rng(11))
    tm = _templates()
    at = np.arange(2 * NT, L - 2 * NT, SPACING)
    truth = np.array([15.0, 25.0]) * kernel.resolution
    for e in range(EVENTS):
        for t in at:
            x[e, :, t - PRETRIG:t - PRETRIG + NT] += np.einsum(
                "cmn,m->cn", tm, truth)
    _, amps = _filter(x, kernel)
    err = (amps[:, :, at] - truth[None, :, None]) / kernel.resolution[
        None, :, None]                                    # [E, M, P]
    err = err.transpose(1, 0, 2).reshape(2, -1)
    n = err.shape[1]
    assert n > 900
    for m in range(2):
        assert abs(err[m].mean()) < NSIGMA / math.sqrt(n), (m, err[m].mean())
        assert abs(err[m].std() - 1.0) < NSIGMA / math.sqrt(2 * n), (
            m, err[m].std())
    # the two amplitudes' errors correlate as W⁻¹ says
    iw = np.asarray(kernel.iw_matrix)
    rho = iw[0, 1] / math.sqrt(iw[0, 0] * iw[1, 1])
    got = np.corrcoef(err)[0, 1]
    assert abs(got - rho) < NSIGMA * (1 - rho ** 2) / math.sqrt(n), (got, rho)


def _ks_pvalue(d, n):
    """Asymptotic Kolmogorov distribution: P(D_n > d)."""
    t = d * (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n))
    return min(1.0, 2 * sum((-1) ** (k - 1) * math.exp(-2 * k * k * t * t)
                            for k in range(1, 101)))


def test_delta_chi2_on_noise_follows_chi2_m(kernel):
    dchi2, _ = _filter(_noise(np.random.default_rng(12)), kernel)
    sample = dchi2[:, np.arange(2 * NT, L - 2 * NT, SPACING)].reshape(-1)
    n = sample.size
    assert n > 900
    m = 2
    # mean and variance of χ²_M: M and 2M
    assert abs(sample.mean() - m) < NSIGMA * math.sqrt(2 * m / n)
    xs = np.sort(sample)
    cdf = 1.0 - np.exp(-xs / 2.0)                       # χ²₂
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert _ks_pvalue(ks, n) > 1e-3, (ks, n)
