"""The port's PSD features and frequency-range helpers equal the JAX
package's.

``detprocess_tpu_torch.ops.psdfeatures`` (band amplitudes, peak finder,
peaks, phase at the peaks) against ``detprocess_tpu.ops.psdfeatures`` on
the same float64 half spectra (noise, two lines and a pulse, made with
numpy from a seed) at 1e-9, and peak indices exactly;
``utils/freq.cleanup_freq_ranges`` and ``get_ind_freq_ranges`` against
``detprocess_tpu.utils.freq`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.ops import psdfeatures as jps
from detprocess_tpu.utils import freq as jfreq
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import psdfeatures as tps
from detprocess_tpu_torch.utils import freq as tfreq

torch.set_num_threads(1)

FS = 1.25e6
NB = 6
RTOL = 1e-9


def _spectra(n, seed=3):
    """Half spectra [NB, n//2+1] of noise, a 25 kHz and a 40 kHz line of
    random phase and a pulse, with numpy's and the port's transform."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = rng.standard_normal((NB, n)) * 1e-7
    x += 5e-7 * np.sin(2 * np.pi * 25e3 * t + rng.uniform(0, 6, (NB, 1)))
    x += 2e-7 * np.sin(2 * np.pi * 40e3 * t + 0.3)
    x[:, n // 3:] += 1e-6 * np.exp(-np.arange(n - n // 3) / 80.0)
    return tfft.rfft(torch.as_tensor(x)), jnp.asarray(np.fft.rfft(x))


F_LIMS = [
    [[45, 65], [1000, 10000]],
    [[10e3, 50e3]],
    [[50e3, 10e3], 30e3, [10000, 50000], [0.4, 0.6]],
    [20e3],
    5e3,
]


@pytest.mark.parametrize("f_lims", F_LIMS)
@pytest.mark.parametrize("n", [2048, 3001])
def test_freq_ranges_match_jax(f_lims, n):
    got = tfreq.cleanup_freq_ranges(f_lims)
    want = jfreq.cleanup_freq_ranges(f_lims)
    assert got == want
    freqs = tfreq.folded_freqs(n, FS)
    np.testing.assert_array_equal(
        freqs, np.abs(np.fft.fftfreq(n, 1 / FS)[: n // 2 + 1])[1:])
    assert (tfreq.get_ind_freq_ranges(got[0], freqs)
            == jfreq.get_ind_freq_ranges(want[0], freqs))


def test_freq_range_outside_bounds_refused_as_jax():
    freqs = np.array([0.0])
    for fn in (tfreq.get_ind_freq_ranges, jfreq.get_ind_freq_ranges):
        with pytest.raises(ValueError, match="too narrow"):
            fn([[1.0, 2.0]], freqs)


@pytest.mark.parametrize("n", [2048, 4096, 3001])
def test_psd_amp_matches_jax(n):
    vt, vj = _spectra(n)
    freqs = tfreq.folded_freqs(n, FS)
    ranges, _ = tfreq.cleanup_freq_ranges([[45, 65], [1000, 10000],
                                           [10e3, 50e3], 600e3])
    ind = tfreq.get_ind_freq_ranges(ranges, freqs)
    np.testing.assert_allclose(tps.psd_amp_half(vt, FS, n, ind).numpy(),
                               np.asarray(jps.psd_amp_half(vj, FS, n, ind)),
                               rtol=RTOL)
    asd_t, dc_t = tps.event_psd_folded_half(vt, FS, n)
    asd_j, dc_j = jps.event_psd_folded_half(vj, FS, n)
    np.testing.assert_allclose(asd_t.numpy(), np.asarray(asd_j), rtol=RTOL)
    np.testing.assert_allclose(dc_t.numpy(), np.asarray(dc_j), rtol=RTOL)


PEAK_CASES = [  # (band in Hz, npeaks, min separation in Hz)
    ((10e3, 50e3), 3, 100.0),
    ((10e3, 50e3), 2, 20e3),
    ((24.9e3, 25.1e3), 4, 0.0),
    ((100.0, 100.0), 1, 0.0),       # one bin: no local maximum, fallback
    ((0.0, 600e3), 5, 1000.0),
]


@pytest.mark.parametrize("band_hz,npeaks,min_sep", PEAK_CASES)
@pytest.mark.parametrize("n", [2048, 3001])
def test_psd_peaks_match_jax(band_hz, npeaks, min_sep, n):
    vt, vj = _spectra(n)
    freqs = tfreq.folded_freqs(n, FS)
    band = tps.band_mask(freqs, list(band_hz))
    dist = int(np.ceil(min_sep / (FS / n))) if min_sep > 0 else 0
    ft, at, dct = tps.psd_peaks_half(vt, FS, n, band, npeaks, dist)
    fj, aj, dcj = jps.psd_peaks_half(vj, FS, n, band, npeaks, dist)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=RTOL)
    np.testing.assert_allclose(dct.numpy(), np.asarray(dcj), rtol=RTOL)
    asd, _ = tps.event_psd_folded_half(vt, FS, n)
    it, vt_ = tps.find_peaks_topk(asd, band, npeaks, dist)
    ij, vj_ = jps.find_peaks_topk(jnp.asarray(asd.numpy()),
                                  jnp.asarray(band), npeaks, dist)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt_.numpy(), np.asarray(vj_))


def test_find_peaks_fills_missing_peaks_with_the_sentinel():
    y = torch.zeros((2, 16), dtype=torch.float64)
    y[:, 5] = 1.0
    band = np.zeros(16, bool)
    band[3:8] = True
    idx, val = tps.find_peaks_topk(y, band, 3, 10)
    np.testing.assert_array_equal(idx.numpy(), [[5, -1, -1]] * 2)
    np.testing.assert_array_equal(val.numpy(),
                                  [[1.0, tps.SENTINEL, tps.SENTINEL]] * 2)
    assert tps.SENTINEL == jps.SENTINEL


@pytest.mark.parametrize("pretrigger,threshold", [(0, 0.0), (512, 0.0),
                                                  (1000, 0.3), (1537, 0.9)])
@pytest.mark.parametrize("n", [2048, 3001])
def test_phase_at_peaks_matches_jax(pretrigger, threshold, n):
    vt, vj = _spectra(n, seed=4)
    freqs = tfreq.folded_freqs(n, FS)
    band = tps.band_mask(freqs, [10e3, 50e3])
    dist = int(np.ceil(2000.0 / (FS / n)))
    ft, pt = tps.phase_at_peaks_half(vt, FS, n, band, 3, dist,
                                     pretrigger=pretrigger,
                                     threshold_factor=threshold)
    fj, pj = jps.phase_at_peaks_half(vj, FS, n, band, 3, dist,
                                     pretrigger=pretrigger,
                                     threshold_factor=threshold)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=RTOL,
                               atol=1e-12)
    if threshold > 0.5:
        assert (pt.numpy() == tps.SENTINEL).any()


def test_phase_factor_is_exact_in_float32():
    # N = 32768, pretrigger N/2: the factor is ±1 at every bin, so the
    # phase of a float32 spectrum is its own angle or that plus π
    n, p = 32768, 16384
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    vr = tfft.rfft(x)
    freqs = tfreq.folded_freqs(n, FS)
    band = tps.band_mask(freqs, [10e3, 50e3])
    _, ph = tps.phase_at_peaks_half(vr, FS, n, band, 4, 0, pretrigger=p)
    asd, _ = tps.event_psd_folded_half(vr, FS, n)
    idx, _ = tps.find_peaks_topk(asd, band, 4, 0)
    k = idx + 1
    ang = torch.angle(torch.gather(vr, -1, k))
    want = torch.angle(torch.polar(torch.ones_like(ang), ang + np.pi * (k % 2)))
    np.testing.assert_allclose(ph.numpy(), want.numpy(), atol=1e-6)
