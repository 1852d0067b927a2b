"""The port's numpy copies against the JAX package's modules.

- ``models/tesnoise``: every noise component, dIdV, dIdP, the power
  referral and the special-state spectra, at a transition, a normal and
  an SC working point;
- ``models/ivbias``: ``analyze_ibis`` (with and without Rp, errors or SC
  points) and ``biasparams_from_normal_iv``;
- ``utils/misc.find_linear_segment`` on linear, kinked, noisy-start,
  too-short and mismatched inputs;
- ``pipelines/noisemodel``: the numpy Savitzky–Golay of order 1 against
  scipy's ``savgol_filter(..., mode="interp")``, and ``flatten_psd`` and
  ``make_decreasing`` against JAX.

The copies run the same float64 numpy code, so values agree to 1e-12
relative (exactly, in practice); index lists exactly.
"""

import jax  # noqa: F401
import numpy as np
import pytest
from scipy.signal import savgol_filter

from detprocess_tpu.models import ivbias as jivbias
from detprocess_tpu.models import tesnoise as jtesnoise
from detprocess_tpu.pipelines import noisemodel as jnoisemodel
from detprocess_tpu.utils.misc import find_linear_segment as j_find
from detprocess_tpu_torch.models import ivbias, tesnoise
from detprocess_tpu_torch.pipelines import noisemodel
from detprocess_tpu_torch.utils.misc import find_linear_segment

RTOL = 1e-12
FREQS = np.fft.fftfreq(4096, 1 / 1.25e6)[1:2048]

POINTS = {
    "transition": dict(r0=0.1, rl=9e-3, beta=2.0, l=10.0, L=4e-7,
                       tau0=1e-3, G=1.3e-10, tc=0.04, tload=0.03, tb=0.02,
                       i0=3.2e-6, squiddc=1e-11, n=5.0),
    "normal": dict(r0=0.3, rl=9e-3, beta=0.0, l=0.0, L=4e-7, tau0=1e-6,
                   G=1.3e-10, tc=0.04, tload=0.03, tb=0.02, i0=5e-6,
                   squiddc=1e-11),
    "sc": dict(r0=0.0, rl=9e-3, beta=0.0, l=0.0, L=4e-7, tau0=1e-6,
               G=1.3e-10, tc=0.04, tload=0.03, tb=0.02, i0=2e-6,
               squiddc=2e-11),
}
COMPONENTS = ("didv", "didp", "s_ites", "s_iload", "s_itfn", "s_isquid",
              "s_itot")


@pytest.mark.parametrize("point", sorted(POINTS))
@pytest.mark.parametrize("name", COMPONENTS)
def test_tesnoise_components(point, name):
    p = tesnoise.TESParams(**POINTS[point])
    jp = jtesnoise.TESParams(**POINTS[point])
    got = getattr(tesnoise, name)(p, FREQS)
    want = getattr(jtesnoise, name)(jp, FREQS)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("point", sorted(POINTS))
def test_tesnoise_power_referral_and_tfn(point):
    p = tesnoise.TESParams(**POINTS[point])
    jp = jtesnoise.TESParams(**POINTS[point])
    s_i = tesnoise.s_itot(p, FREQS)
    np.testing.assert_allclose(
        tesnoise.current_to_power(s_i, p, FREQS),
        jtesnoise.current_to_power(s_i, jp, FREQS), rtol=RTOL)
    assert tesnoise.tfn_suppression(p) == jtesnoise.tfn_suppression(jp)


def test_special_state_spectra_and_squid_noise():
    args = (0.3, 9e-3, 4e-7, 0.04, 0.03)
    np.testing.assert_allclose(tesnoise.s_i_normal(*args, 1e-11, FREQS),
                               jtesnoise.s_i_normal(*args, 1e-11, FREQS),
                               rtol=RTOL)
    np.testing.assert_allclose(
        tesnoise.s_i_sc(9e-3, 4e-7, 0.03, 1e-11, FREQS),
        jtesnoise.s_i_sc(9e-3, 4e-7, 0.03, 1e-11, FREQS), rtol=RTOL)
    psd = tesnoise.s_i_normal(*args, 1e-11, FREQS) * np.random.default_rng(
        0).uniform(0.5, 1.5, len(FREQS))
    np.testing.assert_allclose(
        tesnoise.squid_noise_from_normal(psd, *args, FREQS),
        jtesnoise.squid_noise_from_normal(psd, *args, FREQS), rtol=RTOL)


def _sweep(seed=0):
    rng = np.random.default_rng(seed)
    rsh, rp, rn = 5e-3, 4e-3, 0.3
    biases = np.array([400e-6, 350e-6, 300e-6, 120e-6, 100e-6, 80e-6,
                       4e-6, 2e-6, 1e-6])
    r0s = np.array([rn, rn, rn, 0.2, 0.15, 0.1, 0.0, 0.0, 0.0])
    imeas = biases * rsh / (r0s + rsh + rp) - 1.3e-6
    imeas = imeas + rng.standard_normal(len(imeas)) * 5e-10
    return biases, imeas, rsh


IBIS_CASES = {
    "errors given": dict(nnorm=3, nsc=3, imeas_err=np.full(9, 5e-10)),
    "default errors": dict(nnorm=3, nsc=3),
    "explicit rp": dict(nnorm=3, nsc=3, rp=4e-3, rsh_err=1e-4,
                        imeas_err=np.linspace(4e-10, 6e-10, 9)),
    "no sc points": dict(nnorm=3, nsc=0, rp=4e-3),
}


@pytest.mark.parametrize("case", sorted(IBIS_CASES))
def test_analyze_ibis(case):
    biases, imeas, rsh = _sweep()
    got = ivbias.analyze_ibis(biases, imeas, rsh, **IBIS_CASES[case])
    want = jivbias.analyze_ibis(biases, imeas, rsh, **IBIS_CASES[case])
    for field in want._fields:
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=RTOL, err_msg=field)


def test_analyze_ibis_needs_rp_without_sc_points():
    biases, imeas, rsh = _sweep()
    for mod in (ivbias, jivbias):
        with pytest.raises(ValueError, match="rp required"):
            mod.analyze_ibis(biases, imeas, rsh, nnorm=3, nsc=1)


def test_biasparams_from_normal_iv():
    args = ([5.1e-6, 4.4e-6, 3.6e-6], [1e-9, 1.2e-9, 0.9e-9], 2.1e-6, 1e-9,
            [400e-6, 350e-6, 300e-6], 100e-6)
    got = ivbias.biasparams_from_normal_iv(*args, rl=9e-3, rsh=5e-3,
                                           rl_err=1e-5)
    want = jivbias.biasparams_from_normal_iv(*args, rl=9e-3, rsh=5e-3,
                                             rl_err=1e-5)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for mod in (ivbias, jivbias):
        with pytest.raises(ValueError, match="two normal"):
            mod.biasparams_from_normal_iv([1e-6], [1e-9], *args[2:],
                                          rl=9e-3, rsh=5e-3)


x_lin = np.linspace(400e-6, 100e-6, 10)
SEGMENTS = {
    "linear": (x_lin, 2.0 * x_lin + 1e-6),
    "kinked": (x_lin, np.where(x_lin > 250e-6, 2.0 * x_lin,
                               3.0 * x_lin - 250e-6)),
    "one outlier": (x_lin, 2.0 * x_lin + np.where(
        np.arange(10) == 5, 3e-5, 0.0)),
    "last point off": (x_lin, 2.0 * x_lin + np.where(
        np.arange(10) == 9, 1e-4, 0.0)),
    "noisy start": (x_lin, 2.0 * x_lin + np.where(
        np.arange(10) == 1, 2e-6, 0.0)),
    "too short": (x_lin[:2], x_lin[:2]),
}


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_find_linear_segment(case):
    x, y = SEGMENTS[case]
    got = find_linear_segment(x, y)
    assert got == j_find(x, y)
    expect = {"linear": list(range(10)), "too short": [],
              "noisy start": []}
    if case in expect:
        assert got == expect[case]
    if case == "kinked":
        assert got and got[-1] < 9


def test_find_linear_segment_refuses_mismatched_lengths():
    for fn in (find_linear_segment, j_find):
        with pytest.raises(ValueError, match="same length"):
            fn(x_lin, x_lin[:5])


@pytest.mark.parametrize("window,n", [(3, 200), (45, 200), (45, 45),
                                      (7, 1000)])
def test_savgol_order1_is_scipys(window, n):
    y = np.cumsum(np.random.default_rng(window + n).standard_normal(n))
    np.testing.assert_allclose(noisemodel.savgol_order1(y, window),
                               savgol_filter(y, window, 1, mode="interp"),
                               rtol=1e-12, atol=1e-12 * np.abs(y).max())


def test_flatten_psd_and_make_decreasing():
    f = np.fft.fftfreq(4096, 1 / 1.25e6)
    rng = np.random.default_rng(3)
    psd = 1e-22 * (1 + 1e4 / (np.abs(f) + 10)) * rng.chisquare(8, 4096) / 8
    psd[100] *= 50                         # a line
    np.testing.assert_allclose(noisemodel.flatten_psd(f, psd),
                               jnoisemodel.flatten_psd(f, psd), rtol=1e-12)
    np.testing.assert_array_equal(noisemodel.make_decreasing(psd, f),
                                  jnoisemodel.make_decreasing(psd, f))
    np.testing.assert_array_equal(noisemodel.make_decreasing(psd),
                                  jnoisemodel.make_decreasing(psd))
    short = psd[:40]
    np.testing.assert_array_equal(noisemodel.flatten_psd(f[:40], short),
                                  short)
