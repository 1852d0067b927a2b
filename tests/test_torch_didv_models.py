"""The port's dIdV models, fits and derived quantities against the JAX
package (``detprocess_tpu/models/didv.py``), in float64 on the CPU.

- the 1/2/3-pole models and ``didv_model``; the closed-form Jacobian of
  the fits against ``torch.func.jacfwd`` of the residuals;
- ``guess_params``; ``fit_didv`` at each pole count and
  ``fit_didv_prior`` against the JAX fits on synthetic dIdV data (each
  pole count's own model, with 1 % noise); ``fit_didv_many`` against
  one ``fit_didv`` a data set; JAX's choice among guesses;
- ``smallsignal_with_errors``, ``didv_falltimes``, ``biasparams_ilg``,
  ``dpdi_with_uncertainties`` and ``energy_resolution`` on the same fit;
- an analytic golden, without JAX: the fit of exact Irwin–Hilton data
  recovers the hand-picked working point of
  tests/test_golden_fits_analytic.py, and the falltimes its pole formula.

Tolerances: 1e-6 relative for the LM parameters and costs (the port's
step is JAX's, with a closed-form Jacobian and a batched solve; converged
fits agree far below that); 1e-9 for everything computed the same way
(models, guesses, Jacobians and the errors derived from them, falltimes,
dPdI); the chosen guess exactly.
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from detprocess_tpu.models import didv as jdidv
from detprocess_tpu_torch.models import didv

torch.set_num_threads(1)

FIT_RTOL = 1e-6
RTOL = 1e-9
FREQS = np.arange(1, 400, 2) * 100.0          # 200 odd harmonics of 100 Hz
TRUTH = {
    1: np.array([0.309, 2e-6]),
    2: np.array([0.12, -0.148, -1.1e-4, 3.3e-6]),
    3: np.array([0.12, -0.148, 0.3, -1.1e-4, 3.3e-6, 3e-4]),
}
R0, RL, I0, RSH = 0.1, 9e-3, 3.2e-6, 5e-3


def _data(poles, seed=0):
    rng = np.random.default_rng(seed)
    d = didv.didv_model(TRUTH[poles], FREQS, poles).numpy()
    noise = 0.01 * np.abs(d) * (rng.standard_normal(len(d))
                                + 1j * rng.standard_normal(len(d)))
    weights = 1.0 / (0.01 * np.abs(d))
    return d + noise, weights


@pytest.fixture(scope="module")
def fits():
    """One JAX and one port fit a pole count (and the prior fit)."""
    out = {}
    for poles in (1, 2, 3):
        d, w = _data(poles)
        out[poles] = (jdidv.fit_didv(FREQS, d, poles, weights=w),
                      didv.fit_didv(FREQS, d, poles, weights=w))
    d, w = _data(2, seed=1)
    cov = np.diag((0.05 * TRUTH[2]) ** 2)
    out["prior"] = (
        jdidv.fit_didv_prior(FREQS, d, TRUTH[2] * 1.02, cov, 2, weights=w),
        didv.fit_didv_prior(FREQS, d, TRUTH[2] * 1.02, cov, 2, weights=w))
    return out


@pytest.mark.parametrize("poles", [1, 2, 3])
def test_models(poles):
    p = TRUTH[poles]
    got = getattr(didv, f"dvdi_{poles}pole")(torch.as_tensor(p),
                                             torch.as_tensor(FREQS))
    want = np.asarray(getattr(jdidv, f"dvdi_{poles}pole")(p, FREQS))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(didv.didv_model(p, FREQS, poles).numpy(),
                               np.asarray(jdidv.didv_model(p, FREQS, poles)),
                               rtol=RTOL)


@pytest.mark.parametrize("poles", [1, 2, 3])
def test_closed_form_jacobian(poles):
    d, w = _data(poles)
    rng = np.random.default_rng(poles)
    params = torch.as_tensor(TRUTH[poles] * (1 + 0.1 * rng.standard_normal(
        (3, len(TRUTH[poles])))))
    args = [torch.as_tensor(a).expand(3, -1) for a in
            (FREQS, d.real, d.imag, w)]
    want = vmap(jacfwd(didv._didv_residual(poles)))(params, *args)
    got = didv.didv_jacobian(poles)(params, *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize("poles", [1, 2, 3])
def test_guess_params(poles):
    d, _ = _data(poles)
    got = didv.guess_params(FREQS, d, poles)
    want = jdidv.guess_params(FREQS, d, poles)
    assert len(got) == len(want)
    for g, h in zip(got, want):
        np.testing.assert_allclose(g, h, rtol=RTOL)


@pytest.mark.parametrize("poles", [1, 2, 3, "prior"])
def test_fit_matches_jax(fits, poles):
    want, got = fits[poles]
    assert got.poles == want.poles
    np.testing.assert_allclose(got.params, want.params, rtol=FIT_RTOL)
    np.testing.assert_allclose(got.cost, want.cost, rtol=FIT_RTOL)
    np.testing.assert_allclose(got.cov, want.cov, rtol=FIT_RTOL,
                               atol=FIT_RTOL * np.abs(want.cov).max())
    if poles != "prior":
        np.testing.assert_allclose(got.params, TRUTH[poles], rtol=0.2)


def test_fit_many_is_one_fit_a_data_set():
    sets = [(FREQS, *_data(2, seed=s)) for s in (3, 4, 5)]
    many = didv.fit_didv_many(sets, poles=2)
    for (f, d, w), fit in zip(sets, many):
        one = didv.fit_didv(f, d, 2, weights=w)
        np.testing.assert_array_equal(fit.params, one.params)
        assert fit.cost == one.cost


def test_choice_keeps_the_first_lowest_cost():
    assert didv.first_lowest([3.0, 1.0, 1.0, 2.0]) == 1
    assert didv.first_lowest([1.0, 1.0]) == 0
    assert didv.first_lowest([np.nan, 0.5]) == 0      # JAX keeps a NaN first
    assert didv.first_lowest([0.5, np.nan, 0.2]) == 2


@pytest.mark.parametrize("poles", [1, 2, 3])
def test_smallsignal_with_errors(fits, poles):
    fit = fits[poles][0]                       # both sides on JAX's fit
    got = didv.smallsignal_with_errors(didv.DIDVFit(*fit), R0, RL)
    want = jdidv.smallsignal_with_errors(fit, R0, RL)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("poles", [1, 2, 3])
def test_falltimes_and_ilg(fits, poles):
    fit = fits[poles][0]
    np.testing.assert_allclose(didv.didv_falltimes(fit),
                               jdidv.didv_falltimes(fit), rtol=RTOL)
    got = didv.biasparams_ilg(fit.params, RL, RSH, 100e-6, poles)
    want = jdidv.biasparams_ilg(fit.params, RL, RSH, 100e-6, poles)
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("poles", [2, 3])
def test_dpdi_with_uncertainties_and_energy_resolution(fits, poles):
    fit = fits[poles][0]
    n, fs = 4096, 1.25e6
    freqs = np.fft.fftfreq(n, 1 / fs)
    dpdi, err = didv.dpdi_with_uncertainties(fit, freqs, I0, R0, RL)
    jd, jerr = jdidv.dpdi_with_uncertainties(fit, freqs, I0, R0, RL)
    np.testing.assert_allclose(dpdi, jd, rtol=RTOL)
    np.testing.assert_allclose(err, jerr, rtol=RTOL)
    t = np.arange(n) / fs
    tmpl = np.where(t >= t[n // 2], np.exp(-(t - t[n // 2]) / 2e-4)
                    - np.exp(-(t - t[n // 2]) / 2e-5), 0.0)
    tmpl /= tmpl.max()
    psd = 1e-22 * (1 + 1e3 / (np.abs(freqs) + 1.0))
    np.testing.assert_allclose(
        didv.energy_resolution(tmpl, psd, dpdi, fs),
        jdidv.energy_resolution(tmpl, psd, jd, fs), rtol=RTOL)


def test_dpdi_needs_two_or_three_poles(fits):
    with pytest.raises(ValueError, match="2- or 3-pole"):
        didv.dpdi_with_uncertainties(fits[1][0], FREQS, I0, R0, RL)


# -- the analytic golden (no JAX) -------------------------------------------

G_R0, G_RL, G_BETA, G_LOOP, G_IND, G_TAU0 = (0.125, 0.03125, 2.0, 10.0,
                                             2.5e-7, 1e-3)


def _ih_impedance(freqs):
    """Z_circ(ω) of Irwin & Hilton eq. 2.33-2.34, written out here."""
    w = 2j * np.pi * np.asarray(freqs)
    tau_i = G_TAU0 / (1.0 - G_LOOP)
    z_tes = (G_R0 * (1.0 + G_BETA) + G_R0 * G_LOOP * (2.0 + G_BETA)
             / ((1.0 - G_LOOP) * (1.0 + w * tau_i)))
    return G_RL + w * G_IND + z_tes


def test_golden_fit_recovers_the_working_point():
    freqs = np.linspace(10.0, 5e4, 200)
    fit = didv.fit_didv(freqs, 1.0 / _ih_impedance(freqs), poles=2)
    ssp = didv.smallsignal_with_errors(fit, G_R0, G_RL)
    for key, want in (("beta", G_BETA), ("l", G_LOOP), ("L", G_IND),
                      ("tau0", G_TAU0)):
        np.testing.assert_allclose(ssp[key], want, rtol=1e-6, err_msg=key)
    # the poles of IH eq. 2.42-2.44
    tau_el = G_IND / (G_RL + G_R0 * (1.0 + G_BETA))
    tau_i = G_TAU0 / (1.0 - G_LOOP)
    mean = 0.5 * (1.0 / tau_el + 1.0 / tau_i)
    disc = np.sqrt((1.0 / tau_el - 1.0 / tau_i) ** 2
                   - 4 * G_R0 * G_LOOP * (2 + G_BETA) / (G_IND * G_TAU0))
    want = np.sort(np.abs([1.0 / (mean + 0.5 * disc),
                           1.0 / (mean - 0.5 * disc)]))
    np.testing.assert_allclose(didv.didv_falltimes(fit)[:2], want,
                               rtol=1e-6)
