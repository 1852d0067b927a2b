"""dIdV complex-admittance models, fits, and the TES quantities derived
from them.

Port of ``detprocess_tpu/models/didv.py``, the replacement of the QETpy
dIdV stack the reference delegates to (qetpy.DIDV, didvinitfromdata,
converttotesvalues, get_biasparams_ilg, get_dPdI_with_uncertainties,
energy_resolution; reference call sites detprocess/core/didv.py:489-904):

- the models ``dvdi_1pole``/``dvdi_2pole``/``dvdi_3pole`` :53-70 and
  ``didv_model`` :74, on torch tensors;
- ``fit_didv`` :186 and ``fit_didv_prior`` :100 on ``ops/lm``;
  ``guess_params`` :142 (host numpy);
- ``smallsignal_from_fit`` :232 and ``smallsignal_with_errors`` :253 (the
  Jacobian of the stacked parameter vector by ``torch.func.jacfwd``);
- ``didv_falltimes`` :273 (``np.roots``), ``biasparams_ilg`` :313;
- ``dpdi_from_fit`` :340, ``dpdi_with_uncertainties`` :358,
  ``energy_resolution`` :391, ``convert_template_to_power`` :376 and
  ``energy_normalization`` :422 (host numpy).

Every fit and derivative runs on the CPU in float64, as the JAX package
pins them there (its ``jax.default_device(cpu)``; docs/DESIGN.md §5): a
fit is a few thousand residuals and at most six parameters, too small to
feed the GPU, and its conditioning wants float64. The trace work that
feeds the fits (cuts, period folding, spectra) runs on the caller's
device in ``ops/lockin.py``.

Model (Irwin–Hilton small-signal TES theory, one- and two-block thermal):

    dVdI₁(ω) = A·(1 + iωτ₂)
    dVdI₂(ω) = A·(1 + iωτ₂) + B/(1 + iωτ₁)
    dVdI₃(ω) = A·(1 + iωτ₂) + B/(1 + iωτ₁ − C/(1 + iωτ₃))

with, for a known R0 and Rl = Rsh + Rp,

    A  = Rl + R0(1+β)          τ₂ = L/A
    B  = R0·l·(2+β)/(1−l)      τ₁ = τ₀/(1−l)

so β = (A−Rl)/R0 − 1, l = B/(B + R0(2+β)), L = A·τ₂, τ₀ = τ₁(1−l); the
3-pole C and τ₃ are reported as they are (gratio and tau3). The power to
current responsivity of the same system is

    dPdI(ω) = −I0·R0(2+β)·[1 + A(1+iωτ₂)·D(ω)/B]
    D₂(ω) = 1+iωτ₁,    D₃(ω) = 1+iωτ₁ − C/(1+iωτ₃)

and the baseline energy resolution σ_E = [∫ 4|p̃(f)|²/S_P(f) df]^(−1/2)
with the power-domain template p̃ = s̃·dPdI and S_P = S_I·|dPdI|².

``fit_didv`` runs all its starting guesses, and :func:`fit_didv_many`
those of several data sets, as one ``ops/lm.batched_lm`` call; the
problems are independent, so each result is what the JAX loop over
guesses gives, and the choice keeps JAX's rule: the lowest cost, the
first guess on a tie.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd

from detprocess_tpu_torch.ops import lm

KB = 1.380649e-23  # J/K
DTYPE = torch.float64
CPU = torch.device("cpu")


def _t(x) -> torch.Tensor:
    """``x`` as a float64 CPU tensor (the fits' home)."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float64)
    return torch.as_tensor(x, dtype=DTYPE, device=CPU)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def dvdi_1pole(params, freqs):
    a, tau2 = params[0], params[1]
    return a * (1 + 2j * math.pi * freqs * tau2)


def dvdi_2pole(params, freqs):
    a, b, tau1, tau2 = params[0], params[1], params[2], params[3]
    w = 2j * math.pi * freqs
    return a * (1 + w * tau2) + b / (1 + w * tau1)


def dvdi_3pole(params, freqs):
    a, b, c, tau1, tau2, tau3 = (params[0], params[1], params[2],
                                 params[3], params[4], params[5])
    w = 2j * math.pi * freqs
    return a * (1 + w * tau2) + b / (1 + w * tau1 - c / (1 + w * tau3))


DVDI_MODELS = {1: dvdi_1pole, 2: dvdi_2pole, 3: dvdi_3pole}
NPARAMS = {1: 2, 2: 4, 3: 6}


def didv_model(params, freqs, poles: int):
    """Complex dIdV(f) = 1/dVdI(f) of the ``poles`` model; tensors in,
    tensor out (numpy inputs become float64 tensors)."""
    return 1.0 / DVDI_MODELS[poles](_t(params), _t(freqs))


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

class DIDVFit(NamedTuple):
    params: np.ndarray     # raw fit params (A, B, C, τ1, τ2, τ3 subset)
    cov: np.ndarray
    cost: float
    poles: int


def _didv_residual(poles):
    """Weighted (re, im) residuals of one data set, [2·F]."""
    def residual(params, freqs, data_re, data_im, weights):
        model = 1.0 / DVDI_MODELS[poles](params, freqs)
        diff_re = (model.real - data_re) * weights
        diff_im = (model.imag - data_im) * weights
        return torch.cat([diff_re, diff_im])
    return residual


def didv_jacobian(poles):
    """The closed-form Jacobian [B, 2·F, P] of :func:`_didv_residual` for
    a batch of parameters [B, P] (``ops/lm.batched_lm``'s ``jacobian``):
    ∂(1/D)/∂p = −(∂D/∂p)/D², weighted and split into (re, im)."""
    def jacobian(params, freqs, data_re, data_im, weights):
        w = 2j * math.pi * freqs
        p = [params[:, k:k + 1] for k in range(params.shape[1])]
        if poles == 1:
            a, tau2 = p
            d_a = 1 + w * tau2
            big_d = a * d_a
            grads = [d_a, a * w]
        elif poles == 2:
            a, b, tau1, tau2 = p
            inv_u = 1 / (1 + w * tau1)
            d_a = 1 + w * tau2
            big_d = a * d_a + b * inv_u
            grads = [d_a, inv_u, -b * w * inv_u * inv_u, a * w]
        else:
            a, b, c, tau1, tau2, tau3 = p
            inv_q = 1 / (1 + w * tau3)
            inv_v = 1 / (1 + w * tau1 - c * inv_q)
            d_a = 1 + w * tau2
            big_d = a * d_a + b * inv_v
            d_v = -b * inv_v * inv_v
            grads = [d_a, inv_v, -d_v * inv_q, d_v * w, a * w,
                     d_v * c * w * inv_q * inv_q]
        m = 1 / big_d
        jac = torch.stack([-(m * m) * g for g in grads], dim=-1)
        jac = jac * weights[..., None]
        return torch.cat([jac.real, jac.imag], dim=1)
    return jacobian


def _fit_arrays(freqs, didv_meas, weights):
    """(freqs, re, im, weights) float64 tensors at the nonzero
    frequencies (DC carries the offset, handled apart)."""
    freqs = np.asarray(freqs)
    mask = freqs != 0
    d = np.asarray(didv_meas)[mask]
    w = (np.ones_like(freqs) if weights is None
         else np.asarray(weights))[mask]
    return (_t(freqs[mask]), _t(np.ascontiguousarray(d.real)),
            _t(np.ascontiguousarray(d.imag)), _t(w))


def fit_didv_prior(freqs: np.ndarray, didv_meas: np.ndarray,
                   prior_mean: np.ndarray, prior_cov: np.ndarray,
                   poles: int = 2,
                   weights: Optional[np.ndarray] = None,
                   max_iter: int = 200) -> DIDVFit:
    """Prior-constrained dIdV fit (qetpy.DIDVPriors; reference use
    core/didv.py:867-904, ``dofit_prior``): Gaussian priors on the raw
    parameters enter as extra residuals L⁻¹(p − p₀), L the Cholesky
    factor of the prior covariance, so the cost is
    χ²_data/2 + ½(p−p₀)ᵀC⁻¹(p−p₀). Starts at the prior mean."""
    prior_mean = np.asarray(prior_mean, dtype=float)
    chol = np.linalg.cholesky(np.asarray(prior_cov, dtype=float))
    chol_inv = np.linalg.inv(chol)
    base = _didv_residual(poles)

    def residual(params, f, d_re, d_im, w, mu, li):
        r = base(params, f, d_re, d_im, w)
        return torch.cat([r, li @ (params - mu)])

    f, d_re, d_im, w = _fit_arrays(freqs, didv_meas, weights)
    res = lm.levenberg_marquardt(
        residual, _t(prior_mean),
        args=(f, d_re, d_im, w, _t(prior_mean), _t(chol_inv)),
        max_iter=max_iter)
    return DIDVFit(params=res.params.numpy(), cov=res.cov.numpy(),
                   cost=float(res.cost), poles=poles)


def guess_params(freqs, didv_meas, poles: int) -> list:
    """Data-driven starting guesses (several: loop gain below and above 1
    flips the signs of B and τ₁, so the dVdI surface has distinct ETF
    regimes and needs a multi-start, as qetpy's staged guesses do)."""
    freqs = np.asarray(freqs)
    dvdi = 1.0 / np.asarray(didv_meas)
    order = np.argsort(np.abs(freqs))
    f_s = np.abs(freqs)[order]
    dv_s = dvdi[order]

    # dc value of dVdI → A + B
    dc = float(np.mean(dv_s[: max(len(f_s) // 50, 2)].real))
    # A from the mid/high-frequency real plateau (before ωτ₂ dominates)
    hi = dv_s[int(len(f_s) * 0.5): int(len(f_s) * 0.9)]
    a0 = float(np.median(hi.real)) if len(hi) else float(dv_s.real.mean())
    a0 = max(abs(a0), 1e-4)
    # τ₂ from the high-frequency imaginary slope: Im dVdI ≈ A·ωτ₂
    tail = slice(int(len(f_s) * 0.7), len(f_s))
    with np.errstate(divide="ignore", invalid="ignore"):
        tau2_est = np.median(
            dv_s[tail].imag / (2 * np.pi * f_s[tail] * a0))
    tau2_0 = float(abs(tau2_est)) if np.isfinite(tau2_est) else 1e-6
    tau2_0 = min(max(tau2_0, 1e-9), 1e-3)

    if poles == 1:
        return [np.array([a0, tau2_0]), np.array([abs(dc), tau2_0])]

    b0 = dc - a0
    tau1_scales = (1e-4, 1e-3, 1e-2)
    sign = np.sign(b0) if b0 != 0 else 1.0
    guesses = []
    for s in tau1_scales:
        if poles == 2:
            guesses.append(np.array([a0, b0, sign * s, tau2_0]))
            guesses.append(np.array([a0, -b0, -sign * s, tau2_0]))
        else:
            guesses.append(np.array([a0, b0, 0.2, sign * s, tau2_0,
                                     s / 10]))
            guesses.append(np.array([a0, b0 * 0.8, -0.2, sign * s, tau2_0,
                                     s / 10]))
    return guesses


def first_lowest(costs) -> int:
    """The index the JAX guess loop keeps: a later cost replaces the kept
    one only when strictly lower (so the first of equal costs wins, and a
    NaN never replaces nor is replaced after it is kept)."""
    best = 0
    for i in range(1, len(costs)):
        if float(costs[i]) < float(costs[best]):
            best = i
    return best


def fit_didv_many(data: Sequence[tuple], poles: int = 2,
                  guesses: Optional[Sequence] = None,
                  max_iter: int = 200) -> list:
    """One :class:`DIDVFit` for each ``(freqs, didv_meas, weights)`` of
    ``data`` (weights may be None): every (data set, starting guess) pair
    of a frequency count is one problem of a single ``ops/lm.batched_lm``
    call. ``guesses`` holds one guess list per data set (default
    :func:`guess_params` of each); each set keeps its lowest-cost fit."""
    arrays = [_fit_arrays(f, d, w) for f, d, w in data]
    if guesses is None:
        guesses = []
        for f, d, _ in data:
            f = np.asarray(f)
            mask = f != 0
            guesses.append(guess_params(f[mask], np.asarray(d)[mask],
                                        poles))
    residual = _didv_residual(poles)
    fits = [None] * len(data)
    groups: dict = {}
    for i, a in enumerate(arrays):
        groups.setdefault(a[0].shape[0], []).append(i)
    for members in groups.values():
        owner = [i for i in members for _ in guesses[i]]
        x0 = torch.stack([_t(g) for i in members for g in guesses[i]])
        args = tuple(torch.stack([arrays[i][k] for i in owner])
                     for k in range(4))
        res = lm.batched_lm(residual, x0, args, max_iter=max_iter,
                            jacobian=didv_jacobian(poles))
        start = 0
        for i in members:
            sl = slice(start, start + len(guesses[i]))
            start = sl.stop
            best = sl.start + first_lowest(res.cost[sl])
            fits[i] = DIDVFit(params=res.params[best].numpy(),
                              cov=res.cov[best].numpy(),
                              cost=float(res.cost[best]), poles=poles)
    return fits


def fit_didv(freqs: np.ndarray, didv_meas: np.ndarray,
             poles: int = 2,
             weights: Optional[np.ndarray] = None,
             guess: Optional[np.ndarray] = None,
             max_iter: int = 200) -> DIDVFit:
    """Fit the complex dIdV(f) with the ``poles`` model from ``guess`` or
    from every :func:`guess_params` start (one batched LM call). Only
    nonzero frequencies take part (qetpy DIDV convention)."""
    g = None if guess is None else [[np.asarray(guess)]]
    return fit_didv_many([(freqs, didv_meas, weights)], poles, g,
                         max_iter)[0]


# ---------------------------------------------------------------------------
# small-signal parameters
# ---------------------------------------------------------------------------

def smallsignal_from_fit(params, r0, rl, poles: int) -> dict:
    """(A, B, [C], τ1, τ2, [τ3]) → dict of small-signal parameters
    (tensors in, tensors out; differentiable)."""
    if poles == 1:
        a, tau2 = params[0], params[1]
        return {"rtot": a, "L": a * tau2}
    if poles == 2:
        a, b, tau1, tau2 = params[0], params[1], params[2], params[3]
    else:
        a, b, tau1, tau2 = params[0], params[1], params[3], params[4]
    beta = (a - rl) / r0 - 1.0
    l = b / (b + r0 * (2.0 + beta))
    ind = a * tau2
    tau0 = tau1 * (1.0 - l)
    out = {"beta": beta, "l": l, "L": ind, "tau0": tau0,
           "A": a, "B": b, "tau1": tau1, "tau2": tau2}
    if poles == 3:
        out["gratio"] = params[2]
        out["tau3"] = params[5]
    return out


def smallsignal_with_errors(fit: DIDVFit, r0: float, rl: float) -> dict:
    """Small-signal parameters and their 1σ errors, the fit covariance
    propagated through the exact Jacobian (``torch.func.jacfwd``)."""
    p = _t(fit.params)
    vals = smallsignal_from_fit(p, r0, rl, fit.poles)
    names = list(vals.keys())

    def vector_fn(q):
        d = smallsignal_from_fit(q, r0, rl, fit.poles)
        return torch.stack([d[k] for k in names])

    jac = jacfwd(vector_fn)(p).numpy()
    cov = jac @ fit.cov @ jac.T
    out = {k: float(vals[k]) for k in names}
    out.update({f"{k}_err": float(np.sqrt(max(cov[i, i], 0.0)))
                for i, k in enumerate(names)})
    out["cov"] = cov
    return out


def didv_falltimes(fit: DIDVFit) -> np.ndarray:
    """The dIdV pole time constants ("falltimes" τ₊, τ₋, τ₃, qetpy's
    convention; reference core/ivsweep.py:1845-1851 and
    process/filterprocess.py:1013-1016): the poles of dIdV(s) = 1/dVdI(s),
    s = iω, i.e. the roots of dVdI's numerator polynomial in s. 2 poles:

        dVdI·(1+sτ₁) = A τ₁τ₂ s² + A(τ₁+τ₂) s + (A+B)

    3 poles (denominator D = (1+sτ₁)(1+sτ₃) − C):

        dVdI·D = A τ₂τ₁τ₃ s³ + A(τ₁τ₃ + τ₂(τ₁+τ₃)) s²
                 + [A(τ₁+τ₃+τ₂(1−C)) + Bτ₃] s + [A(1−C) + B].

    The time constants are |1/Re s_i|, ascending (τ₊ the fastest), in a
    length-3 array padded with NaN below 3 poles."""
    p = np.asarray(fit.params, dtype=float)
    if fit.poles == 1:
        return np.array([abs(p[1]), np.nan, np.nan])
    if fit.poles == 2:
        a, b, tau1, tau2 = p
        coeffs = [a * tau1 * tau2, a * (tau1 + tau2), a + b]
    else:
        a, b, c, tau1, tau2, tau3 = p
        coeffs = [a * tau2 * tau1 * tau3,
                  a * (tau1 * tau3 + tau2 * (tau1 + tau3)),
                  a * ((tau1 + tau3) + tau2 * (1.0 - c)) + b * tau3,
                  a * (1.0 - c) + b]
    roots = np.roots(coeffs)
    with np.errstate(divide="ignore"):
        taus = np.sort(np.abs(1.0 / np.real(roots)))
    out = np.full(3, np.nan)
    out[:len(taus)] = taus
    return out


def biasparams_ilg(fit_params, rl: float, rsh: float, ibias: float,
                   poles: int = 2) -> dict:
    """The infinite-loop-gain bias point (qetpy.get_biasparams_ilg;
    reference use core/didv.py:646-744): for l → ∞, dVdI(0) → Rl − R0, so
    R0 = Rl − dVdI(0), and the bias point follows from the shunt-divided
    bias current."""
    p = np.asarray(fit_params)
    if poles == 2:
        dvdi0 = p[0] + p[1]
    elif poles == 3:
        dvdi0 = p[0] + p[1] / (1.0 - p[2])
    else:
        dvdi0 = p[0]
    r0 = rl - dvdi0
    i0 = ibias * rsh / (r0 + rl)
    v0 = i0 * r0
    p0 = i0 * v0
    return {"r0": float(r0), "i0": float(i0), "v0": float(v0),
            "p0": float(p0)}


# ---------------------------------------------------------------------------
# dPdI and energy resolution
# ---------------------------------------------------------------------------

def dpdi_from_fit(params, freqs, i0: float, r0: float, rl: float,
                  poles: int = 2):
    """dPdI(ω) of the fit parameters (module docstring); tensors in,
    complex tensor out."""
    w = 2j * math.pi * _t(freqs)
    if poles == 2:
        a, b, tau1, tau2 = params[0], params[1], params[2], params[3]
        d = 1 + w * tau1
    elif poles == 3:
        a, b, c, tau1, tau2, tau3 = (params[0], params[1], params[2],
                                     params[3], params[4], params[5])
        d = 1 + w * tau1 - c / (1 + w * tau3)
    else:
        raise ValueError("dPdI requires a 2- or 3-pole fit")
    beta = (a - rl) / r0 - 1.0
    r0_2beta = r0 * (2.0 + beta)
    return -i0 * r0_2beta * (1.0 + a * (1 + w * tau2) * d / b)


def dpdi_with_uncertainties(fit: DIDVFit, freqs, i0: float, r0: float,
                            rl: float):
    """(dPdI [complex numpy], σ|dPdI| [real numpy]): the fit covariance
    propagated through the Jacobian of |dPdI| (``torch.func.jacfwd``)."""
    f = _t(freqs)
    p = _t(fit.params)

    def mag_fn(q):
        return torch.abs(dpdi_from_fit(q, f, i0, r0, rl, fit.poles))

    dpdi = dpdi_from_fit(p, f, i0, r0, rl, fit.poles).numpy()
    jac = jacfwd(mag_fn)(p).numpy()
    var = np.einsum("fi,ij,fj->f", jac, fit.cov, jac)
    return dpdi, np.sqrt(np.clip(var, 0, None))


def convert_template_to_power(template: np.ndarray, dpdi: np.ndarray,
                              fs: float = None) -> np.ndarray:
    """Current-domain template → power-domain template: the bin-by-bin
    product of its two-sided DFT with dPdI(f), transformed back. ``dpdi``
    is tabulated on the template's two-sided frequency axis; ``fs`` is
    accepted for the qetpy signature (the DFT pair's factors cancel)."""
    s_fft = np.fft.fft(np.asarray(template))
    p_fft = s_fft * np.asarray(dpdi)
    return np.real(np.fft.ifft(p_fft))


def energy_resolution(template: np.ndarray, psd: np.ndarray,
                      dpdi: np.ndarray, fs: float) -> float:
    """Baseline optimal-filter energy resolution σ_E [J for SI inputs]
    (qetpy.utils.energy_resolution; reference use core/didv.py:798-851).
    The unit-peak current template goes to the power domain through dPdI;
    the OF amplitude resolution of the power pulse is

        σ_a = [ Σ_{k≠0} |p̃_k|² / S_P(f_k) · df ]^(−1/2)

    with p̃ the continuous FT of the power pulse and S_P = S_I·|dPdI|² the
    two-sided power-referred noise (the sum over ± frequencies equals the
    one-sided ∫4|p̃|²/S_P form); σ_E = σ_a·E₀, E₀ = ∫p dt."""
    template = np.asarray(template, dtype=float)
    n = len(template)
    df = fs / n
    dpdi = np.asarray(dpdi)
    p_fft = np.fft.fft(template) * dpdi / fs   # continuous FT of power pulse
    s_p = np.asarray(psd) * np.abs(dpdi) ** 2
    mask = np.ones(n, dtype=bool)
    mask[0] = False
    denom = np.sum(np.abs(p_fft[mask]) ** 2 / s_p[mask]) * df
    sigma_a = 1.0 / np.sqrt(denom)
    e0 = abs(energy_normalization(template, dpdi, fs))
    return float(sigma_a * e0)


def energy_normalization(template: np.ndarray, dpdi: np.ndarray,
                         fs: float) -> float:
    """Energy per unit (current) amplitude of a template: the integral of
    the power-domain template, ∫ p dt in joules."""
    power_template = convert_template_to_power(template, dpdi, fs)
    return float(np.trapezoid(power_template, dx=1.0 / fs))
