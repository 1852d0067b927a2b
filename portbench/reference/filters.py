"""Templates, noise PSDs and optimal-filter banks, from a configuration.

Plain float64 numpy, written from the matched-filter formulas (two-sided
PSD J in A²/Hz, unnormalised FFTs): denom_k = 1 / (N·fs·J_k), zero at DC;
phi_k = conj(s̃_k)·denom_k; norm = Σ_k Re(phi_k·s̃_k) = 1/σ_A². The
harness hands the same templates and PSDs to the program (as its filter
data) and to the reference, which builds its filters from them here.
"""

from __future__ import annotations

import numpy as np


def two_pole(fs: float, n: int, pretrigger: int, tau_r: float,
             tau_f: float) -> np.ndarray:
    """exp(−t'/τ_f) − exp(−t'/τ_r) for t' = t − pretrigger/fs ≥ 0, zero
    before, scaled to unit peak."""
    t = np.arange(n) / fs - pretrigger / fs
    tp = np.maximum(t, 0.0)
    p = np.where(t >= 0, np.exp(-tp / tau_f) - np.exp(-tp / tau_r), 0.0)
    return p / np.max(np.abs(p))


def channel_templates(config: dict, n: int, pretrigger: int) -> np.ndarray:
    """The configuration's pulse shape of each channel [C, n]."""
    pulse = config["pulse"]
    if pulse["kind"] != "two_pole":
        raise ValueError(f"unknown pulse kind {pulse['kind']!r}")
    fs = config["sample_rate_hz"]
    return np.stack([two_pole(fs, n, pretrigger, pulse["tau_r_s"], tf)
                     for tf in pulse["tau_f_s"]])


def channel_psds(config: dict, n: int) -> np.ndarray:
    """Each channel's two-sided noise PSD [C, n] on the n-point grid:
    white·(1 + knee/|f|)·scale, |f| at DC taken as the first bin's."""
    psd = config["psd"]
    if psd["kind"] != "one_over_f":
        raise ValueError(f"unknown PSD kind {psd['kind']!r}")
    f = np.abs(np.fft.fftfreq(n, 1.0 / config["sample_rate_hz"]))
    f[0] = f[1]
    base = psd["white_a2_per_hz"] * (1.0 + psd["knee_hz"] / f)
    return np.stack([s * base for s in psd["scale"]])


def adc_conversion(config: dict) -> np.ndarray:
    """Amperes a stored code, each channel: volts a bit / close-loop norm."""
    return config["adc_volts_per_bit"] / np.asarray(config["close_loop_norm"],
                                                     np.float64)


def compound(templates: np.ndarray, psds: np.ndarray):
    """A summed channel's template (the sum, unit peak) and PSD (the sum)."""
    t = templates.sum(axis=0)
    return t / t.max(), psds.sum(axis=0)


class Bank:
    """One channel's optimal filter on the full n-point spectrum."""

    def __init__(self, template: np.ndarray, psd: np.ndarray, fs: float):
        self.n = len(template)
        self.fs = float(fs)
        self.s = np.fft.fft(template)
        with np.errstate(divide="ignore"):
            denom = 1.0 / (self.n * fs * np.asarray(psd, np.float64))
        denom[~np.isfinite(denom)] = 0.0
        denom[0] = 0.0
        self.denom = denom
        self.phi = np.conj(self.s) * denom
        self.norm = float(np.real(np.sum(self.phi * self.s)))

    @property
    def resolution(self) -> float:
        """σ_A = 1/sqrt(norm)."""
        return 1.0 / np.sqrt(self.norm)

    def matched_filter(self) -> np.ndarray:
        """h [n] with q = Σ_s x[s]·h[s] the amplitude numerator of a
        window x: h[s] = Re Σ_k phi_k·e^{−2πiks/n}."""
        return np.real(np.fft.fft(self.phi))

    def response(self) -> np.ndarray:
        """q of a unit template shifted by lag d, d = −(n−1) … n−1."""
        r = np.real(np.fft.ifft(self.phi * self.s)) * self.n
        return np.concatenate([r[-(self.n - 1):], r])


def named_shape(config: dict, spec: dict, n: int, pretrigger: int):
    """A traffic's named pulse shape [n]: a two-pole of ``tau_r_s`` and
    ``tau_f_s`` (or ``tau_r_samples``, ``tau_f_samples``), unit peak,
    times ``scale``."""
    fs = config["sample_rate_hz"]
    if "tau_r_s" in spec:
        tr, tf = spec["tau_r_s"], spec["tau_f_s"]
    else:
        tr, tf = spec["tau_r_samples"] / fs, spec["tau_f_samples"] / fs
    return spec.get("scale", 1.0) * two_pole(fs, n, pretrigger, tr, tf)


def filter_template(config: dict, traffic: dict, names, n: int,
                    pretrigger: int) -> np.ndarray:
    """A filter entry's template: a name gives [n], nested lists [C][M]
    of names give [C, M, n]."""
    if isinstance(names, str):
        return named_shape(config, traffic["templates"][names], n,
                           pretrigger)
    return np.stack([np.stack([filter_template(config, traffic, m, n,
                                               pretrigger) for m in row])
                     for row in names])


def channel_csd(config: dict, traffic: dict, channel: str,
                n: int) -> np.ndarray:
    """The two-sided CSD [C, C, n] of channels ``a|b|…``: each channel's
    PSD on the diagonal, and for a pair the traffic's
    ``noise_correlation`` (b = rho·a delayed lag_samples, plus its own
    part) off it."""
    chans = channel.split("|")
    rows = [config["channels"].index(c) for c in chans]
    psd = channel_psds(config, n)[rows]
    csd = np.zeros((len(rows), len(rows), n), complex)
    for i in range(len(rows)):
        csd[i, i] = psd[i]
    for corr in traffic.get("noise_correlation", []):
        if corr["channel"] in chans and corr["with"] in chans:
            b, a = chans.index(corr["channel"]), chans.index(corr["with"])
            ph = np.exp(-2j * np.pi * np.fft.fftfreq(n) * corr["lag_samples"])
            csd[b, a] = corr["rho"] * np.sqrt(psd[a] * psd[b]) * ph
            csd[a, b] = np.conj(csd[b, a])
    return csd


def line_frequency(config: dict, line: dict, n: int) -> float:
    """A line's frequency, moved to the nearest bin of the n-point grid."""
    fs = config["sample_rate_hz"]
    return round(line["freq_hz"] * n / fs) * fs / n
