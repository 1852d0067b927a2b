"""Plain reference of the feature table of triggered events, one row per
event, for the algorithms of a processing config.

Optimal-filter fits and trace statistics, from their formulas (full
n-point spectra, float64 by default):

- no-delay fit: q = Re Σ_k phi_k·ṽ_k, amp = q/norm, χ² = χ²₀ − q²/norm
  with χ²₀ = Σ_k |ṽ_k|²·denom_k;
- delay fit: q(d) = n·Re ifft(phi·ṽ)(d) rolled by the pretrigger, so that
  index i is the delay i − pretrigger; Δχ²(i) = q(i)²/norm, the best i
  over the allowed window, t0 = (i − pretrigger)/fs; a constrained fit
  allows [pretrigger + int(µs_min·fs·1e-6), pretrigger + int(µs_max·fs
  ·1e-6)], both ends included; its chi2nopulse is χ²₀, ampres 1/√norm,
  timeres 1/√(amp²·Σ_k ω_k²|s̃_k|²·denom_k);
- with ``interpolate``, the parabola through Δχ² at the best i and its
  neighbours (i ± 1 mod n) moves the delay by δ = (y₋ − y₊)/(2(y₋ − 2y₀
  + y₊)) (y = −Δχ²; 0 where flat, within ±1), t0 = (i + δ −
  pretrigger)/fs, χ² = χ²₀ less the parabola's apex, and amp the
  quadratic through q(i ± 1)/norm and q(i)/norm at δ;
- lowchi2: Σ_k |ṽ_k − amp·s̃_k·e^{−2πik·shift/n}|²·denom_k (k signed) over
  0 < |f_k| < 10 kHz;
- baseline, integral (trapezoid / fs), maximum and minimum over the
  window [lo, hi) (hi defaults to n − 1);
- the joint, NxM, PSD and pulse-shape fits of :mod:`reference.fits`.

A compound channel ``a+b`` is the sum of its channels' traces, with the
summed template (unit peak) and summed PSD; ``a-b`` is a's trace less b's;
each channel weighed by the block's ``weight_<channel>`` (1 without);
``a|b`` stacks the channels for an NxM fit. Templates named by ``template_tag`` are the traffic's
``filters``.

Where a fit picks (a delay, a delay pair, a spectral peak), the program's
pick, handed in as its row (``given``), is where the reference evaluates
the fit, and a gap says how far the reference's figure of merit there
lies below its own best, as a share of the best (infinite for a pick the
fit may not make). A joint fit returns its Δ but not its first delay:
there the pick is the delay (or delay pair) of that Δ whose amplitudes
come nearest the program's. Each column comes with its family and the
scale its error is measured against (:func:`features`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import filters, fits
from reference.precision import Arith

LOWCHI2_FCUT = 10000.0
OF_ALGORITHMS = ("of1x1_nodelay", "of1x1_unconstrained", "of1x1_constrained")
STAT_ALGORITHMS = ("baseline", "integral", "maximum", "minimum")
OTHER_ALGORITHMS = ("of1x2x2", "ofnxm", "ofnxmx2", "psd_amp", "psd_peaks",
                    "phase", "rftau")


def window_indices(n: int, pre: int, fs: float, kw: dict):
    """(lo, hi) of a window given from the trigger in µs; defaults 0 and
    n − 1."""
    lo, hi = 0, n - 1
    if kw.get("window_min_from_trig_usec") is not None:
        lo = pre + int(kw["window_min_from_trig_usec"] * fs * 1e-6)
    if kw.get("window_max_from_trig_usec") is not None:
        hi = pre + int(kw["window_max_from_trig_usec"] * fs * 1e-6)
    return max(0, min(lo, n - 1)), max(0, min(hi, n - 1))


class Table:
    """The reference's columns: values, families, scales, gaps."""

    def __init__(self):
        self.values, self.family, self.scale, self.gaps = {}, {}, {}, {}

    def add(self, col, value, family, scale=None):
        value = np.asarray(value, np.float64)
        self.values[col] = value
        self.family[col] = family
        self.scale[col] = (np.abs(value) if scale is None
                           else np.broadcast_to(np.asarray(scale, np.float64),
                                                value.shape))

    def gap(self, name, value):
        self.gaps[name] = np.asarray(value, np.float64)


def channel_filter(config, traffic, channel, tag, n, pre):
    """(template, PSD) of a channel ``a`` or ``a+b`` and a template tag."""
    chans = config["channels"]
    tmpl = filters.channel_templates(config, n, pre)
    psd = filters.channel_psds(config, n)
    rows = [chans.index(c) for c in channel.split("+")]
    if tag not in (None, "default"):
        entry = next(e for e in traffic["filters"]
                     if e["channel"] == channel and e["tag"] == tag)
        return (filters.filter_template(config, traffic, entry["templates"],
                                        n, pre), psd[rows].sum(axis=0))
    if len(rows) > 1:
        if channel not in traffic.get("compound_filters", []):
            raise ValueError(f"no filter for compound {channel!r}")
        return filters.compound(tmpl[rows], psd[rows])
    return tmpl[rows[0]], psd[rows[0]]


def combination(name: str, block: dict, chans: list):
    """(rows, weights) of a channel ``a``, ``a+b`` or ``a-b``: each
    channel's sign times its ``weight_<channel>`` in ``block``."""
    if "-" in name:
        parts = name.split("-")
        signs = [1.0] + [-1.0] * (len(parts) - 1)
    else:
        parts = name.split("+")
        signs = [1.0] * len(parts)
    return ([chans.index(c) for c in parts],
            [s * float(block.get(f"weight_{c}", 1.0))
             for s, c in zip(signs, parts)])


def specs(processing: dict):
    """[(channel, algorithm, base, kwargs)] of a processing config,
    channel lists expanded. A later block for a channel replaces what an
    earlier one gave it (detprocess's rule: ``Mv2301,Mv2302`` and then
    ``Mv2301`` leave Mv2301 the second block's algorithms alone)."""
    blocks = {}
    for key, algos in processing["feature"].items():
        if not isinstance(algos, dict):
            continue
        names = [key] if any(c in key for c in "+-|") else key.split(",")
        for name in names:
            blocks[name] = algos
    out = []
    for name, algos in blocks.items():
        for algo, kw in algos.items():
            if not isinstance(kw, dict) or not kw.get("run"):
                continue
            base = kw.get("base_algorithm", algo)
            if base not in OF_ALGORITHMS + STAT_ALGORITHMS \
                    + OTHER_ALGORITHMS:
                raise ValueError(f"no reference for {base!r}")
            if (kw.get("interpolate") and base not in OF_ALGORITHMS[1:]) \
                    or kw.get("interpolate_t0") or \
                    kw.get("lowchi2_fcutoff", LOWCHI2_FCUT) != LOWCHI2_FCUT:
                raise ValueError(f"{algo}: only the default options")
            out.append((name, algo, base, kw))
    return out


def features(codes: np.ndarray, config: dict, traffic: dict, device,
             precision: str = "float64", given: dict | None = None):
    """The reference's :class:`Table` of raw codes [R, C, N]; ``given``
    the program's columns of the same rows, whose picks it evaluates."""
    ar = Arith(precision)
    fs = config["sample_rate_hz"]
    n, pre = config["nb_samples"], config["nb_pretrigger_samples"]
    chans = config["channels"]
    conv = filters.adc_conversion(config)
    x_all = ar.r(torch.as_tensor(codes, device=device).to(ar.real)
                 * ar.put(conv, device)[:, None])
    given = given or {}
    out = Table()
    spectra = {}

    blocks = traffic["processing"]["feature"]

    def trace(name):
        block = blocks.get(name)
        rows, weights = combination(
            name, block if isinstance(block, dict) else {}, chans)
        if weights == [1.0] * len(rows):
            return ar.r(x_all[:, rows].sum(dim=1))
        w = ar.put(np.asarray(weights), device)
        return ar.r((x_all[:, rows] * w[:, None]).sum(dim=1))

    def spectrum(name):
        if name not in spectra:
            spectra[name] = ar.r(torch.fft.fft(trace(name)))
        return spectra[name]

    for name, algo, base, kw in specs(traffic["processing"]):
        col = f"{algo}_{name}"
        if base in OF_ALGORITHMS:
            of1x1(ar, out, spectrum(name), config, traffic, name, algo, base,
                  kw, given, device)
        elif base in STAT_ALGORITHMS:
            x = trace(name)
            lo, hi = window_indices(n, pre, fs, kw)
            w = x[:, lo:hi]
            if base == "baseline":
                v = w.mean(-1)
            elif base == "integral":
                v = (w.sum(-1) - 0.5 * (w[:, 0] + w[:, -1])) / fs
            elif base == "maximum":
                v = w.amax(-1)
            else:
                v = w.amin(-1)
            # judged against the window's rms (times its length / fs for
            # the integral)
            rms = w.to(torch.float64).square().mean(-1).sqrt()
            scale = rms * ((hi - lo) / fs if base == "integral" else 1.0)
            out.add(col, v.to(torch.float64).cpu().numpy(), "stats",
                    scale.cpu().numpy())
        elif base == "of1x2x2":
            t1, psd = channel_filter(config, traffic, name,
                                     kw["template_tag_1"], n, pre)
            t2, _ = channel_filter(config, traffic, name,
                                   kw["template_tag_2"], n, pre)
            b1, b2 = filters.Bank(t1, psd, fs), filters.Bank(t2, psd, fs)
            lo = int(round(kw["delta_window_min_usec"] * 1e-6 * fs))
            hi = int(round(kw["delta_window_max_usec"] * 1e-6 * fs))
            key = f"time_diff_{col}"
            names = (f"scintillation_amp_{col}", f"evaporation_amp_{col}")
            pick = amps = None
            if key in given and all(a in given for a in names):
                pick = np.rint(np.asarray(given[key]) * fs).astype(np.int64)
                amps = np.stack([np.asarray(given[a]) for a in names], -1)
            r = fits.of1x2x2(ar, spectrum(name), b1, b2,
                             np.arange(lo, hi + 1), fs, device, pick, amps)
            out.add(f"scintillation_amp_{col}", r["amp1"], "amp",
                    np.maximum(np.abs(r["amp1"]), b1.resolution))
            out.add(f"evaporation_amp_{col}", r["amp2"], "amp",
                    np.maximum(np.abs(r["amp2"]), b2.resolution))
            out.values[key] = r["time_diff"]
            if "gap" in r:
                out.gap(key, r["gap"])
        elif base in ("ofnxm", "ofnxmx2"):
            parts = name.split("|")
            entry = next(e for e in traffic["filters"]
                         if e["channel"] == name
                         and e["tag"] == kw["template_tag"])
            tmpl = filters.filter_template(config, traffic,
                                           entry["templates"], n, pre)
            bank = fits.NxMBank(tmpl, filters.channel_csd(
                config, traffic, name, n), fs,
                kw.get("ignored_frequency_peaks"))
            v = torch.stack([spectrum(c) for c in parts], dim=1)
            names = kw.get("amplitude_names") or [
                f"amp{i + 1}" for i in range(bank.m)]
            res = np.sqrt(np.diag(bank.iw))
            if base == "ofnxm":
                key = f"t0_{algo}_constrained_{name}"
                pick = (np.rint(np.asarray(given[key]) * fs).astype(np.int64)
                        + pre if key in given else None)
                r = fits.ofnxm(ar, v, bank, pre, window_indices(n, pre, fs,
                                                                kw),
                               fs, device, pick)
                for i, an in enumerate(names):
                    for kind, amps in (("constrained", r["amps"]),
                                       ("nodelay", r["amps_nodelay"])):
                        out.add(f"{an}_{algo}_{kind}_{name}", amps[:, i],
                                "amp", np.maximum(np.abs(amps[:, i]),
                                                  res[i]))
                out.add(f"chi2_{algo}_constrained_{name}", r["chi2"], "chi2")
                out.add(f"chi2_{algo}_nodelay_{name}", r["chi2_nodelay"],
                        "chi2")
                out.values[key] = r["t0"]
            else:
                key = f"delta_t_{col}"
                cols = [f"{an}_{col}" for an in names]
                pick = amps = None
                if key in given and all(a in given for a in cols):
                    pick = np.rint(np.asarray(given[key]) * fs).astype(
                        np.int64)
                    amps = np.stack([np.asarray(given[a]) for a in cols], -1)
                r = fits.ofnxmx2(ar, v, bank, pre, kw["template_group_ids"],
                                 kw["fit_window"], fs, device, pick, amps)
                for i, an in enumerate(names):
                    out.add(f"{an}_{col}", r["amps"][:, i], "amp",
                            np.maximum(np.abs(r["amps"][:, i]), res[i]))
                out.add(f"chi2_{col}", r["chi2"], "chi2")
                out.values[key] = r["delta_t"]
            if "gap" in r:
                out.gap(key, r["gap"])
        elif base in ("psd_amp", "psd_peaks", "phase"):
            psd_features(ar, out, spectrum(name), config, name, algo, base,
                         kw, given)
        elif base == "rftau":
            rtau0 = float(kw.get("rtau") or 30.0)
            ftau0 = float(kw.get("ftau") or 100.0)
            keys = ("risetime", "falltime", "amplitud", "chisq")
            if all(f"{k}_{col}" in given for k in keys):
                x = torch.as_tensor(codes[:, chans.index(name)], device=device
                                    ).to(torch.float64) * float(
                                        conv[chans.index(name)])
                out.gap(f"rftau_{col}", fits.rftau_judge(
                    x, fs, rtau0, ftau0,
                    {k: np.asarray(given[f"{k}_{col}"]) for k in keys},
                    device))
            r = fits.rftau(ar, trace(name), fs, rtau0, ftau0)
            for k in keys:
                out.values[f"{k}_{col}"] = r[k]
    return out


def of1x1(ar, out, v, config, traffic, name, algo, base, kw, given, device):
    fs = config["sample_rate_hz"]
    n, pre = config["nb_samples"], config["nb_pretrigger_samples"]
    tmpl, psd = channel_filter(config, traffic, name, kw.get("template_tag"),
                               n, pre)
    bank = filters.Bank(tmpl, psd, fs)
    phi = ar.put(bank.phi, device, True)
    s = ar.put(bank.s, device, True)
    denom = ar.put(bank.denom, device)
    norm = float(bank.norm) if ar.precision == "float64" else float(
        ar.put(bank.norm, "cpu"))
    f = np.fft.fftfreq(n, 1.0 / fs)
    low = torch.as_tensor((np.abs(f) < LOWCHI2_FCUT) & (f != 0),
                          device=device)
    # signed bins: a shift by a part of a sample keeps the spectrum real
    k = torch.as_tensor(np.fft.fftfreq(n) * n, device=device, dtype=ar.real)
    c0 = ar.r(((v.real ** 2 + v.imag ** 2) * denom).sum(-1))
    col = f"{algo}_{name}"
    res = bank.resolution

    def lowchi2(amp, shift):
        phase = torch.polar(torch.ones_like(k), -2 * math.pi * k
                            * shift[:, None] / n)
        resid = ar.r(v - amp[:, None] * ar.r(s * phase))
        return ar.r(((resid.real ** 2 + resid.imag ** 2) * denom
                     * low).sum(-1))

    def host(t):
        return t.to(torch.float64).cpu().numpy()

    if base == "of1x1_nodelay":
        q = ar.r((phi * v).real.sum(-1))
        amp = q / norm
        out.add(f"amp_{col}", host(amp), "amp",
                np.maximum(np.abs(host(amp)), res))
        out.add(f"chi2_{col}", host(c0 - q * q / norm), "chi2")
        out.add(f"lowchi2_{col}", host(lowchi2(amp, torch.zeros_like(amp))),
                "chi2")
        return
    qd = torch.roll(ar.r(torch.fft.ifft(ar.r(phi * v)).real * n), pre,
                    dims=-1)
    d = ar.r(qd * qd / norm)
    allowed = torch.ones(n, dtype=torch.bool, device=device)
    if base == "of1x1_constrained":
        lo, hi = window_indices(n, pre, fs, kw)
        allowed[:] = False
        allowed[lo:hi + 1] = True
    best = torch.where(allowed, d, -math.inf).max(-1)
    key = f"t0_{col}"
    interp = bool(kw.get("interpolate"))

    def take(t, i):
        return t.gather(-1, (i % n)[:, None])[:, 0]

    def refit(i):
        """(amp, χ², shift in samples) of the fit at index i."""
        qb = take(qd, i)
        amp = qb / norm
        if not interp:
            return amp, c0 - qb * qb / norm, (i - pre).to(ar.real)
        ym, y0, yp = -take(d, i - 1), -take(d, i), -take(d, i + 1)
        den = ar.r(ym - 2 * y0 + yp)
        curved = den.abs() > 0
        delta = torch.where(curved, ar.r(0.5 * (ym - yp) / torch.where(
            curved, den, torch.ones_like(den))), torch.zeros_like(den))
        delta = delta.clamp(-1.0, 1.0)
        am, ap = take(qd, i - 1) / norm, take(qd, i + 1) / norm
        return (ar.r(amp + 0.5 * (ap - am) * delta
                     + 0.5 * (am - 2 * amp + ap) * delta * delta),
                ar.r(c0 + ar.r(y0 - 0.25 * (ym - yp) * delta)),
                ar.r((i - pre).to(ar.real) + delta))

    idx = best.indices
    if key in given:
        t0 = torch.as_tensor(np.asarray(given[key]) * fs, device=device)
        p = torch.round(t0).long() + pre
        if interp and f"amp_{col}" in given:
            # the apex lies within half a sample of the pick; at a tie of
            # two samples' Δχ² it lies halfway and either can be the pick:
            # then take the one whose amplitude comes nearest the program's
            g = torch.as_tensor(np.asarray(given[f"amp_{col}"]),
                                device=device)
            lo = torch.floor(t0).long() + pre
            (a_lo, _, s_lo), (a_hi, _, s_hi) = refit(lo), refit(lo + 1)
            # a pick is a local maximum: its apex within half a sample
            on_lo = ((s_lo - t0).abs() < 0.01) & (
                (s_lo - (lo - pre)).abs() <= 0.501)
            on_hi = ((s_hi - t0).abs() < 0.01) & (
                (s_hi - (lo + 1 - pre)).abs() <= 0.501)
            hi = torch.where(on_lo == on_hi,
                             torch.where(on_lo, (a_hi - g).abs()
                                         < (a_lo - g).abs(),
                                         (s_hi - t0).abs()
                                         < (s_lo - t0).abs()), on_hi)
            p = torch.where(hi, lo + 1, lo)
        pc = p.clamp(0, n - 1)
        at = d.gather(-1, pc[:, None])[:, 0]
        inside = allowed[pc] & (p >= 0) & (p < n)
        out.gap(key, host(torch.where(inside, (best.values - at)
                                      / best.values, math.inf)))
        idx = pc
    amp, chi2, shift = refit(idx)
    out.add(f"amp_{col}", host(amp), "amp", np.maximum(np.abs(host(amp)),
                                                       res))
    if interp:
        # the sub-sample delay, in samples
        out.add(key, host(shift / fs), "t0", np.full(amp.shape[0], 1.0 / fs))
    else:
        out.values[key] = host(shift / fs)
    out.add(f"chi2_{col}", host(chi2), "chi2")
    out.add(f"lowchi2_{col}", host(lowchi2(amp, shift)), "chi2")
    if base == "of1x1_constrained":
        omega2 = ar.put((2 * math.pi * f) ** 2, device)
        curv = ar.r((omega2 * (s.real ** 2 + s.imag ** 2) * denom).sum())
        out.add(f"chi2nopulse_{col}", host(c0), "chi2")
        out.add(f"ampres_{col}", np.full(amp.shape[0], 1.0 / math.sqrt(norm)),
                "res")
        out.add(f"timeres_{col}", host(1.0 / torch.sqrt(amp * amp * curv)),
                "res")


def psd_features(ar, out, v, config, name, algo, base, kw, given):
    fs = config["sample_rate_hz"]
    n, pre = config["nb_samples"], config["nb_pretrigger_samples"]
    asd, dc = fits.folded_asd(ar, v, fs)
    asd_h = asd.to(torch.float64).cpu().numpy()
    freqs = fits.folded_freqs(n, fs)
    ranges, names = fits.freq_ranges(kw.get("f_lims", []))
    if base == "psd_amp":
        for rng, rn in zip(ranges, names):
            lo, hi = fits.index_range(rng, freqs)
            out.add(f"{algo}_{rn}_{name}", asd_h[:, lo:hi].mean(-1), "psd")
        return
    npeaks = int(kw.get("npeaks", 1))
    sep = float(kw.get("min_separation_hz", 0.0))
    dist = int(np.ceil(sep / (fs / n))) if sep > 0 else 0
    if base == "psd_peaks":
        out.add(f"{algo}_dc_amp_{name}", dc.to(torch.float64).cpu().numpy(),
                "psd")
    for rng, rn in zip(ranges, names):
        band = fits.band(freqs, rng)
        ref = [fits.peaks(asd[r], band, npeaks, dist) for r in
               range(asd.shape[0])]
        for i in range(npeaks):
            fcol = f"{algo}_{rn}_freq_{i + 1}_{name}"
            ref_bin = np.array([b[i] for b, _ in ref])
            ref_val = np.array([vv[i] for _, vv in ref])
            if fcol in given:
                f_prog = np.asarray(given[fcol], np.float64)
                bins = np.rint(f_prog * n / fs).astype(np.int64) - 1
                ok = (bins >= 0) & (bins < asd_h.shape[1])
                safe = np.where(ok, bins, 0)
                inband = ok & band[safe]
                at = asd_h[np.arange(len(safe)), safe]
                gap = np.where(inband, np.maximum(ref_val - at, 0.0)
                               / np.where(np.isfinite(ref_val), ref_val, 1.0),
                               np.where(ref_bin < 0, 0.0, math.inf))
                out.gap(fcol, gap)
            else:
                safe = np.maximum(ref_bin, 0)
                at = asd_h[np.arange(len(safe)), safe]
            out.values[fcol] = (safe + 1) * (fs / n)
            if base == "psd_peaks":
                out.add(f"{algo}_{rn}_amp_{i + 1}_{name}", at, "psd")
            else:
                out.add(f"{algo}_{rn}_phase_{i + 1}_{name}",
                        fits.phase_at(ar, v, safe, pre), "phase",
                        np.ones(len(safe)))
