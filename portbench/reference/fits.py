"""Plain reference of the joint, multichannel, spectral and pulse-shape
fits, one event at a time, written from their formulas on full n-point
spectra (float64 by default; see :mod:`reference.precision`).

- ``of1x2x2``: u_i(d) = n·Re ifft(phi_i·ṽ)(d)/√norm_i at delay d,
  c(Δ) = n·Re ifft(phi_1·s̃_2)(Δ)/√(norm_1·norm_2); at template 1's delay d
  and template 2's d + Δ, Δχ² = (u1² − 2c(−Δ)·u1·u2 + u2²)/(1 − c(−Δ)²)
  (pairs with 1 − c² ≤ 1e-6 left out), maximised over every d and the Δ
  window (the first Δ, then the first d, of the largest); amplitudes
  solve the 2×2 system there; time_diff = Δ/fs.
- NxM banks: J⁻¹ per kept bin (DC and the bins nearest each ignored
  frequency, with their mirrors, dropped), phi = conj(J⁻¹s̃)/(n·fs),
  W = Re Σ_k s̃†J⁻¹s̃/(n·fs); q_m(d) = n·Re ifft(Σ_c phi·ṽ)(d),
  χ²₀ = Σ_k Re ṽ†J⁻¹ṽ/(n·fs).
- ``ofnxm``: no-delay amplitudes W⁻¹q and χ²₀ − qᵀW⁻¹q; constrained, the
  same at the best delay of the window.
- ``ofnxmx2``: group 0 at trace index i1 of its fit window, group 1 at
  i2 of its own; P(Δ)_ij = r_ij(0) within a group, r_ij(−Δ) or r_ij(Δ)
  across, r_ij(d) = n·Re ifft(Σ_c s̃_i*·(J⁻¹s̃)_j)(d)/(n·fs), Δ = i2 − i1;
  amplitudes P⁻¹q, Δχ² = qᵀP⁻¹q maximised over the pairs (for each i1
  the first i2, then the first i1); delta_t = Δ/fs.
- PSD features: the folded amplitude spectral density
  √(|ṽ_k|²/(n·fs)·(2 but at Nyquist)) for k ≥ 1; a band's mean over
  index ranges; peaks as strict local maxima in a band (the band's bins
  when it has none), taken greedily from the largest with ±distance
  suppression; the phase of ṽ_k·e^{2πik·pretrigger/n} at a peak.
- ``rftau``: the trace low-passed by 1/(1 + (f/50 kHz)²), less its mean
  over the 800 samples before t0 = n/2 − 10; a two-pole
  amp·(e^{−t'/|τf|} − e^{−t'/|τr|}), clipped at 0, t' = t − t0 > 0, fitted
  over [t0 − 800, t0 + 1600) by Levenberg–Marquardt from (τr, τf, the
  window's maximum, t0) in 40 steps (λ from 1e-3, ×0.3 on a step that
  lowers the cost, ×10 on one that does not, within [1e-12, 1e12];
  parameters scaled by their start), as the program does. A 40-step
  fit often stops short of the minimum, so two fits in different
  arithmetic end apart: the program's fit is judged by its quality
  (:func:`rftau_judge`), against the reference's own fit run to
  convergence.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from reference.precision import Arith


RFTAU_LOWER, RFTAU_UPPER = 800, 1600
RFTAU_CUTOFF = 50e3
RFTAU_STEPS = 40


def notch_keep(n: int, fs: float, peaks) -> np.ndarray:
    keep = np.ones(n, bool)
    keep[0] = False
    freqs = np.fft.fftfreq(n, 1.0 / fs)
    for f0 in peaks or []:
        for sign in (1.0, -1.0):
            i = int(np.argmin(np.abs(freqs - sign * abs(float(f0)))))
            keep[i] = keep[(n - i) % n] = False
    return keep


class NxMBank:
    def __init__(self, templates, csd, fs, peaks=None):
        self.c, self.m, self.n = templates.shape
        n = self.n
        self.fs = fs
        self.s = np.fft.fft(templates, axis=-1)                  # [C, M, n]
        keep = notch_keep(n, fs, peaks)
        csd_f = np.moveaxis(csd, -1, 0)
        icsd = np.zeros_like(csd_f)
        icsd[keep] = np.linalg.inv(csd_f[keep])
        self.icsd = icsd                                          # [n, C, C]
        js = np.einsum("kab,bmk->kam", icsd, self.s)              # [n, C, M]
        self.phi = np.conj(np.moveaxis(js, 0, -1)) / (n * fs)     # [C, M, n]
        self.w = np.real(np.einsum("cik,kcj->ij", np.conj(self.s), js)) \
            / (n * fs)
        self.iw = np.linalg.inv(self.w)
        cross = np.einsum("cik,kcj->ijk", np.conj(self.s), js)
        self.r = np.real(np.fft.ifft(cross, axis=-1)) * n / (n * fs)


def of1x2x2(ar, v, bank1, bank2, delta_window, fs, device, pick=None,
            amps=None):
    """Rows' joint fit from spectra v [R, n]: {amp1, amp2, time_diff,
    gap}. With ``pick`` (the program's Δ in samples) and ``amps`` (its
    two amplitudes [R, 2]), the fit is evaluated at that Δ and at the
    delay d whose amplitudes come nearest the program's (its delay is
    not returned), and gap says how far Δχ² there lies below the best."""
    n = v.shape[-1]
    sq1, sq2 = math.sqrt(bank1.norm), math.sqrt(bank2.norm)
    res = np.array([bank1.resolution, bank2.resolution])
    phi1 = ar.put(bank1.phi, device, True)
    phi2 = ar.put(bank2.phi, device, True)
    u1 = ar.r(torch.fft.ifft(ar.r(phi1 * v)).real * n / sq1)
    u2 = ar.r(torch.fft.ifft(ar.r(phi2 * v)).real * n / sq2)
    c_all = ar.put(np.real(np.fft.ifft(bank1.phi * bank2.s)) * n
                   / (sq1 * sq2), device)
    signed = torch.as_tensor(delta_window, device=device)
    dl = signed % n
    cc = c_all[(n - dl) % n]                                     # [K]
    det = ar.r(1.0 - cc * cc)
    ok = det > 1e-6
    pos = torch.arange(n, device=device)
    cols = (pos[None, :] + dl[:, None]) % n                      # [K, n]
    out = {k: [] for k in ("amp1", "amp2", "time_diff", "gap")}
    for r in range(v.shape[0]):
        a, b = u1[r], u2[r][cols]                                # [n], [K, n]
        num = ar.r(a * a - 2 * cc[:, None] * a * b + b * b)
        val = torch.where(ok[:, None], num / torch.where(ok, det, 1.0)[:, None],
                          -math.inf)
        vmax, d1 = val.max(-1)                                   # [K]
        k = int(torch.argmax(vmax))
        d = int(d1[k])
        best = vmax[k]
        if pick is not None:
            hit = torch.nonzero(signed == int(pick[r]))
            if not len(hit):
                out["gap"].append(math.inf)
            else:
                k = int(hit[0, 0])
                a1 = (a - cc[k] * b[k]) / (sq1 * det[k])
                a2 = (b[k] - cc[k] * a) / (sq2 * det[k])
                miss = torch.maximum(
                    (a1 - float(amps[r, 0])).abs() / a1.abs().clamp(
                        min=res[0]),
                    (a2 - float(amps[r, 1])).abs() / a2.abs().clamp(
                        min=res[1]))
                d = int(torch.argmin(miss))
                out["gap"].append(float((best - val[k, d]) / best))
        ub1, ub2 = a[d], u2[r][(d + int(dl[k])) % n]
        c, dt = cc[k], det[k]
        out["amp1"].append(float((ub1 - c * ub2) / (sq1 * dt)))
        out["amp2"].append(float((ub2 - c * ub1) / (sq2 * dt)))
        out["time_diff"].append(int(signed[k]) / fs)
    return {k: np.asarray(v_, np.float64) for k, v_ in out.items() if v_}


def chi2_base_nxm(ar, v, bank, device):
    """χ²₀ of spectra v [R, C, n]."""
    icsd = ar.put(bank.icsd, device, True)
    tmp = ar.r(torch.einsum("kab,rbk->rak", icsd, v))
    return ar.r((v.conj() * tmp).real.sum((-2, -1)) / (bank.n * bank.fs))


def q_series(ar, v, bank, pre, device):
    """q [R, M, n] in absolute trace order."""
    phi = ar.put(bank.phi, device, True)
    prod = ar.r(torch.einsum("cmk,rck->rmk", phi, v))
    return torch.roll(ar.r(torch.fft.ifft(prod).real * bank.n), pre, dims=-1)


def ofnxm(ar, v, bank, pre, window, fs, device, pick=None):
    """{amps_nodelay [R, M], chi2_nodelay, amps [R, M], chi2, t0, gap}."""
    n = bank.n
    iw = ar.put(bank.iw, device)
    phi = ar.put(bank.phi, device, True)
    c0 = chi2_base_nxm(ar, v, bank, device)
    q0 = ar.r(torch.einsum("cmk,rck->rm", phi, v).real)
    a0 = ar.r(q0 @ iw.T)
    q = q_series(ar, v, bank, pre, device)                      # [R, M, n]
    d = ar.r(torch.einsum("rit,ij,rjt->rt", q, iw, q))
    lo, hi = window
    allowed = torch.zeros(n, dtype=torch.bool, device=device)
    allowed[lo:hi + 1] = True
    best = torch.where(allowed, d, -math.inf).max(-1)
    out = {"amps_nodelay": a0, "chi2_nodelay": ar.r(c0 - (q0 * a0).sum(-1))}
    idx = best.indices
    if pick is not None:
        p = torch.as_tensor(pick, device=device)
        inside = (p >= 0) & (p < n)
        pc = p.clamp(0, n - 1)
        at = d.gather(-1, pc[:, None])[:, 0]
        inside = inside & allowed[pc]
        out["gap"] = torch.where(inside, (best.values - at) / best.values,
                                 math.inf)
        idx = pc
    qb = q.gather(-1, idx[:, None, None].expand(-1, q.shape[1], 1))[..., 0]
    amps = ar.r(qb @ iw.T)
    out.update(amps=amps, chi2=ar.r(c0 - (qb * amps).sum(-1)),
               t0=(idx - pre).to(ar.real) / fs)
    return {k: v_.to(torch.float64).cpu().numpy() for k, v_ in out.items()}


def ofnxmx2(ar, v, bank, pre, groups, windows, fs, device, pick=None,
            amps=None):
    """{amps [R, M], chi2, delta_t, gap}. With ``pick`` (the program's
    Δ = i2 − i1 in samples) and ``amps`` (its amplitudes [R, M]), the fit
    is evaluated at the pair of that Δ whose amplitudes come nearest the
    program's (its pair is not returned), and gap says how far Δχ² there
    lies below the best."""
    n, m = bank.n, bank.m
    g = np.asarray(groups)
    i1 = np.arange(windows[0][0], windows[0][1] + 1)
    i2 = np.arange(windows[1][0], windows[1][1] + 1)
    delta = (i2[None, :] - i1[:, None]) % n                      # [W1, W2]
    p = np.empty(delta.shape + (m, m))
    for a in range(m):
        for b in range(m):
            if g[a] == g[b]:
                p[..., a, b] = bank.r[a, b, 0]
            elif g[a] < g[b]:
                p[..., a, b] = bank.r[a, b][(n - delta) % n]
            else:
                p[..., a, b] = bank.r[a, b][delta]
    ip = ar.put(np.linalg.inv(p), device)                        # [W1, W2, M, M]
    res = torch.as_tensor(np.sqrt(np.diag(bank.iw)), device=device)
    c0 = chi2_base_nxm(ar, v, bank, device)
    q = q_series(ar, v, bank, pre, device)                       # [R, M, n]
    g0 = torch.as_tensor(g == 0, device=device)
    t1 = torch.as_tensor(i1, device=device)
    t2 = torch.as_tensor(i2, device=device)
    signed = torch.as_tensor(i2[None, :] - i1[:, None], device=device)
    out = {k: [] for k in ("amps", "chi2", "delta_t", "gap")}
    for r in range(v.shape[0]):
        qp = torch.where(g0, q[r][:, t1].T[:, None, :],
                         q[r][:, t2].T[None, :, :])              # [W1, W2, M]
        am = ar.r(torch.einsum("pwij,pwj->pwi", ip, qp))
        dchi2 = ar.r((qp * am).sum(-1))                          # [W1, W2]
        v2, j2 = dchi2.max(-1)
        j1 = int(torch.argmax(v2))
        jj = int(j2[j1])
        best = v2[j1]
        if pick is not None:
            same = signed == int(pick[r])
            if bool(same.any()):
                want = torch.as_tensor(amps[r], device=device)
                miss = ((am - want).abs() / am.abs().clamp(
                    min=res.to(am.dtype))).amax(-1)
                flat = int(torch.argmin(torch.where(same, miss, math.inf)))
                j1, jj = flat // same.shape[1], flat % same.shape[1]
                out["gap"].append(float((best - dchi2[j1, jj]) / best))
                best = dchi2[j1, jj]
            else:
                out["gap"].append(math.inf)
        out["amps"].append(am[j1, jj].to(torch.float64).cpu().numpy())
        out["chi2"].append(float(c0[r] - best))
        out["delta_t"].append(int(signed[j1, jj]) / fs)
    return {k: np.asarray(v_, np.float64) for k, v_ in out.items() if v_}


def folded_asd(ar, v, fs):
    """(ASD [R, n/2] over k = 1 … n/2, DC amplitude [R])."""
    n = v.shape[-1]
    h = v[:, :n // 2 + 1]
    psd = ar.r((h.real ** 2 + h.imag ** 2) / (n * fs))
    scale = torch.full((n // 2 + 1,), 2.0, dtype=psd.dtype, device=v.device)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    folded = ar.r(psd * scale)
    return ar.r(torch.sqrt(folded[:, 1:])), ar.r(torch.sqrt(folded[:, 0]))


def freq_ranges(f_lims):
    """([[lo, hi] or [f]], names) of f_lims, duplicates dropped."""
    ranges, names = [], []
    for fr in (f_lims if isinstance(f_lims, list) else [f_lims]):
        fr = [fr] if isinstance(fr, (int, float)) else list(fr)
        lo = abs(fr[0])
        if len(fr) == 2:
            hi = abs(fr[1])
            lo, hi = min(lo, hi), max(lo, hi)
            name, rng = f"{round(lo)}_{round(hi)}", [lo, hi]
        else:
            name, rng = f"{round(lo)}", [lo]
        if name not in names:
            names.append(name)
            ranges.append(rng)
    return ranges, names


def folded_freqs(n, fs):
    return np.abs(np.fft.fftfreq(n, 1.0 / fs)[:n // 2 + 1])[1:]


def index_range(rng, freqs):
    lo = int(np.argmin(np.abs(freqs - abs(rng[0]))))
    hi = lo + 1
    if len(rng) == 2:
        hi = int(np.argmin(np.abs(freqs - abs(rng[1]))))
    lo, hi = min(lo, hi), max(lo, hi)
    if lo == hi:
        hi += 1
    return lo, hi


def band(freqs, rng):
    b = (freqs >= rng[0]) & (freqs <= (rng[1] if len(rng) == 2 else rng[0]))
    if not b.any():
        b[np.argmin(np.abs(freqs - rng[0]))] = True
    return b


def peaks(y: torch.Tensor, band_mask: np.ndarray, npeaks: int, dist: int):
    """(bins [npeaks], values [npeaks]) of one spectrum's peaks; −1 and
    −inf where there are none."""
    y = y.to(torch.float64).cpu().numpy()
    local = np.zeros(len(y), bool)
    local[1:-1] = (y[1:-1] > y[:-2]) & (y[1:-1] > y[2:])
    cand = local & band_mask
    if not cand.any():
        cand = band_mask.copy()
    work = np.where(cand, y, -np.inf)
    bins, vals = [], []
    for _ in range(npeaks):
        i = int(np.argmax(work))
        v = work[i]
        bins.append(i if np.isfinite(v) else -1)
        vals.append(v)
        work[max(0, i - dist):i + dist + 1] = -np.inf
    return np.asarray(bins), np.asarray(vals)


def phase_at(ar, v, bins, pre):
    """The phase of ṽ_k·e^{2πik·pre/n} at folded bins (k = bin + 1)."""
    n = v.shape[-1]
    k = torch.as_tensor(bins, device=v.device) + 1
    ang = (2 * math.pi / n) * ((k * (pre % n)) % n).to(torch.float64)
    vk = v.gather(-1, k[:, None])[:, 0]
    return torch.angle(vk.to(torch.complex128) * torch.polar(
        torch.ones_like(ang), ang)).cpu().numpy()


def _twopole(t, p):
    tp = t - p[3]
    pulse = p[2] * (torch.exp(-tp / p[1].abs()) - torch.exp(-tp / p[0].abs()))
    zero = torch.zeros_like(pulse)
    return torch.where(tp > 0, torch.maximum(pulse, zero), zero)


def rftau_window(ar, x, fs):
    """(t0, lw, uw, the fitted window [R, lw + uw] of traces x [R, n])."""
    n = x.shape[-1]
    t0 = n // 2 - 10
    lw, uw = min(RFTAU_LOWER, t0), min(RFTAU_UPPER, n - t0)
    f = torch.fft.rfftfreq(n, 1.0 / fs, dtype=torch.float64, device=x.device)
    gain = ar.r((1.0 / (1.0 + (f / RFTAU_CUTOFF) ** 2)).to(ar.real))
    filt = ar.r(torch.fft.irfft(ar.r(torch.fft.rfft(x) * gain), n))
    base = filt[:, t0 - lw:t0].mean(-1, keepdim=True)
    return t0, lw, uw, ar.r(filt[:, t0 - lw:t0 + uw] - base)


def rftau(ar, x, fs, rtau0, ftau0, steps=RFTAU_STEPS):
    """{risetime, falltime, amplitud, chisq, params [R, 4]} of traces x
    [R, n] after ``steps`` LM steps."""
    r_, n = x.shape
    t0, lw, uw, win = rftau_window(ar, x, fs)
    tw = torch.arange(t0 - lw, t0 + uw, dtype=ar.real, device=x.device)
    x0 = torch.stack([torch.full((r_,), rtau0, dtype=ar.real,
                                 device=x.device),
                      torch.full((r_,), ftau0, dtype=ar.real,
                                 device=x.device),
                      win.max(-1).values,
                      torch.full((r_,), float(t0), dtype=ar.real,
                                 device=x.device)], -1)
    scale = torch.where(x0.abs() > 1e-30, x0.abs(), torch.ones_like(x0))

    def resid(y, s, data):
        return ar.r(_twopole(tw, y * s) - data)

    res, jac = vmap(resid), vmap(jacfwd(resid))
    y = x0 / scale
    lam = torch.full((r_,), 1e-3, dtype=ar.real, device=x.device)
    r = res(y, scale, win)
    cost = 0.5 * (r * r).sum(-1)
    jm = jac(y, scale, win)
    eye = torch.eye(4, dtype=ar.real, device=x.device)
    for _ in range(steps):
        g = torch.einsum("brp,br->bp", jm, r)
        h = jm.transpose(-1, -2) @ jm
        damped = h + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(h, dim1=-2, dim2=-1).clamp(min=1e-14))
        step = torch.linalg.solve_ex(damped + 1e-30 * eye,
                                     -g[..., None])[0][..., 0]
        y_new = ar.r(y + step)
        r_new = res(y_new, scale, win)
        c_new = 0.5 * (r_new * r_new).sum(-1)
        better = (c_new < cost) & torch.isfinite(y_new).all(-1)
        y = torch.where(better[:, None], y_new, y)
        r = torch.where(better[:, None], r_new, r)
        cost = torch.where(better, c_new, cost)
        lam = torch.where(better, lam * 0.3, lam * 10.0).clamp(1e-12, 1e12)
        jm = jac(y, scale, win)
    p = y * scale
    tf = torch.arange(n, dtype=ar.real, device=x.device)
    fitted = vmap(lambda q: _twopole(tf, q))(p)
    out = {"risetime": p[:, 0].abs(), "falltime": p[:, 1].abs(),
           "amplitud": fitted.max(-1).values,
           "chisq": 2.0 * cost / (lw + uw), "params": p}
    return {k: v.to(torch.float64).cpu().numpy() for k, v in out.items()}


RFTAU_JUDGE_STEPS = 200     # the reference's own fit, run to convergence
RFTAU_T0_SPAN = 5.0         # samples either side of the reference's t0
RFTAU_T0_STEP = 0.02


def rftau_judge(x, fs, rtau0, ftau0, got: dict, device, block=16):
    """How good the program's pulse-shape fit is, a row: with its rise
    and fall times, the best amplitude (least squares) and t0 (a grid of
    RFTAU_T0_STEP samples around the reference's own t0) give a cost;
    the worst of (that cost − the reference's converged cost) / the
    reference's cost, and the relative gaps of the program's chisq and
    amplitude to that fit's. float64, ``x`` [R, n] in amperes."""
    ar = Arith("float64")
    best = rftau(ar, x, fs, rtau0, ftau0, RFTAU_JUDGE_STEPS)
    t0c, lw, uw, win = rftau_window(ar, x, fs)
    tw = torch.arange(t0c - lw, t0c + uw, dtype=torch.float64, device=device)
    tf = torch.arange(x.shape[-1], dtype=torch.float64, device=device)
    grid = torch.arange(-RFTAU_T0_SPAN, RFTAU_T0_SPAN + 1e-9, RFTAU_T0_STEP,
                        dtype=torch.float64, device=device)
    out = []
    for lo in range(0, x.shape[0], block):
        sl = slice(lo, lo + block)
        rise = torch.as_tensor(got["risetime"][sl], device=device)
        fall = torch.as_tensor(got["falltime"][sl], device=device)
        t0 = torch.as_tensor(best["params"][sl, 3], device=device)[:, None] \
            + grid                                            # [b, G]
        tp = tw[None, None, :] - t0[..., None]                # [b, G, W]
        g = torch.where(tp > 0, torch.exp(-tp.clamp(min=0) / fall[:, None,
                                                                  None])
                        - torch.exp(-tp.clamp(min=0) / rise[:, None, None]),
                        0.0)
        y = win[sl][:, None, :]
        a = (g * y).sum(-1) / (g * g).sum(-1).clamp(min=1e-300)
        resid = torch.clamp(a[..., None] * g, min=0.0) - y
        cost = 0.5 * (resid * resid).sum(-1)                  # [b, G]
        c, k = cost.min(-1)
        ref = torch.as_tensor(best["chisq"][sl], device=device) \
            * (lw + uw) / 2.0
        gap = ((c - ref) / ref).clamp(min=0.0)
        chisq = 2.0 * c / (lw + uw)
        prog_chisq = torch.as_tensor(got["chisq"][sl], device=device)
        t0b = t0.gather(-1, k[:, None])[:, 0]
        ab = a.gather(-1, k[:, None])[:, 0]
        tpf = tf[None, :] - t0b[:, None]
        pulse = torch.where(tpf > 0, ab[:, None] * (
            torch.exp(-tpf.clamp(min=0) / fall[:, None])
            - torch.exp(-tpf.clamp(min=0) / rise[:, None])), 0.0)
        amp = pulse.clamp(min=0.0).max(-1).values
        prog_amp = torch.as_tensor(got["amplitud"][sl], device=device)
        out.append(torch.stack([
            gap, (prog_chisq - chisq).abs() / chisq,
            (prog_amp - amp).abs() / amp.abs()]).amax(0))
    return torch.cat(out).cpu().numpy()
