"""Plain reference of the trigger table of continuous events, one event
at a time (float64 by default).

For each trigger channel of the processing config, from its template and
PSD at the trigger length Nt:

1. q(T) = Σ_s x[T − p + s]·h[s] (the matched filter of a window whose
   pretrigger sample p sits at T), zero within Nt of either end;
   Δχ²(T) = q(T)²/norm, amplitude q(T)/norm.
2. Samples with Δχ² above the threshold (σ² for one amplitude) whose
   successive gaps are at most the pileup window form a group; its
   trigger is the first sample that reaches the group's maximum.
3. With ``run_residual``: each trigger not flagged by the saturation veto
   (the trace low-passed by 1/(1 + (f/50 kHz)^4) above a saturation
   amplitude within ±Nt/4 samples) has its Δχ² response
   amp²·norm·(r(d)/norm)² subtracted, aligned on its peak at the
   trigger; step 2 on what is left finds the residual pass's triggers
   (amplitudes from q), of which those at a new index are added.
4. Triggers within the edge exclusion of either end are dropped.
5. All channels' triggers are sorted by index (channel order breaking
   ties); runs whose successive gaps are below the coincidence window
   merge into one row when their channels differ (a run holding a channel
   twice is split greedily into runs of distinct channels, and runs of
   two rows or more merge); the row's primary trigger is the one of
   largest Δχ².
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import filters
from reference.precision import Arith

SATURATION_LPF_HZ = 50e3


def trigger_channels(config: dict) -> list:
    """[(name, row, settings)] of the processing config's trigger
    channels, in its order."""
    out = []
    for name, kw in config["processing"]["trigger"].items():
        if not isinstance(kw, dict) or not kw.get("run"):
            continue
        if "|" in name or "+" in name or kw.get(
                "template_tag", "default") != "default":
            raise ValueError(f"no reference for trigger channel {name!r}")
        out.append((name, config["channels"].index(name), kw))
    return out


def merge_window(config: dict) -> int:
    ms = config["processing"]["trigger"].get("coincident_window_msec", 0)
    return int(ms * config["sample_rate_hz"] / 1000)


def groups(d: torch.Tensor, threshold: float, window: int) -> list:
    """[(first, last, trigger index, maximum)] of Δχ² series ``d`` [L]."""
    above = torch.nonzero(d > threshold)[:, 0].cpu().numpy()
    if len(above) == 0:
        return []
    vals = d[torch.as_tensor(above, device=d.device)].double().cpu().numpy()
    cut = np.flatnonzero(np.diff(above) > window) + 1
    out = []
    for a, b in zip(np.r_[0, cut], np.r_[cut, len(above)]):
        k = a + int(np.argmax(vals[a:b]))
        out.append((int(above[a]), int(above[b - 1]), int(above[k]),
                    float(vals[k])))
    return out


def dilate(mask: torch.Tensor, w: int) -> torch.Tensor:
    """Any of mask[i − w … i + w]."""
    return torch.nn.functional.max_pool1d(
        mask[None, None].float(), 2 * w + 1, 1, w)[0, 0] > 0


class Channel:
    """One trigger channel's filter, threshold and options."""

    def __init__(self, config: dict, name: str, row: int, kw: dict,
                 ar: Arith, device):
        fs = config["sample_rate_hz"]
        tt = config["trigger_template"]
        nt, pre = tt["nb_samples"], tt["nb_pretrigger_samples"]
        tmpl = filters.channel_templates(config, nt, pre)[row]
        psd = filters.channel_psds(config, nt)[row]
        bank = filters.Bank(tmpl, psd, fs)
        self.name, self.row, self.nt, self.pre, self.fs = (name, row, nt,
                                                           pre, fs)
        self.norm = bank.norm
        self.h = bank.matched_filter()
        self.response = bank.response() / bank.norm         # [2Nt − 1]
        self.threshold = float(kw.get("threshold_sigma", 5.0)) ** 2
        ms = kw.get("pileup_window_msec")
        self.window = (int(ms * fs / 1000) if ms is not None
                       else int(kw.get("pileup_window_samples", 0)))
        self.residual = bool(kw.get("run_residual", False))
        self.sat = kw.get("saturation_amplitudes")
        self.edge = kw.get("edge_exclusion_msec")
        self.ar, self.device = ar, device

    def series(self, x: torch.Tensor):
        """(Δχ² [L], amplitude [L]) of one channel's trace x [L]."""
        ar, l, nt = self.ar, x.shape[-1], self.nt
        size = 1 << math.ceil(math.log2(l + nt))
        xf = ar.r(torch.fft.rfft(x, size))
        hf = ar.r(torch.fft.rfft(ar.put(self.h, self.device), size))
        c = ar.r(torch.fft.irfft(ar.r(xf * hf.conj()), size))
        q = torch.zeros(l, dtype=ar.real, device=self.device)
        lo, hi = nt, l - nt
        q[lo:hi] = c[lo - self.pre:hi - self.pre]
        amp = ar.r(q / self.norm)
        return ar.r(q * amp), amp

    def saturated(self, x: torch.Tensor) -> torch.Tensor:
        ar, l = self.ar, x.shape[-1]
        f = torch.fft.rfftfreq(l, 1.0 / self.fs, dtype=torch.float64,
                               device=self.device)
        gain = ar.r((1.0 / (1.0 + (f / SATURATION_LPF_HZ) ** 4)).to(ar.real))
        lpf = ar.r(torch.fft.irfft(ar.r(torch.fft.rfft(x) * gain), l))
        return dilate(lpf > float(self.sat[0]), self.nt // 4)

    def subtract(self, d: torch.Tensor, amp: torch.Tensor, found: list,
                 x: torch.Tensor) -> torch.Tensor:
        """Δχ² less the response of each trigger of ``found`` that the
        saturation veto lets through."""
        ar, l = self.ar, d.shape[-1]
        shape = ar.put(self.response ** 2 * self.norm, self.device)
        peak = int(torch.argmax(shape))
        sat = self.saturated(x) if self.sat is not None else None
        sub = torch.zeros(l + 2 * len(shape), dtype=ar.real,
                          device=self.device)
        for _, _, i, _ in found:
            if sat is not None and bool(sat[i]):
                continue
            a = amp[i]
            start = i - peak + len(shape)
            sub[start:start + len(shape)] += ar.r(a * a * shape)
        return ar.r(d - sub[len(shape):len(shape) + l])


def event_triggers(codes: np.ndarray, config: dict, device,
                   precision: str = "float64"):
    """One event's triggers and rows from its codes [C, L]: ({channel:
    [trigger dict]}, [row dict], {channel: series}). A trigger has
    ``index``, ``dchi2``, ``amp``, ``pass`` (1 or 2) and its group's
    ``first``, ``last`` and ``max``; a row its ``channel``, ``index`` and
    ``members`` {channel: index}; series are (first-pass Δχ², residual
    Δχ² or None, amplitude) on ``device``."""
    ar = Arith(precision)
    fs, l = config["sample_rate_hz"], config["nb_samples"]
    conv = filters.adc_conversion(config)
    found, series = {}, {}
    for name, row, kw in trigger_channels(config):
        ch = Channel(config, name, row, kw, ar, device)
        x = ar.r(torch.as_tensor(codes[row], device=device).to(ar.real)
                 * float(conv[row]))
        d1, amp = ch.series(x)
        first = groups(d1, ch.threshold, ch.window)
        trig = [dict(index=i, dchi2=m, amp=float(amp[i]), first=f, last=e,
                     max=m, **{"pass": 1}) for f, e, i, m in first]
        d2 = None
        if ch.residual:
            d2 = ch.subtract(d1, amp, first, x)
            have = {t["index"] for t in trig}
            trig += [dict(index=i, dchi2=m, amp=float(amp[i]), first=f,
                          last=e, max=m, **{"pass": 2})
                     for f, e, i, m in groups(d2, ch.threshold, ch.window)
                     if i not in have]
        if ch.edge is not None:
            tmin = ch.edge * 1e-3
            trig = [t for t in trig
                    if tmin < t["index"] / fs < l / fs - tmin]
        found[name] = trig
        series[name] = (d1, d2, amp)
    return found, build_rows(found, merge_window(config)), series


def build_rows(found: dict, window: int) -> list:
    """The coincidence-merged rows of one event's triggers."""
    flat = [(t["index"], rank, name, t["dchi2"])
            for rank, (name, trig) in enumerate(found.items())
            for t in trig]
    flat.sort(key=lambda r: (r[0], r[1]))
    rows = [[r] for r in flat]
    if window > 0 and len(found) > 1 and len(flat) > 1:
        merged, run = [], [flat[0]]
        for r in flat[1:]:
            if r[0] - run[-1][0] < window:
                run.append(r)
            else:
                merged.extend(split_run(run))
                run = [r]
        merged.extend(split_run(run))
        rows = merged
    out = []
    for members in rows:
        primary = max(range(len(members)), key=lambda j: (members[j][3], -j))
        out.append({"channel": members[primary][2],
                    "index": members[primary][0],
                    "members": {m[2]: m[0] for m in members}})
    return out


def split_run(run: list) -> list:
    """A run's rows: one per trigger for a run of one channel; one for a
    run of distinct channels; else greedy runs of distinct channels, those
    of two or more merged."""
    chans = [r[2] for r in run]
    if len(set(chans)) == 1:
        return [[r] for r in run]
    if len(set(chans)) == len(chans):
        return [run]
    out, cur = [], []
    for r in run:
        if r[2] in {c[2] for c in cur}:
            out.extend([cur] if len(cur) > 1 else [[c] for c in cur])
            cur = []
        cur.append(r)
    out.extend([cur] if len(cur) > 1 else [[c] for c in cur])
    return out
