"""The comparison that decides ``correct``: what the timed path returned
against the plain reference, as a few numbers, each held to its limit.

Feature rows (each sampled row of a pass against the reference's
features of the event that belongs at that position), by family:

- ``amp``: |Δ amplitude| / max(|reference|, the fit's σ);
- ``chi2``: |Δ| / |reference| of χ², lowchi2 and chi2nopulse;
- ``res``: |Δ| / |reference| of ampres and timeres;
- ``stats``: |Δ| of baseline, integral, maximum and minimum over the
  window's rms (times its length / fs for the integral);
- ``psd``: |Δ| / |reference| of band amplitudes, peak amplitudes and
  the DC amplitude, and each peak's gap: the reference's density at the
  program's peak below the reference's peak of that rank, as a share of
  it; ``phase``: |Δ| in radians;
- ``t0``: |Δ| of an interpolated delay, in samples;
- ``rftau``: a fit's error is how much worse the program's pulse-shape
  fit is than the reference's converged one (with the program's rise and
  fall times and the best amplitude and t0, the cost above the
  reference's, as a share of it) or how far the program's chisq and
  amplitude lie from that fit's; the number is the worst sampled fit's;
- ``t0_gap``: the reference's Δχ² at the program's delay (or delay
  pair), below its best within the fit's window, as a share of the
  best.

Trigger tables (each sampled event's rows against the reference's
triggers of that event, channel by channel; a program trigger matches
the reference trigger whose group holds its index):

- ``index_gap``: for a matched trigger, the reference's Δχ² at the
  program's index below its group's maximum, as a share of it;
- ``dchi2``: |Δ| / |reference| at the program's index; a trigger in one
  table only counts the least error of the program's Δχ² that it implies:
  one of the program's alone, where the reference's Δχ² v lies below the
  threshold, (threshold − v) / v (infinite where v reaches it); one of
  the reference's alone, (its maximum − threshold) / its maximum;
- ``amp``: |Δ| / |reference| at the program's index;
- ``grouping``: rows whose triggers are all matched but that group them
  otherwise, or name another primary trigger, than the reference's rows.

A missing row, column or value counts as infinitely wrong.
"""

from __future__ import annotations

import math

import numpy as np

TRIGGER_NUMBERS = ("index_gap", "dchi2", "amp", "grouping")


def _worst(err) -> float:
    err = np.asarray(err, np.float64)
    if err.size == 0:
        return 0.0
    err = np.where(np.isnan(err), math.inf, err)
    return float(err.max())


def _gap_name(col: str) -> str:
    """Where a pick's gap counts: a spectral peak's with the PSD features
    (a peak picked wrong reads as a density off its best), a delay's as
    ``t0_gap``."""
    return "psd" if "_freq_" in col else "t0_gap"


def feature_numbers(got: dict, ref) -> dict:
    """The numbers of sampled rows: ``got`` {column: [R]} as returned,
    ``ref`` the reference's :class:`reference.features.Table` of the same
    events, evaluated at the program's picks. Each family's worst
    |Δ|/scale (phases: the wrapped |Δ| in radians) and the worst gap of
    the picks."""
    out = {}
    for col, r in ref.values.items():
        fam = ref.family.get(col)
        if fam is None:
            # a pick: the program has to return it
            name = _gap_name(col)
            out[name] = max(out.get(name, 0.0),
                            0.0 if col in got else math.inf)
            continue
        g = np.asarray(got.get(col, np.full(len(r), np.nan)), np.float64)
        if fam == "phase":
            err = np.abs(np.angle(np.exp(1j * (g - r))))
        else:
            err = np.abs(g - r) / ref.scale[col]
        out[fam] = max(out.get(fam, 0.0), _worst(err))
    for col, gap in ref.gaps.items():
        name = "rftau" if col.startswith("rftau_") else _gap_name(col)
        out[name] = max(out.get(name, 0.0), _worst(gap))
    return out


def table_event(table: dict, sel: np.ndarray, channels) -> tuple:
    """One event's triggers and rows from a returned trigger table, rows
    ``sel``: ({channel: [(index, Δχ², amplitude)]}, [row dict])."""
    found, members = {}, [dict() for _ in range(int(sel.sum()))]
    for ch in channels:
        key = f"trigger_index_{ch}"
        if key not in table:
            found[ch] = []
            continue
        idx = np.asarray(table[key], np.float64)[sel]
        d = np.asarray(table[f"trigger_delta_chi2_{ch}"], np.float64)[sel]
        a = np.asarray(table[f"trigger_amplitude_{ch}"], np.float64)[sel]
        ok = np.isfinite(idx)
        found[ch] = [(int(i), float(dd), float(aa))
                     for i, dd, aa in zip(idx[ok], d[ok], a[ok])]
        for r in np.flatnonzero(ok):
            members[r][ch] = int(idx[r])
    chan = np.asarray(table["trigger_channel"])[sel] if sel.any() else []
    index = np.asarray(table["trigger_index"])[sel] if sel.any() else []
    rows = [{"channel": str(c), "index": int(i), "members": m}
            for c, i, m in zip(chan, index, members)]
    return found, rows


def trigger_numbers(found: dict, rows: list, ref_found: dict,
                    ref_rows: list, series: dict, thresholds: dict) -> dict:
    """The numbers of one event: ``found``/``rows`` as returned (from
    :func:`table_event`, or the control's), ``ref_*`` and ``series`` the
    reference's :func:`reference.triggers.event_triggers`."""
    out = {name: 0.0 for name in TRIGGER_NUMBERS}
    ident = {}                    # (channel, returned index) → reference id
    for ch, ref in ref_found.items():
        thr = thresholds[ch]
        d1, d2, amp = series[ch]
        used = [False] * len(ref)
        mine = found.get(ch, [])
        # a trigger at the reference's index matches it; the others match
        # the first free reference trigger whose group holds them
        at = {t["index"]: j for j, t in enumerate(ref)}
        hits = [at.get(i) for i, _, _ in mine]
        for j in hits:
            if j is not None:
                used[j] = True
        for k, (i, _, _) in enumerate(mine):
            if hits[k] is None:
                hits[k] = next((j for j, t in enumerate(ref) if not used[j]
                                and t["first"] <= i <= t["last"]), None)
                if hits[k] is not None:
                    used[hits[k]] = True
        for (i, d, a), hit in zip(mine, hits):
            if hit is None:
                vals = [float(s[i]) for s in (d1, d2) if s is not None]
                out["dchi2"] = max(out["dchi2"], min(
                    (thr - v) / v if 0 < v < thr else math.inf
                    for v in vals))
                continue
            t = ref[hit]
            ident[(ch, i)] = (ch, t["index"])
            s = float((d1 if t["pass"] == 1 else d2)[i])
            ra = float(amp[i])
            out["index_gap"] = max(out["index_gap"], (t["max"] - s) / t["max"])
            out["dchi2"] = max(out["dchi2"], _worst(abs(d - s) / abs(s)))
            out["amp"] = max(out["amp"], _worst(abs(a - ra) / abs(ra)))
        for j, t in enumerate(ref):
            if not used[j]:
                out["dchi2"] = max(out["dchi2"],
                                   (t["max"] - thr) / t["max"])
    ref_sets = {(r["channel"], r["index"], frozenset(r["members"].items()))
                for r in ref_rows}
    for r in rows:
        keys = [(ch, i) for ch, i in r["members"].items()]
        if not all(k in ident for k in keys):
            continue
        mapped = frozenset(ident[k] for k in keys)
        primary = ident.get((r["channel"], r["index"]))
        if primary is None or (primary[0], primary[1], mapped) not in ref_sets:
            out["grouping"] += 1
    return out


def combine(parts: list) -> dict:
    """The worst of each number over parts (``grouping`` adds up)."""
    out = {}
    for nums in parts:
        for k, v in nums.items():
            out[k] = (out.get(k, 0.0) + v if k == "grouping"
                      else max(out.get(k, 0.0), v))
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at most its
    limit; a number without a limit fails."""
    lines, ok = [], True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = lim is not None and value <= lim
        ok = ok and good
        lines.append((name, value, lim))
    return ok, lines
