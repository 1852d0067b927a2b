"""IV-sweep bias analysis (IBIS): I0, R0 and P0 against bias, with the
offsets and errors.

A numpy copy of ``detprocess_tpu/models/ivbias.py`` (``IBISResult`` :27,
``_linfit`` :44, ``analyze_ibis`` :59, ``biasparams_from_normal_iv``
:136), the replacement of qetpy.IBIS as the reference IVSweepAnalysis
drives it (detprocess/core/ivsweep.py:401-757). Host float64: a few
weighted line fits over one value a bias point. From the measured DC
current of each bias point, the analysis

1. fits the normal branch (the first ``nnorm`` points) of imeas against
   ibias with a line: the normal resistance Rn and the SQUID current
   offset;
2. fits the superconducting branch (the last ``nsc`` points): the
   parasitic resistance Rp, given the shunt Rsh;
3. computes for each point i0 = imeas − ioffset,
   v0 = (ibias − i0)·Rsh − i0·Rp, r0 = v0/i0 and p0 = v0·i0, with
   first-order error propagation.

Circuit: the bias current divides between the shunt and the TES branch
(Rp + R0): v_shunt = (ibias − i0)·Rsh = i0·(Rp + R0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class IBISResult(NamedTuple):
    ibias: np.ndarray
    i0: np.ndarray
    i0_err: np.ndarray
    r0: np.ndarray
    r0_err: np.ndarray
    p0: np.ndarray
    p0_err: np.ndarray
    v0: np.ndarray
    rn: float
    rn_err: float
    rp: float
    rp_err: float
    ioffset: float
    ioffset_err: float


def _linfit(x, y, sigma=None):
    w = np.ones_like(x) if sigma is None else 1.0 / np.asarray(sigma) ** 2
    sw = w.sum()
    sx = (w * x).sum()
    sy = (w * y).sum()
    sxx = (w * x * x).sum()
    sxy = (w * x * y).sum()
    delta = sw * sxx - sx * sx
    slope = (sw * sxy - sx * sy) / delta
    intercept = (sxx * sy - sx * sxy) / delta
    slope_err = np.sqrt(sw / delta)
    intercept_err = np.sqrt(sxx / delta)
    return slope, intercept, slope_err, intercept_err


def analyze_ibis(
    ibias: np.ndarray,
    imeas: np.ndarray,
    rsh: float,
    nnorm: int,
    nsc: int,
    imeas_err: Optional[np.ndarray] = None,
    rp: Optional[float] = None,
    rsh_err: float = 0.0,
) -> IBISResult:
    """Run the bias analysis. ``ibias`` must be ordered from the normal
    branch (largest |bias|) to the SC branch (reference convention,
    ivsweep.py:326-399)."""
    ibias = np.asarray(ibias, dtype=float)
    imeas = np.asarray(imeas, dtype=float)
    n = len(ibias)
    if imeas_err is None:
        imeas_err = np.full(n, np.std(imeas) * 1e-3 + 1e-15)
    imeas_err = np.asarray(imeas_err, dtype=float)

    # normal branch: imeas = ibias·Rsh/(Rn+Rsh+Rp) + ioffset
    sl_n, ioffset, sl_n_err, ioffset_err = _linfit(
        ibias[:nnorm], imeas[:nnorm], imeas_err[:nnorm])

    # SC branch: imeas = ibias·Rsh/(Rsh+Rp) + ioffset_sc
    if nsc > 1:
        sl_sc, ioffset_sc, sl_sc_err, _ = _linfit(
            ibias[-nsc:], imeas[-nsc:], imeas_err[-nsc:])
        rp_fit = rsh * (1.0 / sl_sc - 1.0)
        rp_err = rsh * sl_sc_err / sl_sc**2
    else:
        if rp is None:
            raise ValueError("rp required when no SC points available")
        rp_fit, rp_err = rp, 0.0
    if rp is not None:
        # explicit value overrides (set_rp, ivsweep.py:285) — and carries
        # no fit uncertainty, so don't let a noisy SC-branch rp_err
        # contaminate rn/v0/r0/p0 errors
        rp_fit, rp_err = rp, 0.0

    rl = rsh + rp_fit
    rn = rsh / sl_n - rl
    rn_err = np.sqrt((rsh * sl_n_err / sl_n**2) ** 2 + rp_err**2)

    i0 = imeas - ioffset
    i0_err = np.sqrt(imeas_err**2 + ioffset_err**2)
    v0 = (ibias - i0) * rsh - i0 * rp_fit
    r0 = v0 / i0
    p0 = v0 * i0

    # error propagation (ibias treated as exact). v0, r0, p0 are all
    # deterministic functions of (i0, rsh, rp) — propagate through the
    # exact partials rather than treating v0 and i0 as independent
    # (the naive |r0|·sqrt((v0_err/v0)² + …) form blows up/NaNs on the
    # SC branch where v0 → 0 even though the true σ stays finite):
    #   r0 = ibias·rsh/i0 − (rsh + rp)
    #   p0 = ((ibias − i0)·rsh − i0·rp)·i0
    dv0_di0 = -(rsh + rp_fit)
    v0_err = np.sqrt((dv0_di0 * i0_err) ** 2
                     + ((ibias - i0) * rsh_err) ** 2
                     + (i0 * rp_err) ** 2)
    r0_err = np.sqrt((ibias * rsh / i0**2 * i0_err) ** 2
                     + ((ibias - i0) / i0 * rsh_err) ** 2
                     + rp_err**2)
    dp0_di0 = v0 + i0 * dv0_di0
    p0_err = np.sqrt((dp0_di0 * i0_err) ** 2
                     + ((ibias - i0) * i0 * rsh_err) ** 2
                     + (i0**2 * rp_err) ** 2)

    return IBISResult(
        ibias=ibias, i0=i0, i0_err=i0_err, r0=r0, r0_err=r0_err,
        p0=p0, p0_err=p0_err, v0=v0,
        rn=float(rn), rn_err=float(rn_err),
        rp=float(rp_fit), rp_err=float(rp_err),
        ioffset=float(ioffset), ioffset_err=float(ioffset_err))


def biasparams_from_normal_iv(norm_avs, norm_errs, trans_av, trans_err,
                              ibias_norms, ibias_trans,
                              rl: float, rsh: float,
                              rl_err: float = 0.0) -> dict:
    """Bias parameters from a handful of normal IV points plus one
    transition point (qetpy get_biasparams_normal_iv semantics; used by
    the beginning-of-run IV path, reference core/didv.py:385-485).

    Normal branch: imeas = ioffset + ibias·rsh/(rn+rl) — a weighted
    linear fit gives ioffset (intercept) and rn (from the slope).
    Transition point: i0 = imeas − ioffset,
    r0 = rsh·(ibias − i0)/i0 − rp with rp = rl − rsh, p0 = i0²·r0.
    First-order error propagation throughout.
    """
    norm_avs = np.asarray(norm_avs, float)
    ibias_norms = np.asarray(ibias_norms, float)
    norm_errs = (np.asarray(norm_errs, float)
                 if norm_errs is not None else None)
    if len(norm_avs) < 2:
        raise ValueError("need at least two normal IV points")
    slope, ioffset, slope_err, ioffset_err = _linfit(
        ibias_norms, norm_avs, sigma=norm_errs)
    rn = rsh / slope - rl
    rn_err = float(np.hypot(rsh * slope_err / slope**2, rl_err))

    i0 = float(trans_av - ioffset)
    i0_err = float(np.hypot(trans_err, ioffset_err))
    rp = rl - rsh
    r0 = rsh * (ibias_trans - i0) / i0 - rp
    dr0_di0 = -rsh * ibias_trans / i0**2
    r0_err = float(np.hypot(dr0_di0 * i0_err, rl_err))
    p0 = i0**2 * r0
    p0_err = float(abs(2 * i0 * r0 + i0**2 * dr0_di0) * i0_err)
    return {
        "i0": i0, "i0_err": i0_err,
        "r0": float(r0), "r0_err": r0_err,
        "p0": float(p0), "p0_err": p0_err,
        "rn": float(rn), "rn_err": rn_err,
        "ioffset": float(ioffset), "ioffset_err": float(ioffset_err),
        "rp": float(rp), "rshunt": float(rsh), "rl": float(rl),
        "ibias": float(ibias_trans),
    }
