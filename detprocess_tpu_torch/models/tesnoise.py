"""TES noise budget: Irwin–Hilton noise components, current- and
power-referred.

A numpy copy of ``detprocess_tpu/models/tesnoise.py`` (:35-155:
``TESParams``, ``didv``, ``didp``, ``s_ites`` … ``s_itot``,
``current_to_power``, ``s_i_normal``, ``s_i_sc``,
``squid_noise_from_normal``), the replacement of qetpy.sim.TESnoise and
get_squid_noise_from_normal_noise that the reference NoiseModel uses
(detprocess/core/noisemodel.py:354-1146). Host float64, as in the JAX
package: these are closed forms on a frequency axis, evaluated once a
bias point. All components derive from one linear system, the 2×2
electro-thermal matrix that also gives dIdV and dIdP:

    M(ω) = [[ Rl + R0(1+β) + iωL ,  lG/I0            ],
            [ −I0·R0(2+β)        ,  G(1−l) + iωC     ]]
    [δI, δT]ᵀ = M⁻¹ · [δV_loop, δP_thermal]ᵀ

Sources:
- **TES Johnson** voltage noise S_V = 4k_B·T_c·R0·(1+2β): enters the loop
  (−v) and heats the TES (+I0·v), so δI = (−[M⁻¹]₀₀ + I0·[M⁻¹]₀₁)·v;
- **load Johnson** (shunt and parasitic at T_load) S_V = 4k_B·T_load·Rl:
  loop only, δI = −[M⁻¹]₀₀·v;
- **phonon TFN** S_P = 4k_B·T_c²·G·F(T_b/T_c): thermal only,
  δI = [M⁻¹]₀₁·δP = dIdP·δP;
- **SQUID and electronics**: flat current noise added in quadrature.

``F`` is the specular-limit form F = ((T_b/T_c)^(n+1) + 1)/2 with
thermal-conductance exponent n (5 for electron-phonon).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

KB = 1.380649e-23


class TESParams(NamedTuple):
    r0: float          # TES operating resistance [Ω]
    rl: float          # load resistance Rsh + Rp [Ω]
    beta: float        # current sensitivity
    l: float           # loop gain
    L: float           # inductance [H]
    tau0: float        # C/G [s]
    G: float           # thermal conductance [W/K]
    tc: float          # TES temperature [K]
    tload: float       # load (shunt) temperature [K]
    tb: float          # bath temperature [K]
    i0: float          # bias current through the TES [A]
    squiddc: float = 0.0   # flat SQUID+electronics current noise [A/√Hz]
    n: float = 5.0     # conductance power-law exponent


def _matrix_inverse_elements(p: TESParams, freqs):
    """[M⁻¹]₀₀ (δI per loop volt) and [M⁻¹]₀₁ (δI per thermal watt)."""
    w = 2j * np.pi * np.asarray(freqs)
    c_heat = p.tau0 * p.G
    m00 = p.rl + p.r0 * (1 + p.beta) + w * p.L
    m01 = np.full_like(w, p.l * p.G / p.i0) if p.i0 != 0 else 0.0 * w
    m10 = np.full_like(w, -p.i0 * p.r0 * (2 + p.beta))
    m11 = p.G * (1 - p.l) + w * c_heat
    det = m00 * m11 - m01 * m10
    inv00 = m11 / det
    inv01 = -m01 / det
    return inv00, inv01


def didv(p: TESParams, freqs):
    """Complex dIdV(ω) of the biased TES."""
    inv00, _ = _matrix_inverse_elements(p, freqs)
    return inv00


def didp(p: TESParams, freqs):
    """Complex dIdP(ω) (power-to-current responsivity)."""
    _, inv01 = _matrix_inverse_elements(p, freqs)
    return inv01


def tfn_suppression(p: TESParams) -> float:
    """F(T_b/T_c) for the TFN (specular limit)."""
    t_ratio = p.tb / p.tc
    return ((t_ratio ** (p.n + 1)) + 1.0) / 2.0


# --- noise densities -------------------------------------------------
# Convention: every s_* below is a ONE-SIDED spectral density (the
# physical 4kTR Johnson normalization, qetpy-compatible). Two-sided
# Welch measurements must be folded (x2 on non-DC bins) before direct
# comparison — pipelines/noisemodel.py does this at every interface.


def s_ites(p: TESParams, freqs):
    """TES Johnson current noise [A²/Hz] (with electro-thermal feedback)."""
    s_v = 4.0 * KB * p.tc * p.r0 * (1.0 + 2.0 * p.beta)
    inv00, inv01 = _matrix_inverse_elements(p, freqs)
    h = -inv00 + p.i0 * inv01
    return s_v * np.abs(h) ** 2


def s_iload(p: TESParams, freqs):
    """Load (shunt+parasitic) Johnson current noise [A²/Hz]."""
    s_v = 4.0 * KB * p.tload * p.rl
    inv00, _ = _matrix_inverse_elements(p, freqs)
    return s_v * np.abs(inv00) ** 2


def s_itfn(p: TESParams, freqs):
    """Phonon thermal-fluctuation current noise [A²/Hz]."""
    s_p = 4.0 * KB * p.tc**2 * p.G * tfn_suppression(p)
    return s_p * np.abs(didp(p, freqs)) ** 2


def s_isquid(p: TESParams, freqs):
    """SQUID + electronics current noise [A²/Hz] (flat)."""
    return np.full(np.shape(freqs), p.squiddc**2)


def s_itot(p: TESParams, freqs):
    return (s_ites(p, freqs) + s_iload(p, freqs) + s_itfn(p, freqs)
            + s_isquid(p, freqs))


def current_to_power(s_i, p: TESParams, freqs):
    """Current-referred → power-referred: S_P = S_I·|dPdI|²."""
    resp = didp(p, freqs)
    return np.asarray(s_i) / np.clip(np.abs(resp) ** 2, 1e-300, None)


# ---------------------------------------------------------------------------
# special-state spectra (normal / SC), used to extract SQUID noise & Tload
# ---------------------------------------------------------------------------

def s_i_normal(rn: float, rl: float, L: float, tc: float, tload: float,
               squiddc: float, freqs):
    """Normal-state current PSD: both Johnson sources through the passive
    R+iωL loop (no ETF; noisemodel.py:_normal_noise, :1356)."""
    w = 2 * np.pi * np.asarray(freqs)
    ztot2 = (rn + rl) ** 2 + (w * L) ** 2
    return ((4 * KB * tc * rn + 4 * KB * tload * rl) / ztot2
            + squiddc**2)


def s_i_sc(rl: float, L: float, tload: float, squiddc: float, freqs):
    """Superconducting-state current PSD (noisemodel.py:_sc_noise, :1323)."""
    w = 2 * np.pi * np.asarray(freqs)
    ztot2 = rl**2 + (w * L) ** 2
    return 4 * KB * tload * rl / ztot2 + squiddc**2


def squid_noise_from_normal(psd_normal, rn, rl, L, tc, tload, freqs):
    """Flat SQUID noise from the normal-state PSD after subtracting the
    predicted Johnson contributions
    (qetpy.get_squid_noise_from_normal_noise equivalent,
    noisemodel.py:354-492)."""
    johnson = s_i_normal(rn, rl, L, tc, tload, 0.0, freqs)
    resid = np.clip(np.asarray(psd_normal) - johnson, 0, None)
    return np.sqrt(resid)
