"""Batched single-channel optimal-filter fits on the natural half spectrum.

Counterpart of the half-spectrum path of ``detprocess_tpu/ops/of1x1.py``
(qetpy OF1x1 as used by detprocess/core/algorithms.py:278-570). For the
half spectrum ṽ_h = rfft(trace) and bank tensors (phi_h, norm,
denom_inv_h, s_fft_h, bin_w) of ``ops/filterbank.bank_to_torch``:

- ``q(d)   = Re Σ_k phi_k ṽ_k e^{2πikd/N} = N·irfft(phi_h·ṽ_h)(d)``
- ``amp(d) = q(d)/norm``,  ``χ²(d) = χ²₀ − q(d)²/norm``
- ``χ²₀    = Σ_k w_k |ṽ_k|² denom_inv_k`` (w = bin_w)
- low-frequency χ² over bins with f < fcutoff (DC excluded) at the fitted
  (amp, delay).

Delays are rolled by ``pretrigger`` so that absolute trace index i gives
``t0 = (i − pretrigger)/fs``. Shapes: ṽ_h [..., S, N/2+1], bank tensors
[S, N/2+1] / [S], results [..., S].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from detprocess_tpu_torch.ops import fft


class OF1x1Result(NamedTuple):
    amp: torch.Tensor
    t0: torch.Tensor
    chi2: torch.Tensor
    lowchi2: torch.Tensor
    chi2_nopulse: torch.Tensor


class DelayPick(NamedTuple):
    """Winner of a delay scan (:func:`pick_delay`)."""

    idx: torch.Tensor    # winning absolute trace index
    im1: torch.Tensor    # (idx ± 1) % n — for quadratic amp refits
    ip1: torch.Tensor
    delta: torch.Tensor  # sub-sample offset (0.0 when not interpolating)
    gain: Optional[torch.Tensor]  # Δχ² apex, only when interpolating
    shift: torch.Tensor  # signed t0 in samples, including delta


def _take_last(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, i.unsqueeze(-1)).squeeze(-1)


def pick_delay(dchi2: torch.Tensor, n: int, pretrigger: int, *,
               window_mask=None,
               interpolate_t0: bool = False) -> DelayPick:
    """Masked Δχ² argmax over ``dchi2`` [..., N] in absolute trace order,
    the index → signed-t0 rule, and the optional parabolic sub-sample
    refit. ``window_mask`` is a boolean [N] over absolute trace indices
    (True = allowed)."""
    if window_mask is None:
        masked = dchi2
    else:
        if not isinstance(window_mask, torch.Tensor):
            window_mask = torch.as_tensor(np.asarray(window_mask, bool))
        mask = window_mask.to(dchi2.device)
        masked = torch.where(mask, dchi2,
                             torch.full_like(dchi2, -math.inf))
    idx = torch.argmax(masked, dim=-1)
    shift = idx.to(dchi2.dtype) - pretrigger
    im1 = (idx - 1) % n
    ip1 = (idx + 1) % n
    if not interpolate_t0:
        return DelayPick(idx, im1, ip1, torch.zeros_like(shift), None, shift)
    delta, gain = parabola_refit(dchi2, idx, im1, ip1)
    return DelayPick(idx, im1, ip1, delta, gain, shift + delta)


def parabola_refit(dchi2, idx, im1, ip1):
    """Parabolic apex of Δχ² through the winner and its two neighbours:
    (delta ∈ [−1, 1], interpolated Δχ² maximum)."""
    ym1 = -_take_last(dchi2, im1)
    y0 = -_take_last(dchi2, idx)
    yp1 = -_take_last(dchi2, ip1)
    denom = ym1 - 2.0 * y0 + yp1
    safe = torch.where(denom.abs() > 0, denom, torch.ones_like(denom))
    delta = torch.where(denom.abs() > 0, 0.5 * (ym1 - yp1) / safe,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    return delta, -(y0 - 0.25 * (ym1 - yp1) * delta)


def interp_amp(q: torch.Tensor, norm, pick: DelayPick) -> torch.Tensor:
    """Quadratic refit of a(d) = q(d)/norm at the winner's sub-sample
    offset (exactly a(idx) when delta == 0)."""
    amp = _take_last(q, pick.idx) / norm
    am1 = _take_last(q, pick.im1) / norm
    ap1 = _take_last(q, pick.ip1) / norm
    a_denom = am1 - 2.0 * amp + ap1
    return (amp + 0.5 * (ap1 - am1) * pick.delta
            + 0.5 * a_denom * pick.delta * pick.delta)


def lowfreq_mask_half(n: int, fs: float, fcutoff: float) -> np.ndarray:
    """Static boolean mask on the half axis: f < fcutoff, DC excluded."""
    f = np.fft.rfftfreq(n, d=1.0 / fs)
    mask = f < fcutoff
    mask[0] = False
    return mask


def chi2_base_half(vr, denom_inv_h, bin_w):
    p2 = vr.real ** 2 + vr.imag ** 2
    return torch.sum(p2 * denom_inv_h * bin_w, dim=-1)


def _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h, bin_w, mask_h,
                        n):
    """χ² of (ṽ − amp·s̃·e^{−2πik·shift/N}) over the masked half bins."""
    nh = vr.shape[-1]
    k = torch.arange(nh, dtype=amp.dtype, device=vr.device)
    angle = -2.0 * math.pi * k * shift[..., None] / n
    phase = torch.polar(torch.ones_like(angle), angle)
    resid = vr - amp[..., None] * s_fft_h * phase
    p2 = resid.real ** 2 + resid.imag ** 2
    mask = torch.as_tensor(mask_h, device=vr.device)
    return torch.sum(p2 * denom_inv_h * bin_w * mask, dim=-1)


def of1x1_nodelay_half(vr, phi_h, norm, denom_inv_h, s_fft_h, bin_w,
                       low_mask_h=None, n=None) -> OF1x1Result:
    """No-delay OF fit (amplitude at the nominal trigger position)."""
    n = n if n is not None else 2 * (vr.shape[-1] - 1)
    q = torch.sum((phi_h * vr).real * bin_w, dim=-1)
    amp = q / norm
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    chi2 = c0 - q * q / norm
    if low_mask_h is None:
        lowchi2 = torch.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2_half(vr, amp, torch.zeros_like(amp),
                                      s_fft_h, denom_inv_h, bin_w,
                                      low_mask_h, n)
    return OF1x1Result(amp, torch.zeros_like(amp), chi2, lowchi2, c0)


def of1x1_withdelay_half(vr, phi_h, norm, denom_inv_h, s_fft_h, bin_w,
                         pretrigger: int, fs: float,
                         window_mask=None, low_mask_h=None,
                         interpolate_t0: bool = False,
                         n: Optional[int] = None) -> OF1x1Result:
    """Delay-scan OF fit, optionally constrained to ``window_mask``
    (boolean [N] over absolute trace indices). ``interpolate_t0`` refines
    t0/amp with a parabola around the discrete χ² minimum. ``n`` is the
    trace length (required for odd n)."""
    nh = vr.shape[-1]
    n = n if n is not None else 2 * (nh - 1)
    qt = fft.irfft(phi_h * vr, n) * n                      # [..., S, N]
    q_abs = torch.roll(qt, pretrigger, dims=-1)
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    dchi2 = q_abs * q_abs / norm[..., None]

    pick = pick_delay(dchi2, n, pretrigger, window_mask=window_mask,
                      interpolate_t0=interpolate_t0)
    if interpolate_t0:
        chi2 = c0 - pick.gain
        amp = interp_amp(q_abs, norm, pick)
    else:
        q_best = _take_last(q_abs, pick.idx)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
    shift = pick.shift
    t0 = shift / fs
    if low_mask_h is None:
        lowchi2 = torch.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h,
                                      bin_w, low_mask_h, n)
    return OF1x1Result(amp, t0, chi2, lowchi2, c0)


class OF1x2Result(NamedTuple):
    amp1: torch.Tensor
    amp2: torch.Tensor
    t0_1: torch.Tensor
    t0_2: torch.Tensor
    time_diff: torch.Tensor
    chi2: torch.Tensor


# bytes of one [B, S, K, N] temporary of the joint scan: K, the number of
# Δ shifts evaluated at once, is as large as this allows
OF1X2_SCAN_BYTES = 1 << 30


def of1x2_overlap(phi1_h, norm1, s_fft2_h, norm2, n: int) -> torch.Tensor:
    """The templates' normalized overlap c(Δ) = Re Σ_k φ₁ s̃₂ e^{2πikΔ/N}
    / √(norm₁·norm₂) over Δ = 0 … N−1 ([S, N]); a function of the bank
    alone, computed once per bank."""
    norm1 = torch.as_tensor(norm1)
    sq12 = torch.sqrt(norm1 * torch.as_tensor(norm2))
    return fft.irfft(phi1_h * s_fft2_h, n) * n / sq12[..., None]


class DeltaScan(NamedTuple):
    """The Δ shifts of a joint scan, in scan order: circular (0 … N−1)
    and signed (reported in time_diff), on the host and on the device."""

    deltas: np.ndarray
    signed: np.ndarray
    deltas_t: torch.Tensor
    signed_t: torch.Tensor


def delta_scan(delta_window: Optional[np.ndarray], n: int,
               device) -> DeltaScan:
    """The scan of ``delta_window`` (signed samples; None: all N circular
    shifts, those past N/2 read as negative)."""
    if delta_window is None:
        signed = np.arange(n, dtype=np.int64)
        signed = np.where(signed > n // 2, signed - n, signed)
    else:
        signed = np.asarray(delta_window, dtype=np.int64).reshape(-1)
    deltas = signed % n
    return DeltaScan(deltas, signed, torch.as_tensor(deltas, device=device),
                     torch.as_tensor(signed, device=device))


def of1x2_half(vr, phi1_h, norm1, phi2_h, norm2, s_fft2_h, denom_inv_h,
               bin_w, pretrigger: int, fs: float, n: int,
               delta_window: Optional[np.ndarray] = None,
               c_all: Optional[torch.Tensor] = None,
               scan: Optional[DeltaScan] = None,
               scan_bytes: int = OF1X2_SCAN_BYTES) -> OF1x2Result:
    """Joint two-template OF fit on the half spectrum (JAX
    ``of1x2_half`` :732, qetpy OF1x2 as FeatureExtractors.of1x2x2 uses
    it): both amplitudes and both delays fitted jointly, the coupled 2×2
    normal equations solved in closed form at each delay pair (d1, Δ),
    in the normalized form

        Δχ²(d1, Δ) = (u1² − 2c·u1·u2 + u2²) / (1 − c²),

    u_i = q_i/√norm_i the significance series in delay order,
    u2 = u2(d1 + Δ), c = c(−Δ) (:func:`of1x2_overlap`), and maximized over
    d1 and the Δ of ``delta_window`` (signed samples; default: all N
    circular shifts, those past N/2 read as negative). ``vr`` [..., S,
    N/2+1]; bank rows [S, N/2+1] and [S]; ``c_all`` the precomputed
    overlap and ``scan`` the window's :func:`delta_scan`, else made here.

    The scan runs over chunks of Δ, each a vectorized pass over all d1
    (a [..., S, K, N] temporary of at most ``scan_bytes``), carrying the
    best (value, d1, Δ, signed Δ) per event: within a chunk the first
    maximum over d1, then the first over the chunk; across chunks a
    winner is replaced only by a strictly larger value. Δ whose 1 − c²
    is at most 1e-6 (templates coinciding) are excluded."""
    norm1 = torch.as_tensor(norm1)
    norm2 = torch.as_tensor(norm2)
    sq1 = torch.sqrt(norm1)
    sq2 = torch.sqrt(norm2)
    u1 = fft.irfft(phi1_h * vr, n) * n / sq1[..., None]     # delay order
    u2 = fft.irfft(phi2_h * vr, n) * n / sq2[..., None]
    if c_all is None:
        c_all = of1x2_overlap(phi1_h, norm1, s_fft2_h, norm2, n)
    if scan is None:
        scan = delta_scan(delta_window, n, vr.device)
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    return _of1x2_scan(u1, u2, c_all.to(u1.dtype), sq1, sq2, c0, n,
                       pretrigger, fs, scan, scan_bytes)


def _of1x2_scan(u1, u2, c_all, sq1, sq2, c0, n, pretrigger, fs,
                scan: DeltaScan, scan_bytes) -> OF1x2Result:
    rdt = u1.dtype
    dev = u1.device
    deltas = scan.deltas
    batch = u1.shape[:-1]                                   # [..., S]
    u1sq = u1 * u1
    u2ext = torch.cat([u2, u2], dim=-1)                     # circular view
    rows = int(np.prod(batch)) if batch else 1
    k = max(1, min(len(deltas),
                   int(scan_bytes) // max(1, rows * n * u1.element_size())))
    best_val = torch.full(batch, -math.inf, dtype=rdt, device=dev)
    best_d1 = torch.zeros(batch, dtype=torch.int64, device=dev)
    best_dl = torch.zeros(batch, dtype=torch.int64, device=dev)
    best_sg = torch.zeros(batch, dtype=torch.int64, device=dev)
    pos = torch.arange(n, device=dev)
    for start in range(0, len(deltas), k):
        dl = deltas[start:start + k]
        dl_t = scan.deltas_t[start:start + k]
        if np.all(np.diff(dl) == 1):
            # consecutive shifts: a strided view of the doubled series
            u2s = u2ext[..., int(dl[0]):int(dl[0]) + len(dl) - 1 + n].unfold(
                -1, n, 1)                                   # [..., S, K, N]
        else:
            u2s = u2[..., (pos[None, :] + dl_t[:, None]) % n]
        # W12 carries e^{−iωΔ}: c at −Δ
        c = c_all[..., (n - dl_t) % n]                      # [S, K]
        det = 1.0 - c * c
        a = torch.addcmul(u2s, u1[..., None, :], (-2.0 * c)[..., None])
        num = torch.addcmul(u1sq[..., None, :], a, u2s)
        vmax, d1 = num.max(dim=-1)                          # [..., S, K]
        ok = det > 1e-6
        vals = torch.where(ok, vmax / torch.where(ok, det, torch.ones_like(
            det)), torch.full_like(vmax, -math.inf))
        cv, ci = vals.max(dim=-1)                           # first in chunk
        cd1 = torch.gather(d1, -1, ci[..., None])[..., 0]
        cdl = dl_t[ci]
        csg = scan.signed_t[start:start + k][ci]
        upd = cv > best_val
        best_val = torch.where(upd, cv, best_val)
        best_d1 = torch.where(upd, cd1, best_d1)
        best_dl = torch.where(upd, cdl, best_dl)
        best_sg = torch.where(upd, csg, best_sg)

    # re-solve the 2×2 system at the winning (d1, Δ)
    d1, dl = best_d1, best_dl
    d2 = (d1 + dl) % n
    u1b = _take_last(u1, d1)
    u2b = _take_last(u2, d2)
    c = _take_last(c_all.expand(batch + (n,)), (n - dl) % n)
    det = 1.0 - c * c
    det = torch.where(det.abs() > 0, det, torch.ones_like(det))
    amp1 = (u1b - c * u2b) / (sq1 * det)
    amp2 = (u2b - c * u1b) / (sq2 * det)
    chi2 = c0 - best_val
    # d1 is a delay index: absolute i = (d1 + pretrigger) mod n
    d_f = d1.to(rdt)
    shift1 = torch.where(d1 < n - pretrigger, d_f, d_f - n)
    shift2 = shift1 + best_sg.to(rdt)
    t0_1 = shift1 / fs
    t0_2 = shift2 / fs
    return OF1x2Result(amp1, amp2, t0_1, t0_2, t0_2 - t0_1, chi2)


def energy_resolution(norm: torch.Tensor) -> torch.Tensor:
    """σ_amp = 1/sqrt(norm), the OF amplitude resolution."""
    return 1.0 / torch.sqrt(norm)


def time_resolution_half(amp: torch.Tensor, s_fft_h: torch.Tensor,
                         denom_inv_h: torch.Tensor, bin_w: torch.Tensor,
                         n: int, fs: float) -> torch.Tensor:
    """σ_t0 = 1/sqrt(amp² · Σ_k w_k ω_k² |s̃_k|² d_k) over the half
    spectrum: the curvature of χ²(t0) at its minimum (the weights w
    stand in for the mirrored bins, whose ω² and |s̃|² are equal)."""
    # made on the device: a host copy would wait for the stream's work
    k = torch.arange(s_fft_h.shape[-1], dtype=torch.float64,
                     device=denom_inv_h.device)
    f = torch.where(k <= n // 2, k, k - n) / n * fs
    omega2 = ((2.0 * math.pi * f) ** 2).to(denom_inv_h.dtype)
    curv = torch.sum(omega2 * (s_fft_h.real ** 2 + s_fft_h.imag ** 2)
                     * denom_inv_h * bin_w, dim=-1)
    return 1.0 / torch.sqrt(amp * amp * curv)
