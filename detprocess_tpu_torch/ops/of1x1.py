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

A constrained fit of a narrow window has two routes with the same
results: the irfft route (:func:`of1x1_withdelay_half` with
``window_mask``) evaluates q at all N delays by one inverse transform;
the direct route (:func:`of1x1_windowed_direct_half`, JAX :566) evaluates
it at the window's W delays only, one [B, 2K] × [2K, W] GEMM over the
tables of :func:`prepare_delay_window`. The feature plan picks the direct
route up to ``pipelines/feature_plan.DIRECT_WINDOW_MAX`` delays.

The full-spectrum forms of the JAX module (:func:`signal_fft`,
:func:`chi2_base`, :func:`lowfreq_mask`, :func:`of1x1_nodelay`,
:func:`of1x1_withdelay`, :func:`time_resolution` and :func:`of1x2`) are
the same formulas over all N bins of a complex spectrum ṽ = FFT(trace)
(``torch.fft``; the JAX four-step matmul FFT is a TPU workaround), with
no assumption of Hermitian symmetry: a user API for spectra of any kind.
No shell calls them; the shells read the half spectrum.
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


def signal_fft(traces: torch.Tensor) -> torch.Tensor:
    """Full complex spectrum [..., N] of traces [..., N]."""
    return torch.fft.fft(traces, dim=-1)


def signal_rfft(traces: torch.Tensor) -> torch.Tensor:
    """Half spectrum [..., N//2+1] of real traces (``ops/fft.rfft``: the
    rFFT kernel on the card)."""
    return fft.rfft(traces)


def chi2_base(vfft: torch.Tensor, denom_inv: torch.Tensor) -> torch.Tensor:
    """χ²₀ = Σ_k |ṽ_k|²·denom_inv_k over the full spectrum."""
    return torch.sum((vfft.real ** 2 + vfft.imag ** 2) * denom_inv, dim=-1)


def lowfreq_mask(n: int, fs: float, fcutoff: float) -> np.ndarray:
    """Boolean mask [N] over the full spectrum: |f| < fcutoff, DC
    excluded."""
    f = np.fft.fftfreq(n, d=1.0 / fs)
    mask = np.abs(f) < fcutoff
    mask[0] = False
    return mask


def _residual_chi2(vfft, amp, shift, s_fft, denom_inv, mask):
    """χ² of (ṽ − amp·s̃·e^{−2πik·shift/N}) over the masked bins of the
    full spectrum."""
    n = vfft.shape[-1]
    k = torch.arange(n, dtype=amp.dtype, device=vfft.device)
    angle = -2.0 * math.pi * k * shift[..., None] / n
    resid = vfft - amp[..., None] * s_fft * torch.polar(
        torch.ones_like(angle), angle)
    mask = torch.as_tensor(mask, device=vfft.device)
    return torch.sum((resid.real ** 2 + resid.imag ** 2) * denom_inv * mask,
                     dim=-1)


def of1x1_nodelay(vfft, phi, norm, denom_inv, s_fft,
                  low_mask=None) -> OF1x1Result:
    """No-delay OF fit on the full spectrum (JAX :171): ṽ [..., S, N],
    bank rows [S, N] and [S], results [..., S]."""
    q = torch.sum((phi * vfft).real, dim=-1)
    amp = q / norm
    c0 = chi2_base(vfft, denom_inv)
    chi2 = c0 - q * q / norm
    if low_mask is None:
        lowchi2 = torch.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2(vfft, amp, torch.zeros_like(amp), s_fft,
                                 denom_inv, low_mask)
    return OF1x1Result(amp, torch.zeros_like(amp), chi2, lowchi2, c0)


def of1x1_withdelay(vfft, phi, norm, denom_inv, s_fft, pretrigger: int,
                    fs: float, window_mask=None, low_mask=None,
                    interpolate_t0: bool = False) -> OF1x1Result:
    """Delay-scan OF fit on the full spectrum (JAX :198), optionally
    within ``window_mask`` (boolean [N] over absolute trace indices) and
    with the parabolic refit of the Δχ² apex: q(d) = N·Re ifft(φ·ṽ)(d),
    rolled by ``pretrigger``."""
    n = vfft.shape[-1]
    q_abs = torch.roll(torch.fft.ifft(phi * vfft, dim=-1).real * n,
                       pretrigger, dims=-1)
    c0 = chi2_base(vfft, denom_inv)
    pick = pick_delay(q_abs * q_abs / norm[..., None], n, pretrigger,
                      window_mask=window_mask, interpolate_t0=interpolate_t0)
    if interpolate_t0:
        chi2 = c0 - pick.gain
        amp = interp_amp(q_abs, norm, pick)
    else:
        q_best = _take_last(q_abs, pick.idx)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
    if low_mask is None:
        lowchi2 = torch.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2(vfft, amp, pick.shift, s_fft, denom_inv,
                                 low_mask)
    return OF1x1Result(amp, pick.shift / fs, chi2, lowchi2, c0)


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


def prepare_delay_window(window_mask, pretrigger: int, n: int,
                         bin_w: Optional[np.ndarray] = None):
    """Host tables of the direct windowed delay fits (JAX :525): ``(eval_idx
    [W], valid [W], cos_mat [K, W], sin_mat [K, W])``.

    ``window_mask`` is the boolean [N] over absolute trace indices. Each
    contiguous run of allowed indices is extended by one guard sample on
    each side (modulo N, the irfft route's ``(idx ± 1) % n`` neighbours);
    ``valid`` marks the allowed positions. With ``bin_w`` (the half
    spectrum, K = N//2+1) the tables carry the bin weights, so that
    q(eval_idx) = Re(prod)@cos − Im(prod)@sin with prod = φ_h·ṽ_h; without
    it they span the full spectrum (K = N, unit weights)."""
    window_mask = np.asarray(window_mask, bool)
    if window_mask.shape[-1] != n:
        raise ValueError("window_mask length != n")
    idx = np.flatnonzero(window_mask)
    if idx.size == 0:
        raise ValueError("empty delay window")
    eval_idx, valid = [], []
    for run in np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1):
        eval_idx.extend([(run[0] - 1) % n, *run, (run[-1] + 1) % n])
        valid.extend([False, *([True] * len(run)), False])
    eval_idx = np.asarray(eval_idx, np.int32)
    return (eval_idx, np.asarray(valid, bool),
            *delay_tables(eval_idx, pretrigger, n, bin_w))


def delay_tables(idx, pretrigger: int, n: int, bin_w=None):
    """(cos [K, W], sin [K, W]) of θ = 2πk·((idx − pretrigger) mod N)/N at
    the absolute trace indices ``idx`` [W], times ``bin_w`` [K] (K = N//2+1)
    where given, else over the full spectrum (K = N) unweighted."""
    k = np.arange(n if bin_w is None else len(bin_w), dtype=np.float64)
    d = (np.asarray(idx).astype(np.int64) - pretrigger) % n
    theta = 2.0 * np.pi * k[:, None] * d[None, :] / n
    w = (np.ones((1, 1)) if bin_w is None
         else np.asarray(bin_w, np.float64)[:, None])
    return np.cos(theta) * w, np.sin(theta) * w


def direct_table(cos_mat, sin_mat, device, dtype) -> torch.Tensor:
    """The cos/sin tables [K, W] of :func:`prepare_delay_window` as one
    [2K, W] tensor whose rows interleave cos and −sin, so that
    q = view_as_real(prod).flatten(-2) @ table: one GEMM."""
    table = np.stack([np.asarray(cos_mat), -np.asarray(sin_mat)], axis=1)
    return torch.as_tensor(table.reshape(-1, table.shape[-1]), dtype=dtype,
                           device=device)


def window_q(prod: torch.Tensor, table) -> torch.Tensor:
    """q [..., W] of the complex products ``prod`` [..., K] at the window
    samples of ``table`` ([2K, W] of :func:`direct_table`, or the pair
    (cos [K, W], sin [K, W]) as numpy or tensors), in full float32 on the
    card (TF32 off, ``device.set_full_f32``)."""
    if isinstance(table, tuple):
        table = direct_table(*table, prod.device, prod.real.dtype)
    return torch.view_as_real(prod.contiguous()).flatten(-2) @ table


def of1x1_windowed_direct_half(vr, phi_h, norm, denom_inv_h, s_fft_h, bin_w,
                               pretrigger: int, fs: float, eval_idx, valid,
                               cos_mat, sin_mat=None, low_mask_h=None,
                               interpolate_t0: bool = False,
                               n: Optional[int] = None) -> OF1x1Result:
    """Constrained delay-scan OF fit by a direct windowed DFT (JAX :566):
    q(d) = Σ_k w_k Re(φ_k ṽ_k e^{2πikd/N}) at the W window samples of
    :func:`prepare_delay_window` only, one [B, 2K] × [2K, W] GEMM in place
    of the irfft route's [N]-point inverse transform. Equal to
    ``of1x1_withdelay_half(window_mask=...)``. ``cos_mat`` may be the
    [2K, W] tensor of :func:`direct_table` (``sin_mat`` None)."""
    nh = vr.shape[-1]
    n = n if n is not None else 2 * (nh - 1)
    table = cos_mat if sin_mat is None else (cos_mat, sin_mat)
    qw = window_q(phi_h * vr, table)                       # [..., S, W]
    c0 = chi2_base_half(vr, denom_inv_h, bin_w)
    dchi2 = qw * qw / norm[..., None]
    valid = torch.as_tensor(valid, dtype=torch.bool, device=vr.device)
    p = torch.argmax(torch.where(valid, dchi2,
                                 torch.full_like(dchi2, -math.inf)), dim=-1)
    eval_idx = torch.as_tensor(eval_idx, dtype=torch.int64, device=vr.device)
    t0_idx = eval_idx[p].to(qw.dtype) - pretrigger
    if interpolate_t0:
        # the guard samples put the neighbours idx ± 1 (mod N) at window
        # positions p ± 1 of every allowed winner: no wrap here
        delta, gain = parabola_refit(dchi2, p, p - 1, p + 1)
        pick = DelayPick(p, p - 1, p + 1, delta, gain, t0_idx + delta)
        amp = interp_amp(qw, norm, pick)
        chi2 = c0 - gain
        shift = pick.shift
    else:
        q_best = _take_last(qw, p)
        amp = q_best / norm
        chi2 = c0 - q_best * q_best / norm
        shift = t0_idx
    if low_mask_h is None:
        lowchi2 = torch.full_like(chi2, -999999.0)
    else:
        lowchi2 = _residual_chi2_half(vr, amp, shift, s_fft_h, denom_inv_h,
                                      bin_w, low_mask_h, n)
    return OF1x1Result(amp, shift / fs, chi2, lowchi2, c0)


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


def of1x2(vfft, phi1, norm1, s_fft1, phi2, norm2, s_fft2, denom_inv,
          pretrigger: int, fs: float,
          delta_window: Optional[np.ndarray] = None,
          scan_bytes: int = OF1X2_SCAN_BYTES) -> OF1x2Result:
    """Joint two-template OF fit on the full spectrum (JAX :673): the
    scan of :func:`of1x2_half` on the significance series
    u_i = N·Re ifft(φ_i·ṽ)/√norm_i in absolute trace order (rolled by
    ``pretrigger``), with c(Δ) = N·Re ifft(φ₁·s̃₂)(Δ)/√(norm₁·norm₂).
    ``s_fft1`` is not read (the JAX signature's)."""
    n = vfft.shape[-1]
    norm1 = torch.as_tensor(norm1)
    norm2 = torch.as_tensor(norm2)
    sq1 = torch.sqrt(norm1)
    sq2 = torch.sqrt(norm2)

    def series(phi):
        return torch.fft.ifft(phi * vfft, dim=-1).real * n

    u1 = torch.roll(series(phi1), pretrigger, dims=-1) / sq1[..., None]
    u2 = torch.roll(series(phi2), pretrigger, dims=-1) / sq2[..., None]
    c_all = (torch.fft.ifft(phi1 * s_fft2, dim=-1).real * n
             / (sq1 * sq2)[..., None])
    c0 = chi2_base(vfft, denom_inv)
    return _of1x2_scan(u1, u2, c_all.to(u1.dtype), sq1, sq2, c0, n,
                       pretrigger, fs, delta_scan(delta_window, n,
                                                  vfft.device),
                       scan_bytes, delay_order=False)


def _of1x2_scan(u1, u2, c_all, sq1, sq2, c0, n, pretrigger, fs,
                scan: DeltaScan, scan_bytes,
                delay_order: bool = True) -> OF1x2Result:
    """The joint (d1, Δ) scan of u series in delay order (d1 read as a
    delay), or in absolute trace order (``delay_order=False``: d1 read as
    a trace index)."""
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
    d_f = d1.to(rdt)
    if delay_order:
        # d1 is a delay index: absolute i = (d1 + pretrigger) mod n
        shift1 = torch.where(d1 < n - pretrigger, d_f, d_f - n)
    else:
        shift1 = d_f - pretrigger
    shift2 = shift1 + best_sg.to(rdt)
    t0_1 = shift1 / fs
    t0_2 = shift2 / fs
    return OF1x2Result(amp1, amp2, t0_1, t0_2, t0_2 - t0_1, chi2)


def energy_resolution(norm: torch.Tensor) -> torch.Tensor:
    """σ_amp = 1/sqrt(norm), the OF amplitude resolution."""
    return 1.0 / torch.sqrt(norm)


def time_resolution(amp: torch.Tensor, s_fft: torch.Tensor,
                    denom_inv: torch.Tensor, fs: float) -> torch.Tensor:
    """σ_t0 = 1/sqrt(amp² · Σ_k ω_k² |s̃_k|² denom_inv_k) over the full
    spectrum (JAX :630): the curvature of χ²(t0) at its minimum."""
    n = s_fft.shape[-1]
    f = torch.fft.fftfreq(n, d=1.0 / fs, dtype=torch.float64,
                          device=denom_inv.device).to(denom_inv.dtype)
    omega2 = (2.0 * math.pi * f) ** 2
    curv = torch.sum(omega2 * (s_fft.real ** 2 + s_fft.imag ** 2)
                     * denom_inv, dim=-1)
    return 1.0 / torch.sqrt(amp * amp * curv)


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
