"""Batched NxM (multi-channel, multi-template) optimal-filter fits on the
natural half spectrum.

Counterpart of the natural path of ``detprocess_tpu/ops/ofnxm.py``
(qetpy OFnxm / OFnxmx2 as the reference's multichannel extractors use
them, detprocess/core/algorithms.py:24-274). For channel-stacked half
spectra ṽ_h [..., C, N/2+1] (``ops/fft.rfft``: the hand-written rFFT
kernel on the card) and the bank of ``ops/filterbank.bank_nxm_to_torch``
(φ [C, M, N/2+1] = conj(J⁻¹s̃)/(N·fs), W⁻¹ [M, M], J⁻¹ [N/2+1, C, C]):

- ``q_m(d) = Re Σ_{c,k} φ[c,m,k] ṽ[c,k] e^{2πikd/N} = N·irfft(Σ_c φ·ṽ)(d)``
- ``â(d) = W⁻¹ q(d)``,  ``Δχ²(d) = q(d)ᵀ W⁻¹ q(d)``
- ``χ²(d) = χ²₀ − Δχ²(d)``,  ``χ²₀ = Σ_k w_k Re ṽ_k† J_k⁻¹ ṽ_k / (N·fs)``

The JAX functions take the full complex FFT of each channel. For a real
template and a Hermitian CSD, φ at −k is the conjugate of φ at k, so
Σ_c φ·ṽ is Hermitian and its full inverse transform is the irfft of the
half product; χ²₀ is the half sum with the weights w of
``filterbank.half_bin_weights`` (DC and Nyquist once). That is the
argument of the trigger's FIR (``ops/trigger.make_trigger_kernel``), and
it lets the NxM fits share the spectra of the other fits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from detprocess_tpu_torch.ops import fft
from detprocess_tpu_torch.ops.of1x1 import pick_delay


class OFNxMResult(NamedTuple):
    amps: torch.Tensor   # [..., M]
    t0: torch.Tensor     # [...]
    chi2: torch.Tensor   # [...]


class OFNxMx2Result(NamedTuple):
    amps: torch.Tensor     # [..., M]
    deltat: torch.Tensor   # [...] — t(group 1) − t(group 0), seconds
    chi2: torch.Tensor     # [...]


def chi2_base_nxm_half(vr, icsd_h, bin_w, fs: float, n: int) -> torch.Tensor:
    """χ²₀ of ṽ_h [..., C, N/2+1] with J⁻¹ [N/2+1, C, C]: [...]."""
    tmp = torch.einsum("kab,...bk->...ak", icsd_h, vr)
    return (torch.sum((vr.conj() * tmp).real * bin_w, dim=(-2, -1))
            / (n * fs))


def ofnxm_nodelay_half(vr, phi_h, iw_matrix, icsd_h, bin_w, fs: float,
                       n: int) -> OFNxMResult:
    """No-delay NxM fit; amps [..., M]."""
    q = torch.einsum("cmk,...ck->...m", phi_h * bin_w, vr).real
    amps = torch.einsum("ij,...j->...i", iw_matrix, q)
    chi2 = chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n) - torch.sum(
        q * amps, dim=-1)
    return OFNxMResult(amps, torch.zeros_like(chi2), chi2)


def q_timeseries_half(vr, phi_h, pretrigger: int, n: int) -> torch.Tensor:
    """q_m at every absolute trace index (rolled by ``pretrigger``):
    [..., M, N]."""
    prod = torch.einsum("cmk,...ck->...mk", phi_h, vr)
    return torch.roll(fft.irfft(prod, n) * n, pretrigger, dims=-1)


def ofnxm_withdelay_half(vr, phi_h, iw_matrix, icsd_h, bin_w,
                         pretrigger: int, fs: float, n: int,
                         window_mask=None,
                         interpolate_t0: bool = False) -> OFNxMResult:
    """Delay-scan NxM fit, all M amplitudes sharing one shift (JAX
    ``ofnxm_withdelay`` :180), optionally within ``window_mask`` (boolean
    [N] over absolute trace indices) and with the parabolic refit of the
    Δχ² apex."""
    q_scan = q_timeseries_half(vr, phi_h, pretrigger, n)
    dchi2 = torch.einsum("...it,ij,...jt->...t", q_scan, iw_matrix, q_scan)
    pick = pick_delay(dchi2, n, pretrigger, window_mask=window_mask,
                      interpolate_t0=interpolate_t0)
    q_best = torch.gather(
        q_scan, -1, pick.idx[..., None, None].expand(
            q_scan.shape[:-1] + (1,)))[..., 0]
    amps = torch.einsum("ij,...j->...i", iw_matrix, q_best)
    gain = (pick.gain if interpolate_t0
            else torch.sum(amps * q_best, dim=-1))
    chi2 = chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n) - gain
    return OFNxMResult(amps, pick.shift / fs, chi2)


class NxMx2Plan(NamedTuple):
    """The bank constants of one NxMx2 fit (host numpy, float64)."""

    group_ids: np.ndarray    # [M] in {0, 1}
    idx1: np.ndarray         # [W1] absolute shifts allowed to group 0
    idx2: np.ndarray         # [W2] absolute shifts allowed to group 1
    ip: np.ndarray           # [U, M, M] P(Δ)⁻¹ for each Δ the windows make
    ip_index: np.ndarray     # [W1, W2] row of ``ip`` of the pair


def nxmx2_plan(bank, group_ids, window1, window2) -> NxMx2Plan:
    """Precompute an NxMx2 fit (JAX ``ofnxmx2`` :289) on the port's
    :class:`~detprocess_tpu_torch.ops.filterbank.OFNxMBank`: the
    shifted-template weight matrix

        P_ij(d1, d2) = Re Σ_k s̃_i† J⁻¹ s̃_j e^{iω(d_gj − d_gi)} / (N·fs)

    depends on Δ = d2 − d1 alone, never on the event, so each P(Δ) that
    the window product holds is inverted once here, in float64.
    ``window1``/``window2``: boolean [N] over absolute trace indices."""
    g = np.asarray(group_ids).astype(np.int64)
    n = bank.nbins
    fs = bank.fs
    s_f = np.moveaxis(bank.s_fft, -1, 0)                    # [N, C, M]
    js = np.einsum("kab,kbm->kam", bank.icsd, s_f)
    cross_k = np.einsum("kci,kcj->ijk", np.conj(s_f), js)   # [M, M, N]
    r_delta = np.fft.ifft(cross_k, axis=-1).real * n / (n * fs)
    idx1 = np.flatnonzero(np.asarray(window1))
    idx2 = np.flatnonzero(np.asarray(window2))
    delta = (idx2[None, :] - idx1[:, None]) % n              # [W1, W2]
    uniq, ip_index = np.unique(delta, return_inverse=True)
    same = g[:, None] == g[None, :]
    lower = g[:, None] < g[None, :]
    p = np.where(same, r_delta[..., 0][None],
                 np.where(lower, np.moveaxis(r_delta[..., (n - uniq) % n],
                                             -1, 0),
                          np.moveaxis(r_delta[..., uniq], -1, 0)))
    return NxMx2Plan(g, idx1, idx2, np.linalg.inv(p),
                     ip_index.reshape(delta.shape))


# bytes of the [B, W1-chunk, W2, M] temporaries of the NxMx2 pair scan
NXMX2_SCAN_BYTES = 1 << 28


def nxmx2_tensors(plan: NxMx2Plan, device, dtype=torch.float32) -> dict:
    """``plan`` on ``device``: ``idx1``, ``idx2``, ``g0`` (group-0
    templates), ``ip`` in ``dtype`` and ``ip_index``."""
    return {"idx1": torch.as_tensor(plan.idx1, device=device),
            "idx2": torch.as_tensor(plan.idx2, device=device),
            "g0": torch.as_tensor(plan.group_ids == 0, device=device),
            "ip": torch.as_tensor(plan.ip, dtype=dtype, device=device),
            "ip_index": torch.as_tensor(plan.ip_index, device=device)}


def ofnxmx2_half(vr, phi_h, icsd_h, bin_w, consts: dict, pretrigger: int,
                 fs: float, n: int,
                 scan_bytes: int = NXMX2_SCAN_BYTES) -> OFNxMx2Result:
    """NxMx2 fit: template group 0 shifts by d1 ∈ idx1, group 1 by
    d2 ∈ idx2, amplitudes â = P(Δ)⁻¹q solved jointly at every pair and
    Δχ² = qᵀP(Δ)⁻¹q maximized over the window product (JAX's order: the
    first d2 maximum for each d1, then the first d1). ``consts``: the
    plan's tensors (:func:`nxmx2_tensors`). The scan runs over chunks of
    d1, vectorized over d2 and the batch."""
    q_abs = q_timeseries_half(vr, phi_h, pretrigger, n)      # [..., M, N]
    dev = q_abs.device
    idx1, idx2, g0 = consts["idx1"], consts["idx2"], consts["g0"]
    ip, ip_index = consts["ip"], consts["ip_index"]
    q1 = q_abs[..., idx1].transpose(-1, -2)                  # [..., W1, M]
    q2 = q_abs[..., idx2].transpose(-1, -2)                  # [..., W2, M]
    batch = q_abs.shape[:-2]
    m = q_abs.shape[-2]
    w1, w2 = len(idx1), len(idx2)
    rows = int(np.prod(batch)) if batch else 1
    chunk = max(1, min(w1, int(scan_bytes) // max(
        1, rows * w2 * m * q_abs.element_size())))
    best_val = torch.full(batch, -math.inf, dtype=q_abs.dtype, device=dev)
    best_amps = torch.zeros(batch + (m,), dtype=q_abs.dtype, device=dev)
    best_i1 = torch.zeros(batch, dtype=torch.int64, device=dev)
    best_i2 = torch.zeros(batch, dtype=torch.int64, device=dev)
    for start in range(0, w1, chunk):
        stop = min(w1, start + chunk)
        # q at the pair (i1, i2): each template at its group's shift
        q = torch.where(g0, q1[..., start:stop, None, :],
                        q2[..., None, :, :])                 # [..., P, W2, M]
        amps = torch.einsum("pwij,...pwj->...pwi", ip[ip_index[start:stop]],
                            q)
        dchi2 = torch.sum(q * amps, dim=-1)                  # [..., P, W2]
        v2, i2 = dchi2.max(dim=-1)                           # first d2
        cv, ci = v2.max(dim=-1)                              # first d1
        ci2 = torch.gather(i2, -1, ci[..., None])[..., 0]
        a = amps.reshape(batch + (-1, m))
        flat = (ci * w2 + ci2)[..., None, None].expand(batch + (1, m))
        camps = torch.gather(a, -2, flat)[..., 0, :]
        upd = cv > best_val
        best_val = torch.where(upd, cv, best_val)
        best_amps = torch.where(upd[..., None], camps, best_amps)
        best_i1 = torch.where(upd, ci + start, best_i1)
        best_i2 = torch.where(upd, ci2, best_i2)
    chi2 = chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n) - best_val
    deltat = (idx2[best_i2] - idx1[best_i1]).to(chi2.dtype) / fs
    return OFNxMx2Result(best_amps, deltat, chi2)

