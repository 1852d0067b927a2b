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

A constrained NxM fit and the NxMx2 pair scan also have a direct route
(:func:`ofnxm_withdelay_direct_half`; the ``union`` table of
:func:`nxmx2_tensors`, up to :data:`DIRECT_UNION_MAX` shifts): q at the
window's shifts only, one GEMM over ``of1x1.prepare_delay_window``'s
tables in place of M inverse transforms, with the same results.

The JAX full-spectrum forms (:func:`chi2_base_nxm`, :func:`ofnxm_nodelay`,
:func:`ofnxm_withdelay`, :func:`ofnxm_withdelay_direct`, :func:`ofnxmx2`)
are here too, as the plain
formulas over all N bins of complex spectra ṽ [..., C, N] with the full
bank (φ [C, M, N], J⁻¹ [N, C, C], s̃ [C, M, N]) and ``torch.fft``, with
no assumption of symmetry: a user API. The shells use the half forms.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from detprocess_tpu_torch.ops import fft
from detprocess_tpu_torch.ops.of1x1 import (delay_tables, direct_table,
                                           parabola_refit, pick_delay,
                                           window_q)


class OFNxMResult(NamedTuple):
    amps: torch.Tensor   # [..., M]
    t0: torch.Tensor     # [...]
    chi2: torch.Tensor   # [...]


class OFNxMx2Result(NamedTuple):
    amps: torch.Tensor     # [..., M]
    deltat: torch.Tensor   # [...] — t(group 1) − t(group 0), seconds
    chi2: torch.Tensor     # [...]


def chi2_base_nxm(vfft, icsd, fs: float) -> torch.Tensor:
    """χ²₀ = Σ_k Re ṽ_k† J_k⁻¹ ṽ_k / (N·fs) of ṽ [..., C, N] with J⁻¹
    [N, C, C]: [...]."""
    n = vfft.shape[-1]
    tmp = torch.einsum("kab,...bk->...ak", icsd, vfft)
    return torch.einsum("...ak,...ak->...", vfft.conj(), tmp).real / (n * fs)


def ofnxm_nodelay(vfft, phi, iw_matrix, icsd, fs: float) -> OFNxMResult:
    """No-delay NxM fit on the full spectrum (JAX :55); amps [..., M]."""
    q = torch.einsum("cmk,...ck->...m", phi, vfft).real
    amps = torch.einsum("ij,...j->...i", iw_matrix, q)
    chi2 = chi2_base_nxm(vfft, icsd, fs) - torch.einsum(
        "...i,ij,...j->...", q, iw_matrix, q)
    return OFNxMResult(amps, torch.zeros_like(chi2), chi2)


def q_timeseries(vfft, phi, pretrigger: int) -> torch.Tensor:
    """q_m at every absolute trace index, N·Re ifft(Σ_c φ·ṽ) rolled by
    ``pretrigger``: [..., M, N]."""
    n = vfft.shape[-1]
    prod = torch.einsum("cmk,...ck->...mk", phi, vfft)
    return torch.roll(torch.fft.ifft(prod, dim=-1).real * n, pretrigger,
                      dims=-1)


def ofnxm_withdelay(vfft, phi, w_matrix, iw_matrix, icsd, pretrigger: int,
                    fs: float, window_mask=None,
                    interpolate_t0: bool = False) -> OFNxMResult:
    """Delay-scan NxM fit on the full spectrum (JAX :180), all M
    amplitudes sharing one shift, optionally within ``window_mask``
    (boolean [N] over absolute trace indices). ``w_matrix`` is not read
    (the JAX signature's)."""
    q_scan = q_timeseries(vfft, phi, pretrigger)
    return _withdelay_fit(q_scan, iw_matrix,
                          chi2_base_nxm(vfft, icsd, fs), vfft.shape[-1],
                          pretrigger, fs, window_mask, interpolate_t0)


def _withdelay_fit(q_scan, iw_matrix, chi2_0, n, pretrigger, fs,
                   window_mask, interpolate_t0) -> OFNxMResult:
    """The delay pick and the amplitudes at it of q [..., M, N] in
    absolute trace order."""
    dchi2 = torch.einsum("...it,ij,...jt->...t", q_scan, iw_matrix, q_scan)
    pick = pick_delay(dchi2, n, pretrigger, window_mask=window_mask,
                      interpolate_t0=interpolate_t0)
    q_best = torch.gather(
        q_scan, -1, pick.idx[..., None, None].expand(
            q_scan.shape[:-1] + (1,)))[..., 0]
    amps = torch.einsum("ij,...j->...i", iw_matrix, q_best)
    gain = (pick.gain if interpolate_t0
            else torch.sum(amps * q_best, dim=-1))
    return OFNxMResult(amps, pick.shift / fs, chi2_0 - gain)


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
    return _withdelay_fit(q_timeseries_half(vr, phi_h, pretrigger, n),
                          iw_matrix,
                          chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n), n,
                          pretrigger, fs, window_mask, interpolate_t0)


def ofnxm_withdelay_direct(vfft, phi, w_matrix, iw_matrix, icsd,
                           pretrigger: int, fs: float, eval_idx, valid,
                           cos_mat, sin_mat=None,
                           interpolate_t0: bool = False) -> OFNxMResult:
    """Constrained NxM delay scan on the full spectrum by a direct windowed
    DFT (JAX :222): q_m(d) = Re Σ_k (φᵀṽ)_{m,k} e^{2πikd/N} at the W window
    samples of ``of1x1.prepare_delay_window(mask, pretrigger, N)`` (no bin
    weights), one [.., M, 2N] × [2N, W] GEMM in place of M inverse FFTs.
    Equal to ``ofnxm_withdelay(window_mask=...)``; ``w_matrix`` is not
    read (the JAX signature's)."""
    table = cos_mat if sin_mat is None else (cos_mat, sin_mat)
    qw = window_q(torch.einsum("cmk,...ck->...mk", phi, vfft), table)
    return _direct_fit(qw, iw_matrix, chi2_base_nxm(vfft, icsd, fs),
                       pretrigger, fs, eval_idx, valid, interpolate_t0)


def ofnxm_withdelay_direct_half(vr, phi_h, iw_matrix, icsd_h, bin_w,
                                pretrigger: int, fs: float, n: int,
                                eval_idx, valid, table,
                                interpolate_t0: bool = False) -> OFNxMResult:
    """:func:`ofnxm_withdelay_direct` on the half spectrum: ``table`` is
    the [2K, W] tensor of ``of1x1.direct_table`` over the bin-weighted
    tables of ``prepare_delay_window(mask, pretrigger, n, bin_w)`` (or
    their (cos, sin) pair). Equal to ``ofnxm_withdelay_half(window_mask=
    ...)``."""
    qw = window_q(torch.einsum("cmk,...ck->...mk", phi_h, vr), table)
    return _direct_fit(qw, iw_matrix,
                       chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n),
                       pretrigger, fs, eval_idx, valid, interpolate_t0)


def _direct_fit(qw, iw_matrix, chi2_0, pretrigger, fs, eval_idx, valid,
                interpolate_t0) -> OFNxMResult:
    """The delay pick and the amplitudes at it of q [..., M, W] at the
    window samples ``eval_idx`` (allowed where ``valid``)."""
    dev = qw.device
    dchi2 = torch.einsum("...iw,ij,...jw->...w", qw, iw_matrix, qw)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    p = torch.argmax(torch.where(valid, dchi2,
                                 torch.full_like(dchi2, -math.inf)), dim=-1)
    q_best = torch.gather(qw, -1, p[..., None, None].expand(
        qw.shape[:-1] + (1,)))[..., 0]                       # [..., M]
    amps = torch.einsum("ij,...j->...i", iw_matrix, q_best)
    eval_idx = torch.as_tensor(eval_idx, dtype=torch.int64, device=dev)
    shift = eval_idx[p].to(chi2_0.dtype) - pretrigger
    if interpolate_t0:
        # the guard samples hold idx ± 1 (mod N) at positions p ± 1
        delta, gain = parabola_refit(dchi2, p, p - 1, p + 1)
        shift = shift + delta
    else:
        gain = torch.gather(dchi2, -1, p[..., None])[..., 0]
    return OFNxMResult(amps, shift / fs, chi2_0 - gain)


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
    idx1 = np.flatnonzero(np.asarray(window1))
    idx2 = np.flatnonzero(np.asarray(window2))
    ip, ip_index = pair_inverses(
        torch.as_tensor(np.asarray(bank.s_fft, np.complex128)),
        torch.as_tensor(np.asarray(bank.icsd, np.complex128)), bank.fs,
        torch.as_tensor(g), torch.as_tensor(idx1), torch.as_tensor(idx2))
    return NxMx2Plan(g, idx1, idx2, ip.numpy(), ip_index.numpy())


def pair_inverses(s_fft, icsd, fs: float, group_ids, idx1, idx2):
    """(P(Δ)⁻¹ [U, M, M] for each Δ = (d2 − d1) mod N of the pairs of
    ``idx1`` × ``idx2``, the row of each pair [W1, W2]) of templates
    s̃ [C, M, N] under J⁻¹ [N, C, C], group ids [M] in {0, 1}; on the
    tensors' device and in their precision."""
    n = s_fft.shape[-1]
    s_f = s_fft.movedim(-1, 0)                              # [N, C, M]
    js = torch.einsum("kab,kbm->kam", icsd, s_f)
    cross_k = torch.einsum("kci,kcj->ijk", s_f.conj(), js)  # [M, M, N]
    r_delta = torch.fft.ifft(cross_k, dim=-1).real * n / (n * fs)
    delta = (idx2[None, :] - idx1[:, None]) % n              # [W1, W2]
    uniq, ip_index = torch.unique(delta, return_inverse=True)
    g = group_ids
    same = g[:, None] == g[None, :]
    lower = g[:, None] < g[None, :]
    p = torch.where(same, r_delta[..., 0][None],
                    torch.where(lower,
                                r_delta[..., (n - uniq) % n].movedim(-1, 0),
                                r_delta[..., uniq].movedim(-1, 0)))
    return torch.linalg.inv(p), ip_index


# bytes of the [B, W1-chunk, W2, M] temporaries of the NxMx2 pair scan
NXMX2_SCAN_BYTES = 1 << 28

# Union of the two fit windows at or below which the NxMx2 fit evaluates
# q by a direct windowed DFT at the union's shifts (one GEMM) in place of
# M inverse FFTs (JAX :277-283, where 512 came from a TPU measurement):
# the largest |union| at which the direct route beat the irfft route in
# every chip run of chip_smoke.py's phase (q) (PERF.md §6).
DIRECT_UNION_MAX = 251


def nxmx2_tensors(plan: NxMx2Plan, device, dtype=torch.float32,
                  pretrigger=None, n=None, bin_w=None,
                  direct=None) -> dict:
    """``plan`` on ``device``: ``idx1``, ``idx2``, ``g0`` (group-0
    templates), ``ip`` in ``dtype`` and ``ip_index``. Given ``pretrigger``
    and ``n`` (and ``bin_w`` for the half spectrum), a union of the fit
    windows of at most :data:`DIRECT_UNION_MAX` shifts (or any, with
    ``direct`` True; none with False) also gets the direct route's
    ``union`` table [2K, |union|] (``of1x1.direct_table``) and each
    window's positions in it, ``pos1`` and ``pos2``."""
    consts = {"idx1": torch.as_tensor(plan.idx1, device=device),
              "idx2": torch.as_tensor(plan.idx2, device=device),
              "g0": torch.as_tensor(plan.group_ids == 0, device=device),
              "ip": torch.as_tensor(plan.ip, dtype=dtype, device=device),
              "ip_index": torch.as_tensor(plan.ip_index, device=device)}
    union = np.union1d(plan.idx1, plan.idx2)
    if direct is None:
        direct = n is not None and len(union) <= DIRECT_UNION_MAX
    if direct:
        consts["union"] = direct_table(
            *delay_tables(union, pretrigger, n, bin_w), device, dtype)
        for key, idx in (("pos1", plan.idx1), ("pos2", plan.idx2)):
            consts[key] = torch.as_tensor(np.searchsorted(union, idx),
                                          device=device)
    return consts


def ofnxmx2_half(vr, phi_h, icsd_h, bin_w, consts: dict, pretrigger: int,
                 fs: float, n: int,
                 scan_bytes: int = NXMX2_SCAN_BYTES) -> OFNxMx2Result:
    """NxMx2 fit: template group 0 shifts by d1 ∈ idx1, group 1 by
    d2 ∈ idx2, amplitudes â = P(Δ)⁻¹q solved jointly at every pair and
    Δχ² = qᵀP(Δ)⁻¹q maximized over the window product (JAX's order: the
    first d2 maximum for each d1, then the first d1). ``consts``: the
    plan's tensors (:func:`nxmx2_tensors`); with a ``union`` table q is
    evaluated at the union's shifts only (the direct route, JAX :333-345),
    else at every sample by the inverse transform. The scan runs over
    chunks of d1, vectorized over d2 and the batch."""
    if "union" in consts:
        q = window_q(torch.einsum("cmk,...ck->...mk", phi_h, vr),
                     consts["union"])
        cols = consts["pos1"], consts["pos2"]
    else:
        q = q_timeseries_half(vr, phi_h, pretrigger, n)
        cols = consts["idx1"], consts["idx2"]
    best_val, amps, i1, i2 = _nxmx2_scan(q, *cols, consts, scan_bytes)
    chi2 = chi2_base_nxm_half(vr, icsd_h, bin_w, fs, n) - best_val
    deltat = (consts["idx2"][i2] - consts["idx1"][i1]).to(chi2.dtype) / fs
    return OFNxMx2Result(amps, deltat, chi2)


def ofnxmx2(vfft, s_fft, icsd, group_ids, window1, window2,
            pretrigger: int, fs: float,
            scan_bytes: int = NXMX2_SCAN_BYTES):
    """NxMx2 fit on the full spectrum (JAX :289): template group 0 shifts
    by d1 within ``window1``, group 1 by d2 within ``window2`` (boolean
    [N] over absolute trace indices), the amplitudes â = P(Δ)⁻¹q solved
    at every pair with φ = conj(J⁻¹s̃)/(N·fs). Returns
    (:class:`OFNxMx2Result`, (d1, d2)) as JAX does."""
    n = vfft.shape[-1]
    dev = vfft.device
    phi = torch.einsum("kab,bmk->amk", icsd, s_fft).conj() / (n * fs)
    w1 = np.flatnonzero(np.asarray(window1))
    w2 = np.flatnonzero(np.asarray(window2))
    idx1, idx2 = (torch.as_tensor(w, device=dev) for w in (w1, w2))
    g = torch.as_tensor(np.asarray(group_ids).astype(np.int64), device=dev)
    ip, ip_index = pair_inverses(s_fft, icsd, fs, g, idx1, idx2)
    consts = {"idx1": idx1, "idx2": idx2, "g0": g == 0,
              "ip": ip.to(vfft.real.dtype), "ip_index": ip_index}
    union = np.union1d(w1, w2)
    if len(union) <= DIRECT_UNION_MAX:
        # q only at the windows' shifts, one GEMM (JAX :339)
        q = window_q(torch.einsum("cmk,...ck->...mk", phi, vfft),
                     delay_tables(union, pretrigger, n))
        cols = [torch.as_tensor(np.searchsorted(union, w), device=dev)
                for w in (w1, w2)]
    else:
        q = q_timeseries(vfft, phi, pretrigger)
        cols = idx1, idx2
    best_val, amps, i1, i2 = _nxmx2_scan(q, *cols, consts, scan_bytes)
    chi2 = chi2_base_nxm(vfft, icsd, fs) - best_val
    d1, d2 = idx1[i1], idx2[i2]
    return OFNxMx2Result(amps, (d2 - d1).to(chi2.dtype) / fs, chi2), (d1, d2)


def _nxmx2_scan(q_abs, cols1, cols2, consts: dict, scan_bytes: int):
    """(best Δχ², amps, index into idx1, index into idx2) of the pair scan
    over q [..., M, X] whose columns ``cols1`` hold q at the shifts of
    idx1 and ``cols2`` at those of idx2."""
    dev = q_abs.device
    g0 = consts["g0"]
    ip, ip_index = consts["ip"], consts["ip_index"]
    q1 = q_abs[..., cols1].transpose(-1, -2)                 # [..., W1, M]
    q2 = q_abs[..., cols2].transpose(-1, -2)                 # [..., W2, M]
    batch = q_abs.shape[:-2]
    m = q_abs.shape[-2]
    w1, w2 = len(cols1), len(cols2)
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
    return best_val, best_amps, best_i1, best_i2

