"""Continuous-trace optimal-filter trigger: the tiled path.

Counterpart of ``detprocess_tpu/ops/trigger.py`` for what the tiled branch
of ``TriggerProcessing._make_channel_fn.run_one``
(``pipelines/triggers.py:632-655``) runs, in base and residual mode:

1. **FIR filter bank** (:func:`of_fir_blocks`): overlap-save FFT
   convolution of the C-channel continuous trace with the M matched
   filters, giving the amplitude numerator q [M, L]. The segments' rFFT
   is ``ops/fft.rfft`` (the hand-written kernel on the card at the usual
   sizes), the channel mix an einsum, the inverse ``torch.fft.irfft``.
2. **Δχ²(t) = q(t)ᵀ W⁻¹ q(t)** (:func:`delta_chi2_from_q`).
3. **Threshold + pileup merge** (:func:`find_triggers_tiled`): per-tile
   summaries, then the merge on the L/G tile summaries with
   ``torch.cummax`` and ``scatter_reduce`` on flat tensors, first-achiever
   winners, compaction to a fixed capacity K.
4. **Residual re-trigger** (:func:`residual_subtract_conv`): each trigger's
   best-fit Δχ² response subtracted as spikes convolved with a fixed basis
   (one more FIR), skipping triggers the saturation veto
   (:func:`saturation_mask`) flags.

Only the natural spectral layout is ported: the JAX package's packed and
permuted layouts, its Hillis–Steele doubling scans and its 2-D block
layouts for the merge exist for the TPU (ROADMAP §2c). Every device
function takes leading batch dimensions (events); host precompute is
numpy, as in the JAX package. The time alignment is the JAX package's: a
pulse whose trigger point (template pretrigger sample) sits at index T
puts the Δχ² maximum at index T.

The sub-tile merge (``find_triggers_blocks``/``find_triggers_kernel``) and
the dynamic-threshold mode are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from detprocess_tpu_torch.ops import fft
from detprocess_tpu_torch.ops.filterbank import OFNxMBank

_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _as(a, like: torch.Tensor, complex_: bool = False) -> torch.Tensor:
    """``a`` (numpy or tensor) as a tensor on ``like``'s device, in its
    real dtype or the complex counterpart (no copy when it already is)."""
    dtype = _COMPLEX[like.dtype] if complex_ else like.dtype
    return torch.as_tensor(a, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# host precompute
# ---------------------------------------------------------------------------

def chi2_threshold(thresh_sigma: float, m_amplitudes: int) -> float:
    """Sigma-level → χ²_M threshold (oftrigger.py:961-973): for thresh < 25
    the χ² value whose M-degree-of-freedom survival function equals the
    two-sided normal tail 2·sf(thresh), i.e. gammainccinv(M/2, ·)·2; else
    thresh². Solved by bisection on the regularized upper incomplete gamma
    function, to the last bit of a double."""
    if thresh_sigma >= 25:
        return float(thresh_sigma ** 2)
    p = math.erfc(thresh_sigma / math.sqrt(2.0))
    a = torch.tensor(m_amplitudes / 2.0, dtype=torch.float64)

    def survival(c):
        return float(torch.special.gammaincc(
            a, torch.tensor(c / 2.0, dtype=torch.float64)))

    lo, hi = 0.0, 1.0
    while survival(hi) > p:
        lo, hi = hi, 2.0 * hi
    while True:
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            return hi
        if survival(mid) > p:
            lo = mid
        else:
            hi = mid


class TriggerKernel(NamedTuple):
    """Trigger precompute, natural spectral layout. Array fields are host
    numpy from :func:`make_trigger_kernel`; the device functions take them
    as numpy or as tensors on the trace's device."""

    g_fft: np.ndarray          # [C, M, F//2+1] complex — rfft of the linear
                               # matched filters, zero-padded to F
    iw_matrix: np.ndarray      # [M, M]
    response: np.ndarray       # [M, M, 2·Nt−1] Δχ²-subtraction responses:
                               # response[i, j] = (filter_i ⋆ template_j)
    nt: int                    # template length
    pretrigger: int
    fs: float
    block: int                 # overlap-save valid samples per segment B
    fft_size: int              # F = B + overlap, overlap ≥ Nt − 1
    resolution: np.ndarray     # per-amplitude σ


def _fir_layout(g: np.ndarray, block: int, real_dtype):
    """Overlap-save sizing for time-domain kernels g [C, M, Nt]: the FFT
    size F is a power of two ≥ ``block`` and ≥ twice the overlap H (Nt−1
    rounded up to a multiple of 128); each segment contributes B = F − H
    valid samples. Returns (rfft of g zero-padded to F, B, F)."""
    c, m, n = g.shape
    overlap = max(128 * int(np.ceil((n - 1) / 128)), 128)
    f_size = int(2 ** np.ceil(np.log2(max(block, 2 * overlap))))
    g_pad = np.zeros((c, m, f_size))
    g_pad[..., :n] = g
    cdtype = np.complex64 if real_dtype == np.float32 else np.complex128
    g_fft = np.fft.rfft(g_pad, axis=-1).astype(cdtype)
    return g_fft, f_size - overlap, f_size


def make_trigger_kernel(bank: OFNxMBank, block: int = 16384,
                        real_dtype=np.float32) -> TriggerKernel:
    """Build the continuous-trigger kernel from an NxM OF bank.

    The circular matched filter is w = N·ifft(Phi); the linear FIR kernel
    is h(j) = w((j − (N−1)) mod N), so that with y = conv(x, h) the
    amplitude numerator is q(T) = y[T + N−1−pretrigger]."""
    c, m, n = bank.templates.shape
    w_circ = np.real(np.fft.ifft(bank.phi, axis=-1)) * n    # [C, M, N]
    g = np.roll(w_circ, n - 1, axis=-1)
    g_fft, block, f_size = _fir_layout(g, block, real_dtype)

    # filter i applied to a unit pulse of template j as a function of the
    # lag d: resp_ij(d) = Re Σ_{c,k} Phi[c,i,k]·S̃[c,j,k]·e^{2πikd/N}, on a
    # symmetric lag axis −(N−1)..(N−1)
    cross = np.einsum("cik,cjk->ijk", bank.phi, bank.s_fft)
    resp_circ = np.real(np.fft.ifft(cross, axis=-1)) * n     # [M, M, N]
    resp = np.concatenate([resp_circ[..., -(n - 1):], resp_circ], axis=-1)

    return TriggerKernel(
        g_fft=g_fft,
        iw_matrix=bank.iw_matrix.astype(real_dtype),
        response=resp.astype(real_dtype),
        nt=n, pretrigger=bank.pretrigger, fs=bank.fs, block=block,
        fft_size=f_size, resolution=bank.resolution.astype(real_dtype),
    )


class ResidualBasis(NamedTuple):
    """Fixed convolution basis of the residual subtraction: the Δχ² shape
    of a trigger with amplitudes â is Σ_{j≤j'} â_j·â_j'·G_{jj'}(t − start)
    over M(M+1)/2 kernels G (off-diagonal pairs doubled), so the whole
    subtraction is spikes plus one overlap-save convolution."""

    fir: TriggerKernel   # P-channel, one-output FIR over the basis
                         # (nt = 2Nt−1, pretrigger = nt−1: plain convolution)
    j1: np.ndarray       # [P] template-pair indices, j1 ≤ j2
    j2: np.ndarray


def make_residual_basis(kernel: TriggerKernel,
                        block: Optional[int] = None) -> ResidualBasis:
    """The Δχ²-subtraction basis of a trigger kernel (host, once per
    channel). Default sizing: F = 4× the overlap, at least 16384."""
    resp = np.asarray(kernel.response, np.float64)          # [M, M, seg]
    iw = np.asarray(kernel.iw_matrix, np.float64)
    m, _, seg = resp.shape
    if block is None:
        overlap = max(128 * int(np.ceil((seg - 1) / 128)), 128)
        block = max(16384, 4 * overlap)
    gfull = np.einsum("abl,ac,cdl->bdl", resp, iw, resp)    # [M, M, seg]
    j1, j2 = np.triu_indices(m)
    basis = gfull[j1, j2] * np.where(j1 == j2, 1.0, 2.0)[:, None]
    real_dtype = np.asarray(kernel.response).dtype
    g_fft, blk, f_size = _fir_layout(basis[:, None, :], block, real_dtype)
    fir = TriggerKernel(
        g_fft=g_fft, iw_matrix=np.eye(1, dtype=real_dtype),
        response=np.zeros((1, 1, 1), real_dtype),
        nt=seg, pretrigger=seg - 1, fs=kernel.fs, block=blk,
        fft_size=f_size, resolution=np.ones(1, real_dtype))
    return ResidualBasis(fir=fir, j1=j1.astype(np.int64),
                         j2=j2.astype(np.int64))


# ---------------------------------------------------------------------------
# FIR and Δχ²
# ---------------------------------------------------------------------------

def fir_segments(trace: torch.Tensor, kernel: TriggerKernel) -> torch.Tensor:
    """Overlap-save segments [..., C, nb, F] (contiguous) of ``trace``
    [..., C, L]: segment i is samples [i·B − p, i·B − p + F) with zeros
    outside the trace, p the pretrigger, nb = ⌈L/B⌉. The left shift by p
    makes the segment's valid outputs q[i·B + j] for j < B."""
    l = trace.shape[-1]
    b, f, p = kernel.block, kernel.fft_size, kernel.pretrigger
    nblocks = -(-l // b)
    xpad = torch.nn.functional.pad(trace, (p, (nblocks - 1) * b + f - p - l))
    return xpad.unfold(-1, f, b).contiguous()


def fir_spectra(trace: torch.Tensor, kernel: TriggerKernel) -> torch.Tensor:
    """Half spectra [..., C, nb, F/2+1] of the overlap-save segments of
    ``trace`` [..., C, L], in one call to :func:`fft.rfft` over all of
    them (the hand-written kernel on the card at F = 256 … 32768)."""
    seg = fir_segments(trace, kernel)                        # [.., C, nb, F]
    return fft.rfft(seg.reshape(-1, kernel.fft_size)).reshape(
        *seg.shape[:-1], -1)


def fir_mix(seg_fft: torch.Tensor, g_fft) -> torch.Tensor:
    """Channel mix of segment spectra [..., C, nb, F/2+1] with the filter
    spectra [C, M, F/2+1] → [..., M, nb, F/2+1]."""
    return torch.einsum("...cbf,cmf->...mbf", seg_fft,
                        _as(g_fft, seg_fft.real, complex_=True))


def fir_inverse(y_fft: torch.Tensor, kernel: TriggerKernel, l: int,
                valid_range: Optional[tuple] = None):
    """The valid outputs of the segments' convolutions, from their spectra
    y_fft [..., M, nb, F/2+1], as (q_blocks [..., M, nb, B] with q[T] =
    q_blocks[..., T//B, T%B], valid [nb, B]); samples outside [lo, hi)
    are zeroed, by default the first and last Nt of the trace (the
    reference's padding cut, oftrigger.py:674-679)."""
    nt, b = kernel.nt, kernel.block
    y_seg = fft.irfft(y_fft, kernel.fft_size)
    nblocks = y_seg.shape[-2]
    tpos = (torch.arange(nblocks, device=y_seg.device)[:, None] * b
            + torch.arange(b, device=y_seg.device)[None, :])
    lo, hi = (nt, l - nt) if valid_range is None else valid_range
    valid = (tpos >= lo) & (tpos < min(hi, l))
    return y_seg[..., nt - 1: nt - 1 + b] * valid, valid


def of_fir_blocks(trace: torch.Tensor, kernel: TriggerKernel,
                  valid_range: Optional[tuple] = None):
    """Overlap-save FIR: trace [..., C, L] → (q_blocks [..., M, nb, B],
    valid [nb, B]), nb·B ≥ L. One rFFT call over all segments of all
    events and channels, the channel mix, one irfft. ``valid_range``
    overrides the zeroed edges: q is kept for T in [lo, hi)."""
    spec = fir_mix(fir_spectra(trace, kernel), kernel.g_fft)
    return fir_inverse(spec, kernel, trace.shape[-1], valid_range)


def of_fir(trace: torch.Tensor, kernel: TriggerKernel,
           valid_range=None) -> torch.Tensor:
    """Overlap-save FIR: continuous trace [..., C, L] → q [..., M, L]."""
    l = trace.shape[-1]
    q_blocks, _ = of_fir_blocks(trace, kernel, valid_range=valid_range)
    return q_blocks.flatten(-2)[..., :l]


def delta_chi2(q: torch.Tensor, iw_matrix):
    """(Δχ²(t) [..., L], amplitudes a(t) [..., M, L]) from q [..., M, L]."""
    amps = torch.einsum("ij,...jt->...it", _as(iw_matrix, q), q)
    return torch.einsum("...it,...it->...t", amps, q), amps


def delta_chi2_blocks(q_blocks: torch.Tensor, iw_matrix):
    """Block layout: q [..., M, R, B] → (Δχ² [..., R, B], amps
    [..., M, R, B])."""
    amps = torch.einsum("ij,...jrb->...irb", _as(iw_matrix, q_blocks),
                        q_blocks)
    return torch.einsum("...irb,...irb->...rb", amps, q_blocks), amps


def delta_chi2_from_q(q_blocks: torch.Tensor, iw_matrix) -> torch.Tensor:
    """Δχ²(t) = q(t)ᵀW⁻¹q(t) [..., R, B] without keeping the amplitude
    series (pair with ``find_triggers_tiled(..., amps_transform=iw)``)."""
    return torch.einsum("...irb,ij,...jrb->...rb", q_blocks,
                        _as(iw_matrix, q_blocks), q_blocks)


# ---------------------------------------------------------------------------
# threshold and pileup merge
# ---------------------------------------------------------------------------

class TriggerSet(NamedTuple):
    """Fixed-capacity trigger lists, batched over leading dimensions."""

    indices: torch.Tensor      # [..., K] int64, -1 = empty slot
    dchi2: torch.Tensor        # [..., K]
    amplitudes: torch.Tensor   # [..., M, K]
    count: torch.Tensor        # [...] valid entries (≤ K)
    count_total: torch.Tensor  # [...] merged groups found; > count when
                               # the capacity truncated the list


def _tile_size(pileup_window: int, cap: int = 2048) -> int:
    """Largest power-of-two tile G with G − 1 ≤ pileup_window (so all
    above-threshold samples inside one tile always merge)."""
    return min(1 << int(np.floor(np.log2(max(pileup_window, 0) + 1))), cap)


def find_triggers_tiled(dchi2: torch.Tensor, amps: torch.Tensor,
                        threshold: float, pileup_window: int,
                        capacity: int,
                        amps_transform=None) -> TriggerSet:
    """Threshold + pileup merge: dchi2 [..., R, B] and amps [..., M, R, B]
    (time t = r·B + b) → a :class:`TriggerSet` of capacity K.

    Above-threshold samples with successive gaps ≤ ``pileup_window`` form
    one trigger at the first sample that reaches the group's maximum Δχ²
    (oftrigger.py:29-74, :996-1019). With tiles of G =
    2^⌊log2(window+1)⌋ samples, all above-threshold samples of one tile
    merge, so one pass reduces each tile to its maximum, argmax and
    first/last above-threshold index, and the merge runs on the L/G tile
    summaries: group starts from the running maximum of the previous
    tiles' last index (``torch.cummax``), group maxima and first achievers
    by ``scatter_reduce`` over the group ids. Winners come in time order,
    so the compaction to K = min(capacity, L/G) is a cumulative count.
    With ``amps_transform`` [M, M'], ``amps`` is the raw filter output
    q [..., M', R, B] and the amplitudes are ``amps_transform @ q`` at the
    winners only.
    """
    batch = dchi2.shape[:-2]
    m = amps.shape[-3]
    l = dchi2.shape[-2] * dchi2.shape[-1]
    d = dchi2.reshape(-1, l)
    a = amps.reshape(-1, m, l)
    nev = d.shape[0]
    g = _tile_size(pileup_window)
    pad = (-l) % g
    if pad:
        # below-threshold padding never triggers or merges
        d = torch.nn.functional.pad(d, (0, pad), value=-math.inf)
        a = torch.nn.functional.pad(a, (0, pad))
    nt = (l + pad) // g
    dev = d.device
    d = d.reshape(nev, nt, g)

    # per-tile summaries
    col = torch.arange(g, device=dev)
    above = d > threshold
    tile_max, tile_arg = torch.max(torch.where(above, d, -math.inf), dim=-1)
    first_in = torch.where(above, col, g).amin(dim=-1)
    last_in = torch.where(above, col, -1).amax(dim=-1)
    has = last_in >= 0
    base = torch.arange(nt, device=dev) * g
    last_idx = torch.where(has, base + last_in, -1)

    # tile-level merge: a tile starts a group when no earlier tile has an
    # above-threshold sample within the pileup window before its first one
    prev_last = torch.nn.functional.pad(
        torch.cummax(last_idx, dim=-1).values[:, :-1], (1, 0), value=-1)
    start = has & ((prev_last < 0)
                   | (base + first_in - prev_last > pileup_window))
    gid = torch.cumsum(start, dim=-1)                  # 0 before any group
    group_max = torch.full((nev, nt + 1), -math.inf, dtype=d.dtype,
                           device=dev).scatter_reduce(
        -1, gid, tile_max, "amax")
    reach = has & (tile_max == group_max.gather(-1, gid))
    tile = torch.arange(nt, device=dev).expand(nev, nt)
    first_reach = torch.full((nev, nt + 1), nt, device=dev).scatter_reduce(
        -1, gid, torch.where(reach, tile, nt), "amin")
    winner = reach & (tile == first_reach.gather(-1, gid))
    count_total = start.sum(dim=-1)
    # as in the JAX package, no more slots than tiles (one winner a tile)
    capacity = min(capacity, nt)

    # compaction: winners are in time order; slot K collects the dropped
    slot = torch.cumsum(winner, dim=-1) - 1
    slot = torch.where(winner & (slot < capacity), slot, capacity)
    idx = torch.full((nev, capacity + 1), -1, dtype=torch.int64, device=dev)
    idx.scatter_(-1, slot, base + tile_arg)
    val = torch.zeros((nev, capacity + 1), dtype=d.dtype, device=dev)
    val.scatter_(-1, slot, tile_max)
    cand_amp = a.reshape(nev, m, nt, g).gather(
        -1, tile_arg[:, None, :, None].expand(nev, m, nt, 1))[..., 0]
    amp = torch.zeros((nev, m, capacity + 1), dtype=a.dtype, device=dev)
    amp.scatter_(-1, slot[:, None, :].expand(nev, m, nt), cand_amp)
    amp = amp[..., :capacity]
    if amps_transform is not None:
        amp = torch.einsum("ij,ejk->eik", _as(amps_transform, amp), amp)
    return TriggerSet(
        indices=idx[:, :capacity].reshape(*batch, capacity),
        dchi2=val[:, :capacity].reshape(*batch, capacity),
        amplitudes=amp.reshape(*batch, amp.shape[-2], capacity),
        count=torch.clamp(count_total, max=capacity).reshape(batch),
        count_total=count_total.reshape(batch),
    )


# ---------------------------------------------------------------------------
# saturation veto and residual re-trigger
# ---------------------------------------------------------------------------

def _dilate(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[i] = max x[i−w … i+w] over the last axis (zeros outside): a
    stride-1 max-pool of width k = 2w+1 in O(L), from prefix and suffix
    running maxima over blocks of k samples (van Herk / Gil-Werman)."""
    k = 2 * w + 1
    l = x.shape[-1]
    m = -(-(l + 2 * w) // k) * k
    xb = torch.nn.functional.pad(x, (w, m - l - w)).reshape(
        *x.shape[:-1], m // k, k)
    pre = torch.cummax(xb, dim=-1).values.flatten(-2)
    suf = torch.cummax(xb.flip(-1), dim=-1).values.flip(-1).flatten(-2)
    return torch.maximum(suf[..., :l], pre[..., k - 1: k - 1 + l])


def saturation_mask(lpf_trace: torch.Tensor, sat_amplitudes, window: int,
                    positive_pulses: bool = True) -> torch.Tensor:
    """Per-sample saturation flag [..., L] of low-passed traces [..., C, L]:
    any channel beyond its saturation amplitude within ±window samples
    (oftrigger.py:776-787)."""
    sat = _as(sat_amplitudes, lpf_trace)[:, None]
    over = (lpf_trace > sat) if positive_pulses else (lpf_trace < -sat)
    return _dilate(over.any(dim=-2).to(torch.int32), window) > 0


def residual_subtract_conv(dchi2: torch.Tensor, triggers: TriggerSet,
                           kernel: TriggerKernel, basis: ResidualBasis,
                           saturated: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Subtract each trigger's best-fit Δχ² response from Δχ²
    (oftrigger.py:789-817), skipping saturated triggers.

    Each trigger's response shape d(t) = q_respᵀ W⁻¹ q_resp is aligned on
    its own argmax at the trigger index; per basis pair the trigger puts
    one spike â_j1·â_j2 at its aligned start (``index_add_``), and one
    overlap-save convolution with the basis (:func:`of_fir_blocks`) gives
    the trace to subtract. ``dchi2`` is [..., L] or [..., R, B] with the
    batch dimensions of ``triggers``; the result has its shape. Only the
    slots up to the last valid one of any event are aligned, which needs
    one read of the trigger indices on the host."""
    nbatch = triggers.indices.ndim - 1
    batch = triggers.indices.shape[:-1]
    d_flat = dchi2.reshape(*batch, -1)
    l = d_flat.shape[-1]
    resp = _as(kernel.response, d_flat)                  # [M, M, seg]
    iw = _as(kernel.iw_matrix, d_flat)
    seg = resp.shape[-1]

    valid = triggers.indices >= 0
    if saturated is not None:
        valid = valid & ~saturated.gather(-1, triggers.indices.clamp(min=0))
    cap = valid.shape[-1]
    used = valid.reshape(-1, cap).any(dim=0)
    k = int(torch.where(used, torch.arange(1, cap + 1, device=used.device),
                        0).max())
    amps = triggers.amplitudes[..., :k]                  # [..., M, k]
    valid = valid[..., :k]

    # alignment: argmax of each trigger's own response shape
    q_resp = torch.einsum("ijl,...jk->...kil", resp, amps)
    d_resp = torch.einsum("...kil,ij,...kjl->...kl", q_resp, iw, q_resp)
    peak = torch.argmax(d_resp, dim=-1)

    j1 = torch.as_tensor(basis.j1, device=amps.device)
    j2 = torch.as_tensor(basis.j2, device=amps.device)
    coeff = amps[..., j1, :] * amps[..., j2, :] * valid[..., None, :]
    # spikes on an axis padded left by seg, so that starts down to
    # −(seg−1) stay in bounds; the final slice drops what falls outside
    pos = torch.clamp(triggers.indices[..., :k] - peak + seg, 0,
                      l + seg - 1)
    npair = coeff.shape[-2]
    rows = torch.arange(math.prod(batch) * npair,
                        device=amps.device).reshape(*batch, npair, 1)
    spikes = torch.zeros((*batch, npair, l + seg), dtype=d_flat.dtype,
                         device=d_flat.device)
    spikes.view(-1).index_add_(
        0, (rows * (l + seg) + pos[..., None, :]).reshape(-1),
        coeff.reshape(-1))
    # basis.fir has pretrigger nt−1: q(T) = conv(spikes, G)(T), and the
    # subtraction at trace index t is q(t + seg)
    qb, _ = of_fir_blocks(spikes, basis.fir, valid_range=(0, l + seg))
    sub = qb[..., 0, :, :].flatten(-2)[..., seg: seg + l]
    return (d_flat - sub).reshape(dchi2.shape)


def combine_trigger_sets(first: TriggerSet,
                         second: TriggerSet) -> TriggerSet:
    """Merge one event's first-pass and residual-pass trigger sets without
    duplicating trigger indices (host numpy; ``combine_trigger_data``
    semantics, reference core/oftrigger.py:262-321): the first pass's
    entries are all kept; entries of the second whose index is not
    already present are appended in order. The capacity is the sum of
    both; ``count_total`` adds the new groups and the second pass's
    truncated ones to the first pass's total."""
    host = {name: [_host(getattr(ts, name)) for ts in (first, second)]
            for name in TriggerSet._fields}
    (idx1, idx2), (d1, d2), (a1, a2) = (host["indices"], host["dchi2"],
                                        host["amplitudes"])
    n1, n2 = (int(c) for c in host["count"])
    keep1 = idx1[:n1]
    new_mask = ~np.isin(idx2[:n2], keep1) & (idx2[:n2] >= 0)
    new_pos = np.flatnonzero(new_mask)
    n_new = len(new_pos)

    cap = idx1.shape[0] + idx2.shape[0]
    indices = np.full(cap, -1, dtype=idx1.dtype)
    indices[:n1] = keep1
    indices[n1:n1 + n_new] = idx2[:n2][new_pos]
    dchi2 = np.zeros(cap, dtype=d1.dtype)
    dchi2[:n1] = d1[:n1]
    dchi2[n1:n1 + n_new] = d2[:n2][new_pos]
    amps = np.zeros((a1.shape[0], cap), dtype=a1.dtype)
    amps[:, :n1] = a1[:, :n1]
    amps[:, n1:n1 + n_new] = a2[:, :n2][:, new_pos]

    # groups the second pass found but could not keep have unknown
    # indices: count them as new, so the truncation stays visible
    trunc2 = int(host["count_total"][1]) - n2
    total = int(host["count_total"][0]) + n_new + max(trunc2, 0)
    return TriggerSet(indices=indices, dchi2=dchi2, amplitudes=amps,
                      count=np.int64(n1 + n_new), count_total=np.int64(total))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def event_set(ts: TriggerSet, e: int) -> TriggerSet:
    """Event ``e`` of a batched trigger set, as host numpy arrays."""
    return TriggerSet(*(_host(field[e]) for field in ts))
