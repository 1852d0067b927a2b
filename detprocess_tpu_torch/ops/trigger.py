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

Pileup windows below 7 samples run the same tiled merge at G = 1, 2 or
4 (:func:`find_triggers_blocks`, :func:`find_triggers_kernel`). The
dynamic-threshold mode (:func:`find_triggers_dynamic_batched`) compacts
the above-threshold samples, or runs of them that provably merge, into
candidate units and walks them in time order on the device, one small
step of [E]-shaped ops a unit, with one host read of the unit count a
merge. :func:`find_triggers_dynamic` is the host loop of the reference
for any Python callable, and :func:`shift_templates_to_match_chi2` aligns
templates on the trigger's Δχ² peak.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import fft, filterbank
from detprocess_tpu_torch.ops.filterbank import OFNxMBank
from detprocess_tpu_torch.parallel import collectives as col
from detprocess_tpu_torch.utils.logging import span

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
    n_above: Optional[torch.Tensor] = None
                               # [...] dynamic merge only: candidate units
                               # found (above-threshold samples, or
                               # pre-merged runs of them); above the
                               # candidate capacity, later units were
                               # dropped and the winners may be wrong
    n_vetoed: Optional[torch.Tensor] = None
                               # [...] residual pass with a saturation
                               # veto only: first-pass triggers the veto
                               # kept out of the subtraction


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
    tile_max, tile_arg, first_in, last_in, has = _tile_summaries(
        d.reshape(nev, nt, g), threshold)
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
    winner = _first_reach(reach, gid)
    count_total = start.sum(dim=-1)
    idx, val, amp = _compact_winners(winner, base, tile_arg, tile_max, a,
                                     g, capacity, amps_transform)
    capacity = idx.shape[-1]
    return TriggerSet(
        indices=idx.reshape(*batch, capacity),
        dchi2=val.reshape(*batch, capacity),
        amplitudes=amp.reshape(*batch, amp.shape[-2], capacity),
        count=torch.clamp(count_total, max=capacity).reshape(batch),
        count_total=count_total.reshape(batch),
    )


def _tile_summaries(d: torch.Tensor, threshold: float):
    """Per tile of d [..., T, G]: (maximum of the above-threshold samples,
    −inf in a tile without any; its argmax; the first and the last
    above-threshold column, G and −1 without any; whether it has one)."""
    g = d.shape[-1]
    col = torch.arange(g, device=d.device)
    above = d > threshold
    tile_max, tile_arg = torch.max(torch.where(above, d, -math.inf), dim=-1)
    first_in = torch.where(above, col, g).amin(dim=-1)
    last_in = torch.where(above, col, -1).amax(dim=-1)
    return tile_max, tile_arg, first_in, last_in, last_in >= 0


def _first_reach(reach: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The first tile of each group id ``gid`` [E, T] among those that
    ``reach`` its maximum."""
    nev, nt = reach.shape
    tile = torch.arange(nt, device=reach.device).expand(nev, nt)
    first = torch.full((nev, nt + 1), nt, device=reach.device).scatter_reduce(
        -1, gid, torch.where(reach, tile, nt), "amin")
    return reach & (tile == first.gather(-1, gid))


def _compact_winners(winner, base, tile_arg, tile_max, a, g, capacity,
                     amps_transform=None):
    """The winners [E, T] (in time order) compacted to K = min(capacity,
    T) slots: (indices base + argmax [E, K] int64, −1 empty; Δχ² [E, K];
    amplitudes [E, M, K], from a [E, M, T·G] or, with ``amps_transform``
    [M, M'], ``amps_transform`` times a raw q [E, M', T·G])."""
    nev, nt = winner.shape
    m = a.shape[-2]
    dev = winner.device
    # as in the JAX package, no more slots than tiles (one winner a tile)
    capacity = min(capacity, nt)
    # slot K collects the dropped
    slot = torch.cumsum(winner, dim=-1) - 1
    slot = torch.where(winner & (slot < capacity), slot, capacity)
    idx = torch.full((nev, capacity + 1), -1, dtype=torch.int64, device=dev)
    idx.scatter_(-1, slot, (base + tile_arg).to(torch.int64))
    val = torch.zeros((nev, capacity + 1), dtype=tile_max.dtype, device=dev)
    val.scatter_(-1, slot, tile_max)
    cand_amp = a.reshape(nev, m, nt, g).gather(
        -1, tile_arg[:, None, :, None].expand(nev, m, nt, 1))[..., 0]
    amp = torch.zeros((nev, m, capacity + 1), dtype=a.dtype, device=dev)
    amp.scatter_(-1, slot[:, None, :].expand(nev, m, nt), cand_amp)
    amp = amp[..., :capacity]
    if amps_transform is not None:
        amp = torch.einsum("ij,ejk->eik", _as(amps_transform, amp), amp)
    return idx[:, :capacity], val[:, :capacity], amp


def find_triggers_blocks(dchi2: torch.Tensor, amps: torch.Tensor,
                         threshold: float, pileup_window: int,
                         capacity: int) -> TriggerSet:
    """Threshold + pileup merge on block-layout inputs dchi2 [..., R, B],
    amps [..., M, R, B] (JAX ``find_triggers_blocks`` :558). The JAX
    package sends windows below 7 samples to flat segmented scans over
    256-sample rows; :func:`find_triggers_tiled` is exact for every tile
    G with G − 1 ≤ window, so it runs here at G = 1, 2 or 4 as well."""
    return find_triggers_tiled(dchi2, amps, threshold, pileup_window,
                               capacity)


def find_triggers_kernel(dchi2: torch.Tensor, amps: torch.Tensor,
                         threshold: float, pileup_window: int,
                         capacity: int) -> TriggerSet:
    """Flat inputs dchi2 [..., L], amps [..., M, L] (JAX
    ``find_triggers_kernel`` :623, which pads to whole blocks with −inf,
    as :func:`find_triggers_tiled` pads to whole tiles)."""
    return find_triggers_tiled(dchi2[..., None, :], amps[..., None, :],
                               threshold, pileup_window, capacity)


def find_triggers_sharded(mesh, dchi2, amps, threshold: float,
                          pileup_window: int, capacity: int,
                          t_offsets) -> list:
    """The merge of :func:`find_triggers_tiled` on the time shards of one
    long trace (JAX ``find_triggers_sharded`` :753 and
    ``find_triggers_sharded_tiled`` :643): ``dchi2`` and ``amps`` are this
    process's shards of the mesh ``mesh`` (``parallel/collectives.Mesh``),
    one [L] and one [M, L] a shard on its device, each shard the global
    samples from its ``t_offsets`` entry on. Returns one
    :class:`TriggerSet` a shard, with global int64 indices, its own winners
    in at most ``capacity`` slots (``count``) and the global group count
    (``count_total``, one psum).

    Each shard reduces its tiles as the unsharded merge does; the shards
    then exchange a handful of values by ``all_gather``: the largest
    last-above index (whether a shard's first tiles merge with an earlier
    shard's), whether the shard holds a group start, the maximum of its
    tiles before its first start and the maximum at its end. From these
    each shard has the maximum that the group open at its start reached
    before it, and the maximum that the group open at its end reaches
    after it, so a group that crosses one boundary or several (a shard
    with no start of its own included) gets one winner, at the first
    global position that reaches its maximum. Every shard's length must be
    a multiple of the tile G."""
    g = _tile_size(pileup_window)
    shards = []
    for d, t0 in zip(dchi2, t_offsets):
        l = d.numel()
        if l % g:
            raise ValueError(f"a shard of {l} samples is not a whole number "
                             f"of tiles of {g} (pileup window "
                             f"{pileup_window})")
        nt = l // g
        tile_max, tile_arg, first_in, last_in, has = _tile_summaries(
            d.reshape(1, nt, g), threshold)
        base = torch.arange(nt, device=d.device) * g + int(t0)
        last_idx = torch.where(has, base + last_in, -1)
        shards.append((nt, tile_max, tile_arg, first_in, has, base,
                       last_idx))

    # the last above-threshold index of every earlier shard
    last_all = col.all_gather(mesh, [s[6].amax() for s in shards])
    prev_carry = torch.nn.functional.pad(
        torch.cummax(last_all, dim=0).values[:-1], (1, 0), value=-1)
    local = []
    for i, (nt, tile_max, tile_arg, first_in, has, base,
            last_idx) in enumerate(shards):
        dev = tile_max.device
        prev_last = torch.maximum(
            torch.nn.functional.pad(torch.cummax(last_idx, dim=-1).values[
                :, :-1], (1, 0), value=-1),
            prev_carry[mesh.offset + i].to(dev))
        start = has & ((prev_last < 0)
                       | (base + first_in - prev_last > pileup_window))
        gid = torch.cumsum(start, dim=-1)
        group_max = torch.full((1, nt + 1), -math.inf, dtype=tile_max.dtype,
                               device=dev).scatter_reduce(
            -1, gid, tile_max, "amax")
        # before its first start, a shard's tiles continue the group open
        # at its left; after its last start, the group runs on to the right
        local.append((start, gid, group_max, start.any(), group_max[0, 0],
                      group_max[0, gid[0, -1]]))

    starts = col.all_gather(mesh, [s[3] for s in local])
    heads = col.all_gather(mesh, [s[4] for s in local])
    ends = col.all_gather(mesh, [s[5] for s in local])
    neg = torch.full((), -math.inf, dtype=heads.dtype, device=heads.device)
    from_left = [neg]                 # the open group's maximum before shard s
    for s in range(mesh.size - 1):
        from_left.append(torch.where(starts[s], ends[s],
                                     torch.maximum(from_left[-1], ends[s])))
    from_right = [neg]                # … and after shard s
    for s in range(mesh.size - 1, 0, -1):
        from_right.append(torch.where(starts[s], heads[s],
                                      torch.maximum(from_right[-1],
                                                    heads[s])))
    from_right = from_right[::-1]

    count_total = col.psum(mesh, [s[0].sum() for s in local])
    out = []
    for i, ((nt, tile_max, tile_arg, _, has, base, _),
            (start, gid, group_max, _, _, _)) in enumerate(zip(shards,
                                                               local)):
        dev = tile_max.device
        left = from_left[mesh.offset + i].to(dev)
        right = from_right[mesh.offset + i].to(dev)
        pos = torch.arange(nt + 1, device=dev)
        total = torch.where(pos == 0, torch.maximum(group_max, left),
                            group_max)
        total = torch.where(pos == gid[0, -1], torch.maximum(total, right),
                            total)
        reach = has & (tile_max == total.gather(-1, gid))
        # the group open at the left reached its maximum before this shard
        reach = reach & ~((gid == 0) & (left >= total[0, 0]))
        winner = _first_reach(reach, gid)
        a = amps[i].reshape(1, amps[i].shape[-2], -1)
        idx, val, amp = _compact_winners(winner, base, tile_arg, tile_max, a,
                                         g, capacity)
        out.append(TriggerSet(
            indices=idx[0], dchi2=val[0], amplitudes=amp[0],
            count=torch.clamp(winner.sum(), max=idx.shape[-1]),
            count_total=count_total.to(dev)))
    return out


# ---------------------------------------------------------------------------
# dynamic-window merge
# ---------------------------------------------------------------------------

_WALK = {"merges": 0, "steps": 0, "syncs": 0}


def reset_walk_counts() -> None:
    """Set the dynamic walk's counters to 0."""
    for key in _WALK:
        _WALK[key] = 0


def walk_counts() -> dict:
    """The dynamic merges run since the last reset: merges, walk steps
    (one a candidate unit of the batch's fullest event) and host reads."""
    return dict(_WALK)


WINDOW_FN_CONTRACT = (
    "window_fn must map a tensor of running group maxima of Δχ² to a "
    "tensor of merge windows (samples) of the same shape, with torch ops "
    "that torch.func.vmap can run per lane (no Python branch on a value, "
    "no numpy)")


def _per_lane_window_fn(window_fn, dtype):
    """``window_fn`` lifted per lane of an [E] probe with
    ``torch.func.vmap`` (JAX ``_per_lane_window_fn`` :1133); the
    ``+ 0·s`` term makes a function that returns a constant batch too."""
    def lane(s):
        w = window_fn(s)
        if not isinstance(w, torch.Tensor):
            w = torch.tensor(w, dtype=dtype, device=s.device)
        return w.to(dtype) + 0 * s
    return torch.func.vmap(lane)


def check_window_fn(window_fn) -> None:
    """Raise ``ValueError`` naming the contract when ``window_fn`` does not
    run per lane on a 2-element tensor (a Python branch on a value, which
    JAX writes as ``lax.cond``, cannot)."""
    probe = torch.tensor([25.0, 1e4], dtype=torch.float64)
    try:
        w = _per_lane_window_fn(window_fn, torch.float64)(probe)
    except Exception as exc:  # any failure of the caller's function
        raise ValueError(f"{WINDOW_FN_CONTRACT}; on a 2-element tensor it "
                         f"raised {type(exc).__name__}: {exc}") from exc
    if w.shape != probe.shape:
        raise ValueError(f"{WINDOW_FN_CONTRACT}; on a 2-element tensor it "
                         f"returned shape {tuple(w.shape)}")


def _compact_above(dchi2: torch.Tensor, threshold: float,
                   candidate_capacity: int):
    """The first K above-threshold samples of each event [E, L] in time
    order (JAX ``_compact_above`` :870): (indices [E, K] with sentinel L,
    values [E, K] with sentinel −inf, valid [E, K], n_above [E]). One
    cumulative count of the above mask and one scatter of the sample
    indices to their ranks; no host read."""
    e, l = dchi2.shape
    k = candidate_capacity
    above = dchi2 > threshold
    rank = torch.cumsum(above, dim=-1)                    # inclusive
    n_above = rank[:, -1]
    slot = torch.where(above & (rank <= k), rank - 1, k)  # k: dropped
    idx = torch.full((e, k + 1), l, dtype=torch.int64, device=dchi2.device)
    idx.scatter_(-1, slot, torch.arange(l, device=dchi2.device).expand(e, l))
    idx = idx[:, :k]
    valid = torch.arange(k, device=dchi2.device) < n_above[:, None]
    val = torch.where(valid, dchi2.gather(-1, idx.clamp(max=l - 1)),
                      -math.inf)
    return idx, val, valid, n_above


def _static_premerge_window(window_fn, threshold) -> int:
    """floor(window_fn(threshold)), or 0 when that raises (JAX :927)."""
    try:
        w = window_fn(torch.tensor(float(threshold), dtype=torch.float64))
        return int(np.floor(float(w)))
    except (TypeError, ValueError, RuntimeError, AttributeError):
        return 0


def _premerge_candidates(dchi2: torch.Tensor, threshold: float, w0: int,
                         kpg: int):
    """Runs of above-threshold samples with gaps ≤ w0, which always merge
    under a monotonic non-decreasing window function with
    window_fn(threshold) ≥ w0 (JAX ``_premerge_candidates`` :962): the
    static merge of :func:`find_triggers_tiled` at window w0, then per run
    (first index, last index, first value, maximum, first index reaching
    the maximum, valid) [E, kpg] in time order with sentinels L and −inf,
    and the run count [E]; runs past kpg are dropped."""
    e, l = dchi2.shape
    dev_ = dchi2.device
    g = _tile_size(w0)
    pad = (-l) % g
    d = (torch.nn.functional.pad(dchi2, (0, pad), value=-math.inf)
         if pad else dchi2)
    nt = (l + pad) // g
    d = d.reshape(e, nt, g)
    col = torch.arange(g, device=dev_)
    above = d > threshold
    d_eff = torch.where(above, d, -math.inf)
    tile_max, tile_arg = torch.max(d_eff, dim=-1)
    first_in = torch.where(above, col, g).amin(dim=-1)
    last_in = torch.where(above, col, -1).amax(dim=-1)
    has = last_in >= 0
    first_val = d_eff.gather(-1, first_in.clamp(max=g - 1)[..., None])[..., 0]
    base = torch.arange(nt, device=dev_) * g
    first_idx = base + first_in
    last_idx = torch.where(has, base + last_in, -1)
    prev_last = torch.nn.functional.pad(
        torch.cummax(last_idx, dim=-1).values[:, :-1], (1, 0), value=-1)
    start = has & ((prev_last < 0) | (first_idx - prev_last > w0))
    gid = torch.cumsum(start, dim=-1) - 1
    n_runs = start.sum(dim=-1)
    ok = has & (gid >= 0) & (gid < kpg)
    seg = torch.where(ok, gid, kpg)                       # kpg: dropped
    tile = torch.arange(nt, device=dev_).expand(e, nt)

    def reduce(fill, src, how):
        out = torch.full((e, kpg + 1), fill, dtype=src.dtype, device=dev_)
        return out.scatter_reduce(-1, seg, src, how)

    run_max = reduce(-math.inf, tile_max, "amax")
    reach = ok & (tile_max == run_max.gather(-1, seg))
    wt = reduce(nt, torch.where(reach, tile, nt), "amin")[:, :kpg]
    ft = reduce(nt, torch.where(ok, tile, nt), "amin")[:, :kpg]
    run_last = reduce(-1, torch.where(ok, last_idx, -1), "amax")[:, :kpg]
    valid = torch.arange(kpg, device=dev_) < n_runs[:, None]
    wt, ft = wt.clamp(max=nt - 1), ft.clamp(max=nt - 1)
    win = wt * g + tile_arg.gather(-1, wt)
    first = ft * g + first_in.gather(-1, ft)
    fval = first_val.gather(-1, ft)
    return (torch.where(valid, first, l), torch.where(valid, run_last, l),
            torch.where(valid, fval, -math.inf),
            torch.where(valid, run_max[:, :kpg], -math.inf),
            torch.where(valid, win, l), valid, n_runs)


def _dynamic_candidates(dchi2: torch.Tensor, threshold: float, w0: int,
                        candidate_capacity: int):
    """Candidate units of dchi2 [E, L] (pre-merged runs for w0 ≥ 8, else
    above-threshold samples) with the gap of each unit's first sample to
    the previous unit's last (JAX ``_dynamic_candidates`` :1112):
    (gaps, first values, maxima, valid, winner indices, n_above)."""
    if w0 >= 8:
        first_i, last_i, first_v, max_v, win_idx, valid, n_above = \
            _premerge_candidates(dchi2, threshold, w0, candidate_capacity)
    else:
        first_i, max_v, valid, n_above = _compact_above(
            dchi2, threshold, candidate_capacity)
        last_i = win_idx = first_i
        first_v = max_v
    # the first unit's gap is one no window covers: it always starts a group
    prev = torch.nn.functional.pad(last_i[:, :-1], (1, 0), value=-(1 << 30))
    gaps = (first_i - prev).to(dchi2.dtype)
    return gaps, first_v, max_v, valid, win_idx, n_above


def _dynamic_walk(window_fn, gaps, first_v, max_v, valid, n_above):
    """Group-start flags [E, K] from the sequential split walk (JAX
    ``_dynamic_body`` :1152): each unit's boundary is decided at its first
    sample with the window of the running group maximum including that
    sample; the unit then lifts the maximum to its own. One step of
    [E]-shaped ops a unit, up to the largest unit count of the batch,
    which is read once on the host; units past an event's count carry
    ok = False and change nothing."""
    e, k = gaps.shape
    wf = _per_lane_window_fn(window_fn, gaps.dtype)
    n_steps = int(torch.clamp(n_above, max=k).max()) if e else 0
    _WALK["merges"] += 1
    _WALK["syncs"] += 1
    _WALK["steps"] += n_steps
    gmax = torch.full((e,), -math.inf, dtype=gaps.dtype, device=gaps.device)
    flags = []
    for i in range(n_steps):
        ok = valid[:, i]
        probe = torch.maximum(gmax, first_v[:, i])
        start = ok & (gaps[:, i] > wf(probe))
        gmax = torch.where(ok, torch.maximum(
            torch.where(start, -math.inf, gmax), max_v[:, i]), gmax)
        flags.append(start)
    starts = torch.zeros((e, k), dtype=torch.bool, device=gaps.device)
    if flags:
        starts[:, :n_steps] = torch.stack(flags, dim=-1)
    return starts


def _dynamic_winners(starts, max_v, valid, win_idx, amps, capacity, l,
                     amps_transform, n_above) -> TriggerSet:
    """One trigger a group: the first unit reaching the group's maximum
    (JAX ``_dynamic_winners`` :1172), compacted to ``capacity``."""
    e = starts.shape[0]
    dev_ = starts.device
    gid = torch.cumsum(starts, dim=-1) - 1
    ngroups = starts.sum(dim=-1)
    in_cap = valid & (gid >= 0) & (gid < capacity)
    seg = torch.where(in_cap, gid, capacity)              # capacity: dropped
    gmax = torch.full((e, capacity + 1), -math.inf, dtype=max_v.dtype,
                      device=dev_).scatter_reduce(-1, seg, max_v, "amax")
    reach = in_cap & (max_v == gmax.gather(-1, seg))
    big = torch.iinfo(torch.int64).max
    win = torch.full((e, capacity + 1), big, dtype=torch.int64,
                     device=dev_).scatter_reduce(
        -1, seg, torch.where(reach, win_idx, big), "amin")[:, :capacity]
    has = win < big
    idx = torch.where(has, win, -1)
    val = torch.where(has, gmax[:, :capacity], 0.0)
    m = amps.shape[-2]
    amp = amps.gather(-1, idx.clamp(0, l - 1)[:, None, :].expand(
        e, m, capacity))
    if amps_transform is not None:
        amp = torch.einsum("ij,ejk->eik", _as(amps_transform, amp), amp)
    amp = torch.where(idx[:, None, :] >= 0, amp, 0.0)
    return TriggerSet(indices=idx, dchi2=val, amplitudes=amp,
                      count=torch.clamp(ngroups, max=capacity),
                      count_total=ngroups, n_above=n_above)


def find_triggers_dynamic_batched(dchi2: torch.Tensor, amps: torch.Tensor,
                                  threshold: float, window_fn,
                                  capacity: int,
                                  candidate_capacity: int = 4096,
                                  amps_transform=None,
                                  premerge_window: Optional[int] = None
                                  ) -> TriggerSet:
    """Dynamic-window threshold + pileup merge of dchi2 [E, L] with
    amplitudes amps [E, M', L] (JAX ``find_triggers_dynamic_batched``
    :1201, the reference's ``dynamic=True``): successive above-threshold
    samples merge when their gap is at most ``window_fn`` of the running
    maximum Δχ² of the group, the sample considered included.

    ``window_fn`` maps a tensor to a tensor of the same shape
    (:data:`WINDOW_FN_CONTRACT`). The candidate units are the first
    ``candidate_capacity`` above-threshold samples or, for
    ``premerge_window`` w0 ≥ 8, runs of them with gaps ≤ w0; w0 defaults
    to floor(window_fn(threshold)), which is exact only for a monotonic
    non-decreasing ``window_fn``. Pass 0 for sample-level units, exact for
    any function. ``n_above`` above ``candidate_capacity`` means units
    were dropped. With ``amps_transform`` [M, M'], ``amps`` is the raw
    filter output q and the amplitudes are ``amps_transform @ q`` at the
    winners."""
    l = dchi2.shape[-1]
    w0 = (_static_premerge_window(window_fn, threshold)
          if premerge_window is None else int(premerge_window))
    gaps, first_v, max_v, valid, win_idx, n_above = _dynamic_candidates(
        dchi2, threshold, w0, candidate_capacity)
    starts = _dynamic_walk(window_fn, gaps, first_v, max_v, valid, n_above)
    return _dynamic_winners(starts, max_v, valid, win_idx, amps, capacity,
                            l, amps_transform, n_above)


def find_triggers_dynamic_kernel(dchi2: torch.Tensor, amps: torch.Tensor,
                                 threshold: float, window_fn,
                                 capacity: int,
                                 candidate_capacity: int = 4096,
                                 amps_transform=None,
                                 premerge_window: Optional[int] = None
                                 ) -> TriggerSet:
    """One trace: dchi2 [L], amps [M', L] (JAX
    ``find_triggers_dynamic_kernel`` :1043), the E = 1 case of
    :func:`find_triggers_dynamic_batched`."""
    ts = find_triggers_dynamic_batched(
        dchi2[None], amps[None], threshold, window_fn, capacity,
        candidate_capacity, amps_transform, premerge_window)
    return TriggerSet(*(None if f is None else f[0] for f in ts))


def find_triggers_dynamic(dchi2: np.ndarray, amps: np.ndarray,
                          threshold: float, threshold_function,
                          capacity: Optional[int] = None):
    """Host loop of the reference's ``dynamic=True`` mode (JAX
    ``find_triggers_dynamic`` :1290) for any Python callable
    ``threshold_function``: (indices, Δχ² values, amplitudes [M, K])."""
    dchi2 = np.asarray(dchi2)
    amps = np.asarray(amps)
    above = np.where(dchi2 > threshold)[0]
    if len(above) == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0),
                np.zeros((amps.shape[0], 0)))
    starts = [0]
    current = 0
    for i in range(1, len(above)):
        window = threshold_function(
            float(np.max(dchi2[above[current: i + 1]])))
        if above[i] - above[i - 1] > window:
            starts.append(i)
            current = i
    starts.append(len(above))
    idx_out, d_out = [], []
    for a, b in zip(starts[:-1], starts[1:]):
        group = above[a:b]
        best = group[np.argmax(dchi2[group])]
        idx_out.append(best)
        d_out.append(dchi2[best])
        if capacity is not None and len(idx_out) >= capacity:
            break
    idx_out = np.asarray(idx_out, dtype=np.int64)
    return idx_out, np.asarray(d_out), amps[:, idx_out]


def shift_templates_to_match_chi2(fs: float, primary_template,
                                  secondary_templates, noisecsd,
                                  relative_amplitudes=None,
                                  block: int = 16384, device=None,
                                  dtype: Optional[torch.dtype] = None):
    """Roll secondary templates so that the primary template's trigger
    peaks at the same sample on each (JAX
    ``shift_templates_to_match_chi2`` :1331): each template, weighted by
    ``relative_amplitudes``, is embedded in a trace of four template
    lengths and filtered with the primary's trigger kernel on ``device``
    (None: the GPU) in ``dtype`` (default float64 on the CPU, float32 on
    the card); the shift is the difference of the Δχ² argmaxima.
    Returns (shifted templates as numpy arrays, shifts as numpy ints)."""
    device = dev.require_cuda() if device is None else torch.device(device)
    if dtype is None:
        dtype = torch.float64 if device.type == "cpu" else torch.float32
    primary = filterbank._reshape_template_3d(np.asarray(primary_template))
    c, m, n = primary.shape
    if relative_amplitudes is None:
        relative_amplitudes = np.ones(m)
    bank = filterbank.make_ofnxm_bank(primary, np.asarray(noisecsd), fs,
                                      n // 2)
    kernel = make_trigger_kernel(
        bank, block=block,
        real_dtype=np.float64 if dtype == torch.float64 else np.float32)

    def peak_time(template_3d):
        trace = np.einsum("cmn,m->cn", template_3d, relative_amplitudes)
        pad = np.zeros((c, 4 * n))
        pad[:, int(1.5 * n):int(2.5 * n)] = trace
        q = of_fir(torch.as_tensor(pad, dtype=dtype, device=device), kernel)
        d, _ = delta_chi2(q, kernel.iw_matrix)
        return int(torch.argmax(d))

    t_primary = peak_time(primary)
    shifted, shifts = [], np.zeros(len(secondary_templates), dtype=int)
    for i, sec in enumerate(secondary_templates):
        sec3 = filterbank._reshape_template_3d(np.asarray(sec))
        shifts[i] = t_primary - peak_time(sec3)
        shifted.append(np.roll(sec3, shifts[i], axis=-1))
    return shifted, shifts


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


def vetoed_count(triggers: TriggerSet,
                 saturated: torch.Tensor) -> torch.Tensor:
    """The triggers [...] of ``triggers`` that the saturation flags
    ``saturated`` [..., L] keep out of the residual subtraction."""
    idx = triggers.indices
    return ((idx >= 0) & saturated.gather(-1, idx.clamp(min=0))).sum(-1)


def residual_subtract_conv(dchi2: torch.Tensor, triggers: TriggerSet,
                           kernel: TriggerKernel, basis: ResidualBasis,
                           saturated: Optional[torch.Tensor] = None,
                           timer=None) -> torch.Tensor:
    """Subtract each trigger's best-fit Δχ² response from Δχ²
    (oftrigger.py:789-817), skipping saturated triggers.

    Each trigger's response shape d(t) = q_respᵀ W⁻¹ q_resp is aligned on
    its own argmax at the trigger index; per basis pair the trigger puts
    one spike â_j1·â_j2 at its aligned start (``index_add_``), and one
    overlap-save convolution with the basis (:func:`of_fir_blocks`) gives
    the trace to subtract. ``dchi2`` is [..., L] or [..., R, B] with the
    batch dimensions of ``triggers``; the result has its shape. Only the
    slots up to the last valid one of any event are aligned, which needs
    one read of the trigger indices on the host: a span
    ``residual.index_read`` of ``timer`` (a ``StageTimer``), where the
    caller waits for the first pass on the device."""
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
    with span(timer, "residual.index_read"):
        k = int(torch.where(used, torch.arange(1, cap + 1,
                                               device=used.device), 0).max())
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
    truncated ones to the first pass's total; ``n_above`` is the sum of
    the passes' (None when neither has one)."""
    host = {name: [_host(getattr(ts, name)) for ts in (first, second)]
            for name in TriggerSet._fields
            if name not in ("n_above", "n_vetoed")}
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
    above = [ts.n_above for ts in (first, second) if ts.n_above is not None]
    return TriggerSet(indices=indices, dchi2=dchi2, amplitudes=amps,
                      count=np.int64(n1 + n_new), count_total=np.int64(total),
                      n_above=(np.int64(sum(int(a) for a in above))
                               if above else None))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def event_set(ts: TriggerSet, e: int) -> TriggerSet:
    """Event ``e`` of a batched trigger set, as host numpy arrays."""
    return TriggerSet(*(None if field is None else _host(field[e])
                        for field in ts))
