"""A numpy model of ``detprocess_tpu_torch/csrc/fused_nodelay_of.cu``,
``csrc/rfft.cu`` and their FFT core ``csrc/fft_regs.cuh``, step by step.

The CUDA kernels run only on the GPU; this model follows their index maps
and their arithmetic so that the CPU tests can hold them to
``np.fft.rfft``, to the JAX package's of1x1 functions and to the Pallas
kernels they replace. ``dtype=np.complex128`` gives the exact algorithm
(errors at 1e-13); ``np.complex64`` repeats the kernels' float32
roundings, the twiddle products included (not their fused multiply-adds).
"""

import numpy as np

LO_BITS = 6        # untangle twiddle W_N^k = hi[k >> 6] · lo[k & 63]
GROUP = 4          # slots reduced together at most


def pass_schedule(log2m):
    """(radix, log2 Ns) of each pass: radix 16 while 4 bits are left, the
    last 1–3 bits in one smaller pass."""
    full, rem = divmod(log2m, 4)
    return [(16, 4 * p) for p in range(full)] + (
        [(1 << rem, 4 * full)] if rem else [])


def pad(i):
    """Padded shared-memory slot of entry i."""
    return i + (i >> 4)


def out_pos(radix, q):
    """Register slot of output q of the in-place DFT_R."""
    return q if radix <= 4 else (radix // 4) * (q & 3) + (q >> 2)


def slot_groups(nslots):
    """Sizes of the kernel's slot groups, in order."""
    return [GROUP] * (nslots // GROUP) + [g for g in (2, 1) if nslots & g]


def pass_addresses(m, radix, lns, tid, i):
    """Unpadded shared addresses that thread(s) ``tid`` read (pass input
    r, [R, ...]) and write (output q, [R, ...]) for their i-th butterfly
    of a pass."""
    nb, ns = m // radix, 1 << lns
    b = tid + i * (m // 16)
    k = b & (ns - 1)
    reads = np.stack([b + r * nb for r in range(radix)])
    writes = np.stack([(b - k) * radix + k + q * ns for q in range(radix)])
    return reads, writes


def _w16(e, dtype):
    return np.exp(-2j * np.pi * (e % 16) / 16).astype(dtype)


def _dft2(a, b):
    return a + b, a - b


def _dft4(a, b, c, d):
    a0, a1, a2, d3 = a + c, a - c, b + d, b - d
    a3 = -1j * d3
    return a0 + a2, a1 + a3, a0 - a2, a1 - a3


def dft_regs(v, dtype):
    """In-place DFT_R of the register list v (R = len(v)), as dft<R>:
    natural-order output q in slot out_pos(R, q)."""
    radix = len(v)
    v = list(v)
    if radix == 2:
        return list(_dft2(*v))
    if radix == 4:
        return list(_dft4(*v))
    qq = radix // 4
    for b in range(qq):
        v[b::qq] = _dft4(*v[b::qq])
    for b in range(1, qq):
        for c in range(1, 4):
            v[qq * c + b] = v[qq * c + b] * _w16((16 // radix) * b * c, dtype)
    for c in range(4):
        blk = v[qq * c: qq * c + qq]
        v[qq * c: qq * c + qq] = _dft2(*blk) if qq == 2 else _dft4(*blk)
    return v


def stage_twiddles(tw, t, radix):
    """W_{Ns·R}^{r·k}, r < R, from the table reads tw[2t] and (R ≥ 8)
    tw[8t], the rest as the kernel's chained products:
    W^{(a+4c)·k} = (W^{4k})^c · (W^k)^a."""
    one = np.ones_like(tw[2 * t])
    w1 = tw[2 * t]
    w4 = tw[8 * t] if radix >= 8 else one
    ws = [None] * radix
    wc = one
    for c in range(max(radix // 4, 1)):
        if c == 1:
            wc = w4
        if c >= 2:
            wc = wc * w4
        ws[4 * c] = wc
        w = wc
        for a in range(1, min(radix, 4)):
            w = w1 if c == 0 and a == 1 else w * w1
            ws[a + 4 * c] = w
    ws[0] = one
    return ws


def fft_regs(z, tw, dtype=np.complex128):
    """The passes of fft_regs.cuh on packed traces z [..., M] with the
    table tw = W_{2M}^i (i < M); returns the padded shared buffer
    [..., M + M/16] that holds Z_k at pad(k)."""
    m = z.shape[-1]
    log2m = m.bit_length() - 1
    z = z.astype(dtype)
    tw = tw.astype(dtype)
    s = np.zeros(z.shape[:-1] + (m + m // 16,), dtype)
    for p, (radix, lns) in enumerate(pass_schedule(log2m)):
        nb, ns = m // radix, 1 << lns
        lr = radix.bit_length() - 1
        b = np.arange(nb)
        k = b & (ns - 1)
        src = [z[..., b + r * nb] if p == 0 else s[..., pad(b + r * nb)]
               for r in range(radix)]
        if lns:
            ws = stage_twiddles(tw, k << (log2m - lns - lr), radix)
            src = [v * w for v, w in zip(src, ws)]
        v = dft_regs(src, dtype)
        base = (b - k) * radix + k
        for q in range(radix):
            s[..., pad(base + q * ns)] = v[out_pos(radix, q)]
    return s


def untangle_tables(tw):
    """The kernel's shared factor tables: lo = W_N^l (l < 64) and
    hi = W_N^{64·h} (h < M/64), both read from tw."""
    m = tw.shape[-1]
    return tw[: 1 << LO_BITS], tw[0:m:1 << LO_BITS]


def half_spectrum(x, tw, dtype=np.complex128):
    """Natural half spectrum X [..., M + 1] of real traces x [..., N] as
    the kernel forms it: passes, then the untangle with the factor
    tables and the Nyquist bin."""
    tw = tw.astype(dtype)
    m = x.shape[-1] // 2
    s = fft_regs(x[..., 0::2] + 1j * x[..., 1::2], tw, dtype)
    lo, hi = untangle_tables(tw)
    k = np.arange(m)
    zk = s[..., pad(k)]
    zr = np.conj(s[..., pad((m - k) & (m - 1))])
    w = hi[k >> LO_BITS] * lo[k & ((1 << LO_BITS) - 1)]
    e = 0.5 * (zk + zr)
    o = 0.5 * (zk - zr)
    out = np.empty(x.shape[:-1] + (m + 1,), dtype)
    out[..., :m] = e - 1j * (w * o)
    out[..., m] = s[..., 0].real - s[..., 0].imag
    return out


def rfft_store_map(m):
    """The bins that rfft.cu's threads write: [M/16, M/32, 2], thread t's
    i-th pair (k, M − k) with k = t + i·M/16 < M/2; thread 0 also writes
    the middle bin M/2, returned second."""
    threads = m // 16
    k = np.arange(threads)[:, None] + threads * np.arange(m // 2 // threads)
    return np.stack([k, m - k], axis=-1), m // 2


def rfft_spectrum(x, tw, dtype=np.complex128):
    """Natural half spectrum X [..., M + 1] of real traces x [..., N] as
    rfft.cu forms and stores it: the passes, then for each pair of the
    store map X_k = e − i·W·o and X_{M−k} = conj(e + i·W·o) from one
    twiddle W = W_N^k of the factor tables, and X_{M/2} = conj Z_{M/2}.
    Bins no thread writes stay NaN."""
    tw = tw.astype(dtype)
    m = x.shape[-1] // 2
    s = fft_regs(x[..., 0::2] + 1j * x[..., 1::2], tw, dtype)
    lo, hi = untangle_tables(tw)
    pairs, mid = rfft_store_map(m)
    k = pairs[..., 0].ravel()
    zk = s[..., pad(k)]
    zr = np.conj(s[..., pad((m - k) & (m - 1))])
    w = hi[k >> LO_BITS] * lo[k & ((1 << LO_BITS) - 1)]
    e = 0.5 * (zk + zr)
    wo = w * (0.5 * (zk - zr))
    out = np.full(x.shape[:-1] + (m + 1,), np.nan, dtype)
    out[..., k] = e - 1j * wo
    out[..., pairs[..., 1].ravel()] = np.conj(e + 1j * wo)
    out[..., mid] = np.conj(s[..., pad(mid)])
    return out


def fused_sums(x, tw, phi_w, dinv_w, dtype=np.complex128):
    """q, χ²₀ [B, S] float64 of traces x [B, N] against the folded rows
    phi_w [S, N/2+1] (w·φ) and dinv_w (w·d): per-thread float64
    partials over the thread's 16 bins (Nyquist on thread 0), summed over
    the block, one slot group at a time."""
    rdt = np.float32 if dtype == np.complex64 else np.float64
    xs = half_spectrum(x, tw, dtype)
    m = x.shape[-1] // 2
    threads = m // 16
    nslots = phi_w.shape[0]
    bins = np.arange(m + 1)
    thread_of = np.where(bins < m, bins % threads, 0)
    p2 = (xs.real * xs.real + xs.imag * xs.imag).astype(rdt)
    q = np.full((x.shape[0], nslots), np.nan)
    c0 = np.full_like(q, np.nan)
    s0 = 0
    for g in slot_groups(nslots):
        for sl in range(s0, s0 + g):
            ph = phi_w[sl].astype(dtype)
            d = dinv_w[sl].astype(rdt)
            qk = (ph.real * xs.real - ph.imag * xs.imag).astype(rdt)
            ck = (d * p2).astype(rdt)
            qt = np.zeros((x.shape[0], threads))
            ct = np.zeros_like(qt)
            np.add.at(qt.T, thread_of, qk.astype(np.float64).T)
            np.add.at(ct.T, thread_of, ck.astype(np.float64).T)
            q[:, sl] = qt.sum(axis=1)
            c0[:, sl] = ct.sum(axis=1)
        s0 += g
    return q, c0
