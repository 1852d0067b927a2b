"""The fused no-delay kernel's arithmetic, on the CPU.

``csrc/fused_nodelay_of.cu`` and its FFT core ``csrc/fft_regs.cuh`` run
only on the GPU, where ``python3 chip_smoke.py`` holds them to their plain
twin. Here the numpy model of tests/fused_model.py, which follows the
kernel step by step (pass schedule, padded index map, twiddle products,
factor-table untangle, folded epilogue, slot groups), is held to
``np.fft.rfft`` (1e-12), to ``detprocess_tpu.ops.of1x1.of1x1_nodelay_half``
in float64 at S = 1, 9, 11 and 17 (1e-9), and, in float32, to the Pallas
kernel it replaces in interpret mode (amp rtol 1e-5, χ² rtol 5e-3, the
tolerances of tests/test_pallas_kernels.py).
"""

import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fused_model as fm
from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops.pallas_of import FusedNodelayOF as PallasFused
from detprocess_tpu_torch.ops import _kernels, cuda_fft
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF

torch.set_num_threads(1)

FS = 1.25e6
LOG2M = range(7, 15)                       # N = 256 … 32768


def _psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


def _table(n, dtype=np.complex128):
    return np.exp(-2j * np.pi * np.arange(n // 2) / n).astype(dtype)


def _bank(n, pretrig, nslots):
    """A bank of ``nslots`` distinct templates and PSDs."""
    tmpl = np.stack([jpulse.make_template(FS, n, pretrig, A=1.0,
                                          tau_r=(8 + 2 * i) * 1e-6,
                                          tau_f1=(60 + 15 * i) * 1e-6)
                     for i in range(nslots)])
    psd = np.stack([_psd(n, 1e-20 * (1 + 0.1 * i), 20.0 + 10 * i)
                    for i in range(nslots)])
    return jfb.make_of1x1_bank(tmpl, psd, FS, pretrig), tmpl


def test_supported_lengths_are_the_model_lengths():
    assert cuda_fft.SUPPORTED_N == tuple(2 ** (p + 1) for p in LOG2M)


@pytest.mark.parametrize("log2m", LOG2M)
def test_pass_schedule(log2m):
    sched = fm.pass_schedule(log2m)
    assert sum(r.bit_length() - 1 for r, _ in sched) == log2m
    assert [lns for _, lns in sched] == [4 * p for p in range(len(sched))]
    assert sched[0] == (16, 0) and all(r in (2, 4, 8, 16) for r, _ in sched)
    assert len(sched) == -(-log2m // 4)
    if log2m == 14:                          # N = 32768: 4 passes, not 7
        assert [r for r, _ in sched] == [16, 16, 16, 4]


@pytest.mark.parametrize("log2m", LOG2M)
def test_padded_map_is_a_conflict_free_permutation(log2m):
    """Every pass writes each padded slot of the M entries once, and a
    half-warp's 16 float2 accesses fall on 16 distinct bank pairs (pad
    mod 16) in every pass and in the untangle's reads of Z_k; the mirrored
    reads Z_{M−k} are conflict-free but in the half-warp that holds k = 0
    (2-way)."""
    m = 1 << log2m
    threads = m // 16
    half = min(16, threads)
    slots = fm.pad(np.arange(m))
    assert len(set(slots)) == m and slots.max() < m + m // 16

    def ways(addr):
        """Largest number of accesses of one half-warp on one bank pair;
        addr [threads]."""
        worst = 1
        for h in range(0, threads, half):
            _, counts = np.unique(fm.pad(addr[h:h + half]) % 16,
                                  return_counts=True)
            worst = max(worst, counts.max())
        return worst

    tid = np.arange(threads)
    for radix, lns in fm.pass_schedule(log2m):
        written = []
        for i in range(16 // radix):
            reads, writes = fm.pass_addresses(m, radix, lns, tid, i)
            written.append(writes.ravel())
            for addr in (*reads, *writes):
                assert ways(addr) == 1, (radix, lns, i)
        assert sorted(np.concatenate(written)) == list(range(m))
    for i in range(16):
        k = tid + i * threads
        assert ways(k) == 1
        assert ways((m - k) & (m - 1)) <= 2


@pytest.mark.parametrize("radix", [2, 4, 8, 16])
def test_register_dft_matches_numpy(radix):
    v = np.random.default_rng(radix).standard_normal((radix, 3, 2)) @ [1, 1j]
    got = fm.dft_regs(list(v), np.complex128)
    ref = np.fft.fft(v, axis=0)
    for q in range(radix):
        np.testing.assert_allclose(got[fm.out_pos(radix, q)], ref[q],
                                   rtol=0, atol=1e-13)


@pytest.mark.parametrize("radix", [2, 4, 8, 16])
def test_twiddle_products_error(radix):
    """W^{r·k} from at most two float32 table reads and chained products
    stays within 2.7e-7 of the exact value (2.6e-7 measured at radix 16)."""
    m = 1 << 14
    tw32 = _table(2 * m, np.complex64)
    t = np.arange(m // radix)
    ws = fm.stage_twiddles(tw32, t, radix)
    for r, w in enumerate(ws):
        exact = np.exp(-2j * np.pi * r * 2 * t / (2 * m))
        assert np.max(np.abs(w - exact)) <= 2.7e-7, r


@pytest.mark.parametrize("n", cuda_fft.SUPPORTED_N)
def test_model_half_spectrum_matches_numpy_rfft(n):
    x = np.random.default_rng(n).standard_normal((3, n))
    ref = np.fft.rfft(x)
    got = fm.half_spectrum(x, _table(n))
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


@pytest.mark.parametrize("n", [256, 4096, 32768])
def test_model_half_spectrum_float32(n):
    """The float32 model (the kernel's roundings, the table's and the
    twiddle products' included) against np.fft.rfft: within 1e-6 of
    max|X|, an order of magnitude inside the card's rFFT tolerance."""
    x = np.random.default_rng(n + 1).standard_normal((2, n)).astype(
        np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    got = fm.half_spectrum(x, _table(n, np.complex64), np.complex64)
    assert got.dtype == np.complex64
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))


@pytest.mark.parametrize("nslots", range(1, 21))
def test_slot_groups_cover_every_slot_once(nslots):
    groups = fm.slot_groups(nslots)
    assert sum(groups) == nslots
    assert all(g in (1, 2, fm.GROUP) for g in groups)
    assert groups == sorted(groups, reverse=True)


@pytest.mark.parametrize("nslots", [1, 9, 11, 17])
def test_model_matches_jax_nodelay_f64(nslots):
    n, pretrig, nb = 2048, 512, 6
    bank, tmpl = _bank(n, pretrig, nslots)
    rng = np.random.default_rng(nslots)
    x = rng.standard_normal((nb, n)) * 1e-8 + rng.uniform(
        1e-6, 3e-6, (nb, 1)) * tmpl[rng.integers(0, nslots, nb)]
    fused = FusedNodelayOF.from_bank(tfb.bank_to_torch(bank, "cpu",
                                                       torch.float64))
    q, c0 = fm.fused_sums(x, _table(n), fused.phi_w.numpy(),
                          fused.dinv_w.numpy())
    norm = fused.norm.numpy()
    bh = jfb.device_bank_1x1_half(
        {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()})
    ref = jof.of1x1_nodelay_half(jof.signal_rfft(jnp.asarray(x)[:, None]),
                                 bh.phi, bh.norm, bh.denom_inv, bh.s_fft,
                                 bh.bin_w, n=n)
    assert q.shape == (nb, nslots)
    np.testing.assert_allclose(q / norm, np.asarray(ref.amp), rtol=1e-9)
    np.testing.assert_allclose(c0 - q * q / norm, np.asarray(ref.chi2),
                               rtol=1e-9)


@pytest.mark.parametrize("n,pretrig", [(2048, 512), (1024, 256)])
def test_model_f32_matches_pallas_interpret(n, pretrig):
    """The cases of test_fused_nodelay_plain_matches_pallas_interpret,
    through the float32 model of the kernel."""
    rng = np.random.default_rng(1)
    tmpl = jpulse.make_template(FS, n, pretrig, A=1.0, tau_r=20e-6,
                                tau_f1=200e-6)
    bank = jfb.make_of1x1_bank(tmpl, _psd(n), FS, pretrig)
    amps = rng.uniform(1e-6, 3e-6, 16)
    traces = (rng.standard_normal((16, n)) * 1e-8
              + amps[:, None] * tmpl[None, :]).astype(np.float32)
    pallas = PallasFused(bank, slot=0, n1=32, n2=n // 32, tile=8,
                         interpret=True)
    amp_p, chi2_p = pallas(jnp.asarray(traces))
    fused = FusedNodelayOF.from_bank(tfb.bank_to_torch(bank, "cpu",
                                                       torch.float32))
    q, c0 = fm.fused_sums(traces, _table(n, np.complex64),
                          fused.phi_w.numpy(), fused.dinv_w.numpy(),
                          np.complex64)
    norm = fused.norm.numpy().astype(np.float64)
    np.testing.assert_allclose(q[:, 0] / norm, np.asarray(amp_p), rtol=1e-5)
    np.testing.assert_allclose(c0[:, 0] - q[:, 0] ** 2 / norm,
                               np.asarray(chi2_p), rtol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_folded_rows_give_the_plain_sums(dtype):
    """phi_w = w·φ and dinv_w = w·d, folded when the module is built, give
    the plain twin's sums (1e-12; exact products, since w is 1 or 2)."""
    n, pretrig = 1024, 256
    bank, tmpl = _bank(n, pretrig, 3)
    fused = FusedNodelayOF.from_bank(tfb.bank_to_torch(bank, "cpu", dtype))
    assert fused.phi_w.dtype == fused.phi_h.dtype
    assert fused.dinv_w.dtype == fused.denom_inv_h.dtype
    w = fused.bin_w
    assert torch.equal(fused.phi_w, fused.phi_h * w)
    assert torch.equal(fused.dinv_w, fused.denom_inv_h * w)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((4, n))
                        * 1e-7, dtype=torch.float64)
    vr = torch.fft.rfft(x)[:, None, :]
    q = (fused.phi_w.to(torch.complex128) * vr).real.sum(-1)
    c0 = ((vr.real ** 2 + vr.imag ** 2) * fused.dinv_w.double()).sum(-1)
    norm = fused.norm.double()
    plain = FusedNodelayOF(fused.phi_h.to(torch.complex128),
                           fused.denom_inv_h.double(), w.double(), norm)
    amp_p, chi2_p = plain.plain(x)
    np.testing.assert_allclose((q / norm).numpy(), amp_p.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose((c0 - q * q / norm).numpy(), chi2_p.numpy(),
                               rtol=1e-12)


def test_kernel_source_follows_the_model():
    """The constants the model assumes are the kernel's, and the kernel
    has one form, on fft_regs.cuh, reading no bin weights."""
    src = (_kernels.CSRC_DIR / "fused_nodelay_of.cu").read_text()
    regs = (_kernels.CSRC_DIR / "fft_regs.cuh").read_text()
    assert '#include "fft_regs.cuh"' in src
    assert re.findall(r'#include "(.*)"', src) == ["fft_regs.cuh"]
    assert re.search(rf"constexpr int kGroup = {fm.GROUP};", src)
    assert re.search(rf"constexpr int kLoBits = {fm.LO_BITS};", src)
    assert "i + (i >> 4)" in regs
    assert "binw" not in src
