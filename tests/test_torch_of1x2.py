"""The port's joint two-template OF fit equals the JAX package's.

``detprocess_tpu_torch.ops.of1x1.of1x2_half`` against
``detprocess_tpu.ops.of1x1.of1x2_half`` on the same float64 half spectra
(noise plus a scintillation pulse and an evaporation pulse 20–300 samples
later, made with numpy from a seed) at 1e-9: the full circular scan and
bounded Δ windows of odd and even length, scanned in one chunk and in
chunks of one to three shifts (the port's chunking must not change the
winner), and Δ windows that are not a run of consecutive shifts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import of1x1 as tof

torch.set_num_threads(1)

FS = 1.25e6
N = 2048
PRETRIG = 512
NB = 5
RTOL = 1e-9


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    scint = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6,
                                 tau_f1=60e-6)
    evap = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=30e-6,
                                tau_f1=400e-6)
    f = np.abs(np.fft.fftfreq(N, 1 / FS))
    f[0] = f[1]
    psd = 1e-20 * (1.0 + 100.0 / f)
    bank = jfb.make_of1x1_bank(np.stack([scint, evap]), psd, FS, PRETRIG)
    x = rng.standard_normal((NB, N)) * 3e-8
    shifts = rng.integers(-40, 40, NB)
    delays = rng.integers(20, 300, NB)
    for e in range(NB):
        x[e] += rng.uniform(1e-6, 3e-6) * np.roll(scint, shifts[e])
        x[e] += rng.uniform(0.5e-6, 2e-6) * np.roll(evap, shifts[e]
                                                     + delays[e])
    bh = jfb.device_bank_1x1_half(
        {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()})
    tb = tfb.bank_from_jax(bank.to_device(np.float64), "cpu", torch.float64)
    vr_j = jof.signal_rfft(jnp.asarray(x)[:, None, :])
    vr_t = tfft.rfft(torch.as_tensor(x))[:, None, :]
    return bh, tb, vr_j, vr_t, shifts, delays


def _run(setup, window, scan_bytes=tof.OF1X2_SCAN_BYTES):
    bh, tb, vr_j, vr_t, _, _ = setup
    rj = jof.of1x2_half(vr_j, bh.phi[:1], bh.norm[:1], bh.phi[1:],
                        bh.norm[1:], bh.s_fft[1:], bh.denom_inv[:1],
                        bh.bin_w, PRETRIG, FS, N, delta_window=window)
    rt = tof.of1x2_half(vr_t, tb["phi_h"][:1], tb["norm"][:1],
                        tb["phi_h"][1:], tb["norm"][1:], tb["s_fft_h"][1:],
                        tb["denom_inv_h"][:1], tb["bin_w"], PRETRIG, FS, N,
                        delta_window=window, scan_bytes=scan_bytes)
    return rt, rj


def _compare(rt, rj):
    assert tof.OF1x2Result._fields == jof.OF1x2Result._fields
    for field in ("t0_1", "t0_2", "time_diff"):
        np.testing.assert_array_equal(getattr(rt, field).numpy(),
                                      np.asarray(getattr(rj, field)),
                                      err_msg=field)
    for field in ("amp1", "amp2", "chi2"):
        np.testing.assert_allclose(getattr(rt, field).numpy(),
                                   np.asarray(getattr(rj, field)),
                                   rtol=RTOL, err_msg=field)


WINDOWS = {
    "full": None,
    "even": np.arange(0, 400),
    "odd": np.arange(-5, 396),
    "negative": np.arange(-300, -10),
    "sparse": np.concatenate([np.arange(0, 150, 3), np.arange(150, 320)]),
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_of1x2_half_matches_jax(setup, name):
    rt, rj = _run(setup, WINDOWS[name])
    _compare(rt, rj)
    if name in ("full", "even", "odd"):
        # the injected delays are inside these windows
        np.testing.assert_allclose(rt.time_diff.numpy()[:, 0] * FS,
                                   setup[5], atol=2)


@pytest.mark.parametrize("name,k", [("full", 1), ("odd", 2), ("even", 3),
                                    ("sparse", 7)])
def test_of1x2_chunking_keeps_the_winner(setup, name, k):
    # scan_bytes for k shifts of the [B, 1, K, N] float64 temporary
    rt, rj = _run(setup, WINDOWS[name], scan_bytes=k * NB * N * 8)
    _compare(rt, rj)


def test_of1x2_overlap_is_the_bank_constant(setup):
    bh, tb, *_ = setup
    c = tof.of1x2_overlap(tb["phi_h"][:1], tb["norm"][:1], tb["s_fft_h"][1:],
                          tb["norm"][1:], N)
    want = (np.fft.irfft(np.asarray(bh.phi[:1] * bh.s_fft[1:]), N) * N
            / np.sqrt(np.asarray(bh.norm[0] * bh.norm[1])))
    np.testing.assert_allclose(c.numpy(), want, rtol=1e-12, atol=1e-15)
    assert float(c.abs().max()) <= 1.0 + 1e-12
