"""The port's of1x1 half-spectrum fits and the fused no-delay module equal
the JAX package's.

Float64 on both sides for the half-spectrum functions (1e-9). The fused
no-delay module's plain twin is also held to the TPU kernel it replaces,
``detprocess_tpu.ops.pallas_of.FusedNodelayOF`` in interpret mode, at the
float32 tolerances of tests/test_pallas_kernels.py (amp rtol 1e-5, χ²
rtol 5e-3: χ² sits at the float32 cancellation floor of χ²₀ − q²/norm).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops.pallas_of import FusedNodelayOF as PallasFused
from detprocess_tpu_torch.ops import _kernels
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.ops import of1x1 as tof
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF

torch.set_num_threads(1)

FS = 1.25e6
N = 2048
PRETRIG = 512
NB = 8
RTOL = 1e-9


def _psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


@pytest.fixture(scope="module")
def setup():
    """Two-slot bank, traces with shifted pulses, both sides' spectra."""
    rng = np.random.default_rng(11)
    t1 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    t2 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=12e-6,
                              tau_f1=90e-6)
    bank = jfb.make_of1x1_bank(np.stack([t1, t2]),
                               np.stack([_psd(N), _psd(N, 3e-20, 20.0)]),
                               FS, PRETRIG)
    traces = rng.standard_normal((NB, N)) * 1e-8
    traces += rng.uniform(1e-6, 3e-6, NB)[:, None] * np.stack(
        [np.roll(t1, s) for s in rng.integers(-150, 150, NB)])
    bh = jfb.device_bank_1x1_half(
        {k: jnp.asarray(v) for k, v in bank.to_device(np.float64).items()})
    tb = tfb.bank_from_jax(bank.to_device(np.float64), "cpu", torch.float64)
    vr_j = jof.signal_rfft(jnp.asarray(traces)[:, None, :])
    vr_t = tfft.rfft(torch.as_tensor(traces))[:, None, :]
    return bank, traces, bh, tb, vr_j, vr_t


def _cmp(res_t, res_j, t0_exact=True):
    for field in ("amp", "chi2", "lowchi2", "chi2_nopulse"):
        np.testing.assert_allclose(getattr(res_t, field).numpy(),
                                   np.asarray(getattr(res_j, field)),
                                   rtol=RTOL, err_msg=field)
    if t0_exact:
        np.testing.assert_array_equal(res_t.t0.numpy(), np.asarray(res_j.t0))
    else:
        np.testing.assert_allclose(res_t.t0.numpy(), np.asarray(res_j.t0),
                                   rtol=1e-8, atol=1e-15)


def test_result_fields_match_jax():
    assert tof.OF1x1Result._fields == jof.OF1x1Result._fields
    assert tof.DelayPick._fields == jof.DelayPick._fields


@pytest.mark.parametrize("fcut", [None, 10000.0, FS])
def test_lowfreq_mask_and_chi2_base(setup, fcut):
    bank, traces, bh, tb, vr_j, vr_t = setup
    if fcut is not None:
        np.testing.assert_array_equal(tof.lowfreq_mask_half(N, FS, fcut),
                                      jof.lowfreq_mask_half(N, FS, fcut))
    np.testing.assert_allclose(
        tof.chi2_base_half(vr_t, tb["denom_inv_h"], tb["bin_w"]).numpy(),
        np.asarray(jof.chi2_base_half(vr_j, bh.denom_inv, bh.bin_w)),
        rtol=RTOL)


@pytest.mark.parametrize("shift", [0.0, -37.0, 12.25])
def test_residual_chi2_half_matches_jax(setup, shift):
    bank, traces, bh, tb, vr_j, vr_t = setup
    mask = jof.lowfreq_mask_half(N, FS, 20000.0)
    amp = np.full((NB, 2), 2e-6)
    sh = np.full((NB, 2), shift)
    got = tof._residual_chi2_half(vr_t, torch.as_tensor(amp),
                                  torch.as_tensor(sh), tb["s_fft_h"],
                                  tb["denom_inv_h"], tb["bin_w"], mask, N)
    ref = jof._residual_chi2_half(vr_j, jnp.asarray(amp), jnp.asarray(sh),
                                  bh.s_fft, bh.denom_inv, bh.bin_w,
                                  jnp.asarray(mask), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("fcut", [None, 10000.0])
def test_nodelay_half_matches_jax(setup, fcut):
    bank, traces, bh, tb, vr_j, vr_t = setup
    mask = None if fcut is None else jof.lowfreq_mask_half(N, FS, fcut)
    res_j = jof.of1x1_nodelay_half(
        vr_j, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w,
        None if mask is None else jnp.asarray(mask), n=N)
    res_t = tof.of1x1_nodelay_half(
        vr_t, tb["phi_h"], tb["norm"], tb["denom_inv_h"], tb["s_fft_h"],
        tb["bin_w"], None if mask is None else torch.as_tensor(mask), n=N)
    assert res_t.amp.shape == (NB, 2)
    _cmp(res_t, res_j)


@pytest.mark.parametrize("window", ["free", "masked", "outside"])
@pytest.mark.parametrize("interp", [False, True])
@pytest.mark.parametrize("fcut", [None, 10000.0])
def test_withdelay_half_matches_jax(setup, window, interp, fcut):
    bank, traces, bh, tb, vr_j, vr_t = setup
    wmask = None
    if window != "free":
        wmask = np.zeros(N, bool)
        wmask[PRETRIG - 60:PRETRIG + 90] = True
        if window == "outside":
            wmask = ~wmask
    lmask = None if fcut is None else jof.lowfreq_mask_half(N, FS, fcut)
    res_j = jof.of1x1_withdelay_half(
        vr_j, bh.phi, bh.norm, bh.denom_inv, bh.s_fft, bh.bin_w, PRETRIG,
        FS, window_mask=None if wmask is None else jnp.asarray(wmask),
        low_mask_h=None if lmask is None else jnp.asarray(lmask),
        interpolate_t0=interp, n=N)
    res_t = tof.of1x1_withdelay_half(
        vr_t, tb["phi_h"], tb["norm"], tb["denom_inv_h"], tb["s_fft_h"],
        tb["bin_w"], PRETRIG, FS, window_mask=wmask,
        low_mask_h=None if lmask is None else torch.as_tensor(lmask),
        interpolate_t0=interp, n=N)
    _cmp(res_t, res_j, t0_exact=not interp)


@pytest.mark.parametrize("interp", [False, True])
def test_pick_delay_and_refits_match_jax(interp):
    rng = np.random.default_rng(5)
    n, pretrig = 256, 64
    dchi2 = rng.standard_normal((4, 3, n)) ** 2
    dchi2[0, 0, 0] = 50.0          # winner at the wrap-around edge
    dchi2[1, 1, n - 1] = 50.0
    dchi2[2, 2, 100:103] = 7.0     # flat apex: zero curvature
    wmask = np.ones(n, bool)
    wmask[200:] = False
    for mask in (None, wmask):
        pj = jof.pick_delay(jnp.asarray(dchi2), n, pretrig, delay_order=False,
                            window_mask=mask, interpolate_t0=interp)
        pt = tof.pick_delay(torch.as_tensor(dchi2), n, pretrig,
                            window_mask=mask, interpolate_t0=interp)
        for field in ("idx", "im1", "ip1", "delta", "shift"):
            np.testing.assert_allclose(getattr(pt, field).numpy(),
                                       np.asarray(getattr(pj, field)),
                                       rtol=1e-12, atol=0, err_msg=field)
        assert (pt.gain is None) == (pj.gain is None)
        if interp:
            np.testing.assert_allclose(pt.gain.numpy(), np.asarray(pj.gain),
                                       rtol=1e-12)
        q = rng.standard_normal((4, 3, n))
        norm = np.array([2.0, 3.0, 5.0])
        np.testing.assert_allclose(
            tof.interp_amp(torch.as_tensor(q), torch.as_tensor(norm),
                           pt).numpy(),
            np.asarray(jof.interp_amp(jnp.asarray(q), jnp.asarray(norm), pj)),
            rtol=1e-12)


def test_fused_nodelay_plain_matches_jax_f64(setup):
    """S = 2 slots at once, float64: the plain twin equals
    of1x1_nodelay_half."""
    bank, traces, bh, tb, vr_j, vr_t = setup
    fused = FusedNodelayOF.from_bank(tb)
    _kernels.reset_launch_counts()
    amp, chi2 = fused(torch.as_tensor(traces))
    assert _kernels.launch_counts()["fused_nodelay_of"] == 0
    ref = jof.of1x1_nodelay_half(vr_j, bh.phi, bh.norm, bh.denom_inv,
                                 bh.s_fft, bh.bin_w, n=N)
    assert amp.shape == chi2.shape == (NB, 2)
    np.testing.assert_allclose(amp.numpy(), np.asarray(ref.amp), rtol=RTOL)
    np.testing.assert_allclose(chi2.numpy(), np.asarray(ref.chi2), rtol=RTOL)


@pytest.mark.parametrize("n,pretrig", [(2048, 512), (1024, 256)])
def test_fused_nodelay_plain_matches_pallas_interpret(n, pretrig):
    """The cases of tests/test_pallas_kernels.py (the TPU kernel in
    interpret mode) through the port's plain twin."""
    rng = np.random.default_rng(1)
    tmpl = jpulse.make_template(FS, n, pretrig, A=1.0, tau_r=20e-6,
                                tau_f1=200e-6)
    bank = jfb.make_of1x1_bank(tmpl, _psd(n), FS, pretrig)
    amps = rng.uniform(1e-6, 3e-6, 16)
    traces = (rng.standard_normal((16, n)) * 1e-8
              + amps[:, None] * tmpl[None, :])
    pallas = PallasFused(bank, slot=0, n1=32, n2=n // 32, tile=8,
                         interpret=True)
    amp_p, chi2_p = pallas(jnp.asarray(traces, jnp.float32))
    fused = FusedNodelayOF.from_bank(
        tfb.bank_to_torch(bank, "cpu", torch.float64))
    amp, chi2 = fused(torch.as_tensor(traces.astype(np.float32),
                                      dtype=torch.float64))
    np.testing.assert_allclose(amp[:, 0].numpy(), np.asarray(amp_p),
                               rtol=1e-5)
    np.testing.assert_allclose(chi2[:, 0].numpy(), np.asarray(chi2_p),
                               rtol=5e-3)


def test_fused_nodelay_from_bank_slots(setup):
    bank, traces, bh, tb, vr_j, vr_t = setup
    one = FusedNodelayOF.from_bank(tb, slots=[1])
    both = FusedNodelayOF.from_bank(tb)
    assert one.nslots == 1 and both.nslots == 2
    x = torch.as_tensor(traces)
    np.testing.assert_allclose(one(x)[0][:, 0].numpy(),
                               both(x)[0][:, 1].numpy(), rtol=1e-14)
    assert set(dict(one.named_buffers())) == {"phi_h", "denom_inv_h",
                                              "bin_w", "norm"}


def test_fused_nodelay_validates_bank_and_input(setup):
    bank, traces, bh, tb, vr_j, vr_t = setup
    with pytest.raises(ValueError, match=r"\[S, N/2\+1\]"):
        FusedNodelayOF(tb["phi_h"][0], tb["denom_inv_h"][0], tb["bin_w"],
                       tb["norm"])
    with pytest.raises(ValueError, match="bin_w"):
        FusedNodelayOF(tb["phi_h"], tb["denom_inv_h"], tb["bin_w"][:-1],
                       tb["norm"])
    fused = FusedNodelayOF.from_bank(tb)
    # the CUDA path refuses CPU tensors; it never runs the plain twin
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.kernel(torch.zeros(2, N, dtype=torch.float32))
    with pytest.raises(TypeError, match="float32"):
        fused.kernel(torch.zeros(2, N, dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        fused(torch.zeros(2, N, device="meta"))
