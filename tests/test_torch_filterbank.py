"""The port's host-side bank and template builders equal the JAX package's.

detprocess_tpu_torch keeps numpy copies of ``models/pulse.make_template``
and the ``ops/filterbank`` bank builders (it cannot import the JAX
package); these tests hold the copies to the originals at 1e-12 and check
that both routes onto a torch device (``bank_to_torch`` from the bank,
``bank_from_jax`` from the JAX package's ``to_device`` dict) give the same
tensors.
"""

import numpy as np
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu_torch.models import pulse as tpulse
from detprocess_tpu_torch.ops import filterbank as tfb

torch.set_num_threads(1)

FS = 1.25e6
TOL = 1e-12

POLES = {
    "twopole": dict(A=1.0, tau_r=20e-6, tau_f1=200e-6),
    "threepole": dict(A=1.0, B=0.4, tau_r=15e-6, tau_f1=120e-6,
                      tau_f2=600e-6),
    "fourpole": dict(A=1.0, B=0.4, C=0.1, tau_r=10e-6, tau_f1=90e-6,
                     tau_f2=400e-6, tau_f3=2e-3),
}


def _psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


@pytest.mark.parametrize("kind", sorted(POLES))
@pytest.mark.parametrize("n,pretrig", [(1024, 256), (2047, 1000)])
def test_make_template_matches_jax(kind, n, pretrig):
    got = tpulse.make_template(FS, n, pretrig, **POLES[kind])
    ref = jpulse.make_template(FS, n, pretrig, **POLES[kind])
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert got.dtype == np.float64 and got.shape == (n,)


def test_make_template_requires_tau_r():
    with pytest.raises(ValueError, match="tau_r"):
        tpulse.make_template(FS, 256, 64, A=1.0, tau_f1=1e-4)


@pytest.mark.parametrize("n", [8, 9, 2048])
def test_half_bin_weights_matches_jax(n):
    np.testing.assert_array_equal(tfb.half_bin_weights(n),
                                  jfb.half_bin_weights(n))


@pytest.mark.parametrize("peaks,harmonics,coupling", [
    (None, False, "AC"),
    (None, False, "DC"),
    ([60.0, 1000.0], False, "AC"),
    ([6103.515625], True, "AC"),
    ([-2500.0, 0.0], True, "dc"),
])
def test_notch_bin_mask_matches_jax(peaks, harmonics, coupling):
    n = 2048
    got = tfb.notch_bin_mask(n, FS, peaks, harmonics, coupling)
    ref = jfb.notch_bin_mask(n, FS, peaks, harmonics, coupling)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["one_slot", "two_slots", "notched",
                                  "integralnorm", "broadcast_template"])
def test_make_of1x1_bank_matches_jax(case):
    n, pretrig = 1024, 256
    t1 = tpulse.make_template(FS, n, pretrig, **POLES["twopole"])
    t2 = tpulse.make_template(FS, n, pretrig, **POLES["threepole"])
    kwargs = {}
    templates, psds = t1, _psd(n)
    if case == "two_slots":
        templates = np.stack([t1, t2])
        psds = np.stack([_psd(n), _psd(n, 3e-20, 20.0)])
    elif case == "notched":
        psds = _psd(n)
        psds[17] = np.inf
        kwargs = dict(ignored_frequency_peaks=[60e3], ignore_harmonics=True)
    elif case == "integralnorm":
        kwargs = dict(integralnorm=True, coupling="DC")
    elif case == "broadcast_template":
        psds = np.stack([_psd(n), _psd(n, 2e-20, 50.0), _psd(n, 5e-21)])
    got = tfb.make_of1x1_bank(templates, psds, FS, pretrig, **kwargs)
    ref = jfb.make_of1x1_bank(templates, psds, FS, pretrig, **kwargs)
    for field in ("s_fft", "denom_inv", "phi", "norm", "templates", "psd"):
        g, r = getattr(got, field), getattr(ref, field)
        assert g.shape == r.shape, field
        scale = np.max(np.abs(r))
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL * scale,
                                   err_msg=field)
    assert (got.fs, got.pretrigger) == (ref.fs, ref.pretrigger)
    np.testing.assert_allclose(got.resolution, ref.resolution, rtol=TOL)
    assert got.nbins == ref.nbins


def test_make_of1x1_bank_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="shape"):
        tfb.make_of1x1_bank(np.ones((2, 64)), np.ones((3, 64)), FS, 16)


def _two_slot_bank(n=1024, pretrig=256):
    t1 = tpulse.make_template(FS, n, pretrig, **POLES["twopole"])
    t2 = tpulse.make_template(FS, n, pretrig, **POLES["fourpole"])
    return jfb.make_of1x1_bank(np.stack([t1, t2]),
                               np.stack([_psd(n), _psd(n, 3e-20, 20.0)]),
                               FS, pretrig)


@pytest.mark.parametrize("n", [1024, 1023])
def test_bank_to_torch_matches_jax_half_bank(n):
    bank = _two_slot_bank(n)
    got = tfb.bank_to_torch(bank, "cpu", torch.float64)
    dev = bank.to_device(np.float64)
    assert set(got) == set(tfb.HALF_BANK_KEYS)
    for key in ("phi_h", "s_fft_h"):
        assert got[key].dtype == torch.complex128
        ref = dev[key][..., 0] + 1j * dev[key][..., 1]
        np.testing.assert_allclose(got[key].numpy(), ref, rtol=TOL, atol=0)
    for key in ("denom_inv_h", "bin_w", "norm"):
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), dev[key], rtol=TOL,
                                   atol=0)
    assert got["phi_h"].shape == (2, n // 2 + 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bank_from_jax_round_trips_to_device(dtype):
    bank = _two_slot_bank()
    dev = bank.to_device(np.float64)
    got = tfb.bank_from_jax(dev, "cpu", dtype)
    want = tfb.bank_to_torch(bank, "cpu", dtype)
    for key in tfb.HALF_BANK_KEYS:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    # and back: splitting the complex tensors recovers the JAX arrays
    for key in ("phi_h", "s_fft_h"):
        split = torch.view_as_real(got[key]).numpy()
        np.testing.assert_allclose(split, dev[key], rtol=0,
                                   atol=0 if dtype == torch.float64 else
                                   1e-6 * np.max(np.abs(dev[key])))


def test_bank_dtype_must_be_real_float():
    with pytest.raises(TypeError, match="float32 or float64"):
        tfb.bank_to_torch(_two_slot_bank(), "cpu", torch.complex64)
