"""The port's of1x1 feature step equals the JAX package's and the
per-event reference.

``detprocess_tpu_torch.pipelines.feature_step.FeatureStep`` on CPU tensors
(float64, the kernels' plain twins) against:

- the JAX group function's chain for the slice config (compound mix,
  rfft, of1x1_nodelay, of1x1_unconstrained with lowchi2_fcutoff 10000,
  baseline, integral; pipelines/features.py ``fn``) on the natural half
  spectrum, N = 2048;
- the JAX entry point's own feature step (``__graft_entry__.entry``) at
  its N = 16384, where the default dispatch is the packed chain;
- ``tests/reference_impl.py::RefOF1x1``, one event at a time.

All comparisons are float64 at 1e-9.
"""

import importlib.util
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import fft as dfft
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops import tracestats as jts
from detprocess_tpu_torch import entry as tentry
from detprocess_tpu_torch.ops import filterbank as tfb
from detprocess_tpu_torch.pipelines.feature_step import FeatureStep
from reference_impl import RefOF1x1

torch.set_num_threads(1)

FS = 1.25e6
N = 2048
PRETRIG = 1024
B = 16
FCUT = 10000.0
RTOL = 1e-9


def _psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


def _templates():
    t1 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    t2 = jpulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=12e-6,
                              tau_f1=90e-6)
    return t1, t2


def _raw(rng, nraw, t1):
    raw = rng.standard_normal((B, nraw, N)) * 1e-8
    amps = rng.uniform(1e-6, 3e-6, (B, nraw))
    shifts = rng.integers(-100, 100, (B, nraw))
    for b in range(B):
        for r in range(nraw):
            raw[b, r] += amps[b, r] * np.roll(t1, shifts[b, r])
    return raw


def jax_feature_step(raw, mix, dev, channels, slots, n, pretrig, fs):
    """The JAX group function's chain for channels running of1x1_nodelay,
    of1x1_unconstrained, baseline and integral (natural half spectrum)."""
    traces = dfft.einsum("cr,brn->bcn", jnp.asarray(mix), jnp.asarray(raw))
    bh = jfb.device_bank_1x1_half(dev)
    vh = jof.signal_rfft(traces)
    lmask = jnp.asarray(jof.lowfreq_mask_half(n, fs, FCUT))
    out = {}
    for ci, (chan, s) in enumerate(zip(channels, slots)):
        sl = slice(s, s + 1)
        args = (bh.phi[sl], bh.norm[sl], bh.denom_inv[sl], bh.s_fft[sl],
                bh.bin_w)
        vr = vh[:, ci, :][:, None, :]
        r = jof.of1x1_nodelay_half(vr, *args, lmask, n=n)
        for field in ("amp", "chi2", "lowchi2"):
            out[f"{field}_of1x1_nodelay_{chan}"] = getattr(r, field)[:, 0]
        r = jof.of1x1_withdelay_half(vr, *args, pretrig, fs,
                                     low_mask_h=lmask, n=n)
        for field in ("amp", "t0", "chi2", "lowchi2"):
            out[f"{field}_of1x1_unconstrained_{chan}"] = (
                getattr(r, field)[:, 0])
        tr = traces[:, ci, :]
        out[f"baseline_{chan}"] = jts.baseline(tr, 0, n - 1)
        out[f"integral_{chan}"] = jts.integral(tr, fs, 0, n - 1)
    return out


def _cmp(got, ref):
    assert set(got) == set(ref)
    for key, r in ref.items():
        g = got[key]
        assert g.shape == (B,), key
        r = np.asarray(r)
        if key.startswith("t0_"):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=key)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=RTOL,
                                       atol=RTOL * 1e-12, err_msg=key)


@pytest.mark.parametrize("case", ["one_channel", "mixed_two_slots"])
def test_feature_step_matches_jax_natural_chain(case):
    rng = np.random.default_rng(21)
    t1, t2 = _templates()
    if case == "one_channel":
        bank = jfb.make_of1x1_bank(t1, _psd(N), FS, PRETRIG)
        channels, slots, mix = ["chan1"], [0], np.eye(1)
    else:
        bank = jfb.make_of1x1_bank(np.stack([t1, t2]),
                                   np.stack([_psd(N), _psd(N, 3e-20, 20.0)]),
                                   FS, PRETRIG)
        # a compound channel beside a plain one, on the other bank slot
        channels, slots = ["chanA", "chanAB"], [1, 0]
        mix = np.array([[1.0, 0.0], [0.5, 0.5]])
    raw = _raw(rng, mix.shape[1], t1)
    host = bank.to_device(np.float64)
    dev = {k: jnp.asarray(v) for k, v in host.items()}
    ref = jax_feature_step(raw, mix, dev, channels, slots, N, PRETRIG, FS)

    step = FeatureStep(tfb.bank_from_jax(host, "cpu", torch.float64),
                       channels, FS, PRETRIG, N, mix=mix, slots=slots)
    got = step(torch.as_tensor(raw))
    _cmp(got, ref)


def test_feature_step_matches_reference_impl():
    rng = np.random.default_rng(22)
    t1, _ = _templates()
    psd = _psd(N)
    bank = tfb.make_of1x1_bank(t1, psd, FS, PRETRIG)
    raw = _raw(rng, 1, t1)
    step = FeatureStep(tfb.bank_to_torch(bank, "cpu", torch.float64),
                       ["chan1"], FS, PRETRIG, N)
    got = {k: v.numpy() for k, v in step(torch.as_tensor(raw)).items()}
    ref = RefOF1x1(t1, psd, FS, PRETRIG)
    for b in range(B):
        x = raw[b, 0]
        amp, chi2, low = ref.fit_nodelay(x, lowchi2_fcutoff=FCUT)
        np.testing.assert_allclose(
            [got["amp_of1x1_nodelay_chan1"][b],
             got["chi2_of1x1_nodelay_chan1"][b],
             got["lowchi2_of1x1_nodelay_chan1"][b]],
            [amp, chi2, low], rtol=RTOL)
        amp, t0, chi2, low = ref.fit_withdelay(x, lowchi2_fcutoff=FCUT)
        np.testing.assert_allclose(
            [got["amp_of1x1_unconstrained_chan1"][b],
             got["chi2_of1x1_unconstrained_chan1"][b],
             got["lowchi2_of1x1_unconstrained_chan1"][b]],
            [amp, chi2, low], rtol=RTOL)
        assert got["t0_of1x1_unconstrained_chan1"][b] == t0
        np.testing.assert_allclose(got["baseline_chan1"][b],
                                   np.mean(x[:N - 1]), rtol=RTOL)
        np.testing.assert_allclose(got["integral_chan1"][b],
                                   np.trapezoid(x[:N - 1]) / FS, rtol=RTOL)


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry_for_torch_parity",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_jax_entry_packed_chain():
    """The port's ``entry()`` against the JAX ``__graft_entry__.entry()``
    feature step (N = 16384: the packed chain is its default there), on
    the same bank in float64 and the same example batch."""
    mod = _graft_entry()
    fn, _ = mod.entry()
    step, (x,) = tentry.entry("cpu", torch.float64)
    n = step.n
    assert dfft.site_packed(n, "feature")
    bank, _ = mod._build_bank(n, step.pretrigger, step.fs)
    dev = dict(bank.to_device(np.float64))
    dev["pk"] = jfb.packed_half_coeffs(bank, np.float64)
    dev = jax.tree.map(jnp.asarray, dev)
    traces = x[:, 0, :].numpy()
    ref = fn(jnp.asarray(traces), dev)
    got = step(x)
    c = tentry.CHANNEL
    pairs = {"amp_nodelay": f"amp_of1x1_nodelay_{c}",
             "chi2_nodelay": f"chi2_of1x1_nodelay_{c}",
             "amp": f"amp_of1x1_unconstrained_{c}",
             "t0": f"t0_of1x1_unconstrained_{c}",
             "chi2": f"chi2_of1x1_unconstrained_{c}",
             "baseline": f"baseline_{c}", "integral": f"integral_{c}"}
    assert set(ref) == set(pairs)
    for jkey, tkey in pairs.items():
        r = np.asarray(ref[jkey])
        g = got[tkey].numpy()
        assert g.shape == r.shape == (x.shape[0],), jkey
        if jkey == "t0":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, err_msg=jkey)
    # the port's step also matches its own bank builder's bank
    np.testing.assert_allclose(step.norm.numpy(), bank.norm, rtol=1e-12)


@pytest.mark.parametrize("name", ["entry", "trigger_entry",
                                  "feature_processing_entry"])
def test_entry_device_none_is_the_gpu(monkeypatch, tmp_path, name):
    """``device=None`` means the GPU: without one an entry point raises
    before it builds or writes anything, rather than running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tentry, name)()
    assert os.listdir(tmp_path) == []


def test_feature_step_off_kernel_length_matches_jax():
    """At N = 25000, outside the kernels' lengths, the step takes the
    half-spectrum no-delay fit on the spectrum it already has (the JAX
    feature step's route, pipelines/features.py:842), chosen from n."""
    n, pretrig = 25000, 12500
    rng = np.random.default_rng(23)
    t1 = jpulse.make_template(FS, n, pretrig, A=1.0, tau_r=20e-6,
                              tau_f1=200e-6)
    bank = jfb.make_of1x1_bank(t1, _psd(n), FS, pretrig)
    raw = rng.standard_normal((B, 1, n)) * 1e-8
    raw += rng.uniform(1e-6, 3e-6, (B, 1, 1)) * np.roll(t1, 40)
    host = bank.to_device(np.float64)
    dev = {k: jnp.asarray(v) for k, v in host.items()}
    ref = jax_feature_step(raw, np.eye(1), dev, ["chan1"], [0], n, pretrig,
                           FS)
    step = FeatureStep(tfb.bank_from_jax(host, "cpu", torch.float64),
                       ["chan1"], FS, pretrig, n)
    assert step.nodelay is None
    _cmp(step(torch.as_tensor(raw)), ref)


def test_feature_step_validates_its_config():
    t1, _ = _templates()
    tb = tfb.bank_to_torch(tfb.make_of1x1_bank(t1, _psd(N), FS, PRETRIG),
                           "cpu", torch.float64)
    with pytest.raises(ValueError, match="bins"):
        FeatureStep(tb, ["c"], FS, PRETRIG, 2 * N)
    with pytest.raises(ValueError, match="mix"):
        FeatureStep(tb, ["c"], FS, PRETRIG, N, mix=np.eye(2))
    with pytest.raises(ValueError, match="slot"):
        FeatureStep(tb, ["c"], FS, PRETRIG, N, slots=[0, 0])
