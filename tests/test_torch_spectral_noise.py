"""The port's spectral estimates, quality cuts and Noise against JAX.

- ``ops/spectral``: ``welch_psd``, ``welch_csd``, ``periodogram`` and
  ``fold_spectrum``, with and without the hann window, at even and odd N
  (the port mirrors half spectra onto the two-sided axis);
- ``ops/autocuts``: ``autocuts`` (2-D and 3-D) and ``autocuts_didv`` at
  ``niter`` None, 1 and 5, on a batch with glitches and drifts and on the
  heavy-tailed batch of tests/test_autocuts_convergence.py (masks equal);
- ``pipelines/noise.Noise``: ``calc_psd`` (with the compound channels
  ``a+b`` and ``a-b``), ``calc_csd`` and ``get_offset`` on pytesdaq files
  written by the JAX ``RawWriter`` as int16 codes, at even and odd N, and
  its refusals.

Everything runs in float64 on the CPU; the tolerance is 1e-9 relative
(CSD entries: of the largest |entry|).
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.ops import autocuts as jcuts
from detprocess_tpu.ops import spectral as jspectral
from detprocess_tpu.pipelines.noise import Noise as JaxNoise
from detprocess_tpu_torch.ops import autocuts as cuts
from detprocess_tpu_torch.ops import spectral
from detprocess_tpu_torch.pipelines.noise import Noise

from test_autocuts_convergence import _heavy_tailed_batch

torch.set_num_threads(1)

FS = 1.25e6
RTOL = 1e-9
CHANNELS = ["chan1", "chan2", "chan3"]


def _t(x):
    return torch.as_tensor(np.array(x))


# -- spectral ----------------------------------------------------------------

@pytest.mark.parametrize("n", [256, 255])
@pytest.mark.parametrize("window", [None, "hann"])
def test_welch_psd_csd_match_jax(n, window):
    x = np.random.default_rng(n).standard_normal((40, 3, n)) + 0.3
    want = np.asarray(jspectral.welch_psd(jnp.asarray(x[:, 1]), FS,
                                          window=window))
    got = spectral.welch_psd(_t(x[:, 1]), FS, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the leading axes are batch axes ([..., B, N])
    want3 = np.asarray(jspectral.welch_psd(jnp.asarray(x.transpose(1, 0, 2)),
                                           FS, window=window))
    got3 = spectral.welch_psd(_t(x.transpose(1, 0, 2)), FS,
                              window=window).numpy()
    np.testing.assert_allclose(got3, want3, rtol=RTOL)
    want = np.asarray(jspectral.welch_csd(jnp.asarray(x), FS, window=window))
    got = spectral.welch_csd(_t(x), FS, window=window).numpy()
    assert got.shape == want.shape == (3, 3, n)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("n", [128, 127])
def test_periodogram_and_fold_match_jax(n):
    x = np.random.default_rng(7).standard_normal((5, n))
    want = np.asarray(jspectral.periodogram(jnp.asarray(x), FS))
    got = spectral.periodogram(_t(x), FS).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_array_equal(
        spectral.fold_spectrum(_t(want)).numpy(),
        np.asarray(jspectral.fold_spectrum(jnp.asarray(want))))
    np.testing.assert_array_equal(
        spectral.fold_spectrum(_t(want), n).numpy(),
        np.asarray(jspectral.fold_spectrum(jnp.asarray(want), n)))


def test_unknown_window_refused():
    with pytest.raises(ValueError, match="unknown window"):
        spectral.welch_psd(torch.zeros(2, 8, dtype=torch.float64), FS,
                           window="blackman")


# -- autocuts ----------------------------------------------------------------

def _glitchy_batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((400, 2, 512))
    x[::37, 0, 100:103] += 25.0                       # glitches
    x[5::41, 1] += np.linspace(0.0, 6.0, 512)         # drifts
    x[11::53] += 3.0                                  # baseline jumps
    return x


@pytest.mark.parametrize("niter", [None, 1, 5])
@pytest.mark.parametrize("batch", ["glitchy", "heavy_tailed"])
def test_autocuts_masks_match_jax(niter, batch):
    if batch == "glitchy":
        x = _glitchy_batch()
    else:
        rng = np.random.default_rng(0)
        x = np.stack([_heavy_tailed_batch(rng), _heavy_tailed_batch(rng)],
                     axis=1)
    for traces in (x[:, 0], x):
        want = np.asarray(jcuts.autocuts_noise(jnp.asarray(traces),
                                               niter=niter))
        got = cuts.autocuts_noise(_t(traces), niter=niter).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jcuts.autocuts_didv(jnp.asarray(traces),
                                              niter=niter))
        got = cuts.autocuts_didv(_t(traces), niter=niter).numpy()
        np.testing.assert_array_equal(got, want)


def test_autocuts_passes_count_each_channel():
    """Channels cut batched ([C, B]) give each channel the masks and the
    pass counts of its own cut; the heavy-tailed channel needs more passes
    than the Gaussian one; the masks are fixed points (one more pass
    changes nothing)."""
    rng = np.random.default_rng(1)
    x = np.stack([rng.standard_normal((600, 128)),
                  _heavy_tailed_batch(rng)], axis=1)
    stages, passes = cuts.cut_stages(cuts.metrics(_t(x)))
    for c in range(2):
        one, one_passes = cuts.cut_stages(cuts.metrics(_t(x[:, c])))
        np.testing.assert_array_equal(stages[:, c].numpy(), one.numpy())
        assert [int(p[c]) for p in passes] == [int(p) for p in one_passes]
    assert passes[0][1] > passes[0][0]
    for metric, mask in zip(cuts.metrics(_t(x)), stages):
        np.testing.assert_array_equal(
            cuts.clip_pass(metric, mask, 2.5).numpy(), mask.numpy())


# -- Noise -------------------------------------------------------------------

@pytest.fixture(scope="module")
def noise_files(tmp_path_factory):
    """Two dumps of 3 continuous int16 events, 3 channels: correlated
    noise, an offset, one large glitch and a drift for the cuts."""
    root = tmp_path_factory.mktemp("torch_noise")
    rng = np.random.default_rng(11)
    length = 60000
    w = RawWriter(str(root), "I1_D20260816_T160000", FS, CHANNELS,
                  adc_conversion_factor=2e-9,
                  detector_config={"chan2": {"close_loop_norm": 1.5}})
    for dump in (1, 2):
        x = rng.standard_normal((3, 3, length)) * 2e-6
        x[:, 1] += 0.5 * x[:, 0]
        x += np.array([1e-6, -5e-7, 2e-7])[None, :, None]
        x[1, 0, 20000:20040] += 3e-5
        x[2, 2] += np.linspace(0.0, 2e-5, length)
        w.write_dump(x, dump_num=dump)
    return sorted(str(p) for p in root.glob("*.hdf5"))


def _noise_pair(files, seed=4, **kw):
    jn = JaxNoise(files, verbose=False)
    tn = Noise(files, verbose=False, device="cpu")
    draw = dict(random_rate=200.0, seed=seed, min_separation_msec=1.0,
                edge_exclusion_msec=2.0, **kw)
    jdf = jn.generate_randoms(**draw)
    table = tn.generate_randoms(**draw)
    for col in jdf.columns:
        np.testing.assert_array_equal(np.asarray(table[col]),
                                      jdf[col].to_numpy())
    return jn, tn


def _assert_stored_equal(tn, jn, chan, name):
    v, _, md = tn._get(chan, name)
    jv = np.asarray(jn._get(chan, name))
    jmd = jn._get(chan, name, return_metadata=True)[1]
    assert md == jmd
    np.testing.assert_allclose(v, jv, rtol=0,
                               atol=RTOL * np.abs(jv).max())


@pytest.mark.parametrize("n", [2048, 2047])
def test_noise_psd_offsets_match_jax(noise_files, n):
    jn, tn = _noise_pair(noise_files)
    chans = ["chan1", "chan1+chan2", "chan2-chan3", "chan3"]
    kw = dict(trace_length_samples=n, pretrigger_length_samples=n // 3)
    jn.calc_psd(chans, **kw)
    tn.calc_psd(chans, **kw)
    for chan in chans:
        _assert_stored_equal(tn, jn, chan, "psd_default")
        np.testing.assert_allclose(tn.get_offset(chan), jn.get_offset(chan),
                                   rtol=RTOL)
        for fold in (False, True):
            for got, want in zip(tn.get_psd(chan, fold=fold),
                                 jn.get_psd(chan, fold=fold)):
                np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tn.get_sample_rate() == jn.get_sample_rate() == FS
    # the glitch and the drift are cut
    assert 0 < tn.stats["kept"]["chan1"] < tn.stats["windows"]


@pytest.mark.parametrize("window", [None, "hann"])
def test_noise_csd_matches_jax_and_shares_the_read(noise_files, window):
    jn, tn = _noise_pair(noise_files, seed=9)
    kw = dict(trace_length_samples=1024, pretrigger_length_samples=512,
              window=window)
    jn.calc_psd(CHANNELS, **kw)
    tn.calc_psd(CHANNELS, **kw)
    windows = tn._windows
    jn.calc_csd(CHANNELS, **kw)
    tn.calc_csd(CHANNELS, **kw)
    assert tn._windows is windows          # one read for both
    _assert_stored_equal(tn, jn, "|".join(CHANNELS), "csd_default")
    for chan in CHANNELS:
        _assert_stored_equal(tn, jn, chan, "psd_default")
    # a CSD over another channel order reads anew
    jn.calc_csd(CHANNELS[::-1], tag="rev", **kw)
    tn.calc_csd(CHANNELS[::-1], tag="rev", **kw)
    assert tn._windows is not windows
    _assert_stored_equal(tn, jn, "|".join(CHANNELS[::-1]), "csd_rev")


def test_noise_set_randoms_and_refusals(noise_files):
    jn, tn = _noise_pair(noise_files, seed=2)
    other = Noise(noise_files, verbose=False, device="cpu")
    other.set_randoms(tn.get_randoms())
    other.calc_psd("chan2", trace_length_samples=512)
    jn.calc_psd("chan2", trace_length_samples=512)
    _assert_stored_equal(other, jn, "chan2", "psd_default")
    assert other.get_offset("chan1") is None
    with pytest.raises(NotImplementedError, match="item 7"):
        other.calc_psd("chan1", trace_length_samples=512, mesh=object())
    with pytest.raises(NotImplementedError, match="item 7"):
        other.calc_csd(CHANNELS, trace_length_samples=512, mesh=object())
    other.clear_randoms()
    assert other.get_sample_rate() is None
    with pytest.raises(ValueError, match="no randoms"):
        other.calc_psd("chan1", trace_length_samples=512)
    with pytest.raises(ValueError, match="rejected all"):
        tn.calc_psd("chan1", trace_length_samples=512, nsigma_cut=0.0)
    with pytest.raises(ValueError, match="raw data required"):
        Noise(None, device="cpu").generate_randoms(nrandoms=4)
