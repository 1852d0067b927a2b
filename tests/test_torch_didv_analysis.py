"""The port's ``DIDVAnalysis`` (``pipelines/didv``) against the JAX
package's, and the filter store of the fits in both packages' files, in
float64 on the CPU.

- the chain on one raw dIdV file (a two-block TES's response to the
  100 Hz square wave, 8 traces of 3 periods at 1.25 MHz, int16 codes
  written by the JAX ``RawWriter``, one trace with a step for the cuts):
  ``process_raw_data`` (device ``"cpu"``), ``dofit`` at 2 and 3 poles,
  ``dofit_prior``, ``set_ivsweep_results``,
  ``calc_smallsignal_params``, ``calc_bias_params_infinite_loop_gain``,
  ``calc_dpdi``, ``calc_energy_resolution``, ``get_fit_results``,
  ``compare_with_ivsweep`` (a Table with the DataFrame's columns),
  ``print_fit_result``, ``save_didv_data``, ``enable_auto_save`` and
  ``clear``;
- ``set_iv_bor_data`` on beginning-of-run IV files and
  ``set_ivsweep_results_from_file`` on a JAX-written file;
- the store: ``didv_results_*``, ``ivsweep_results_*``,
  ``ivsweep_data_*`` (a processed sweep) and a dIdV dataframe written by
  the port and read by the JAX ``FilterData``, and the JAX file read by
  the port, equal both ways.

Tolerances: 1e-9 relative for the lock-in's ``DIDVData`` and what the
store carries; 1e-6 for the fits and the quantities of their parameters
(small-signal values, the infinite-loop-gain point, dPdI, σ_E); 1e-5 for
the small-signal errors, which come from the inverse of the fits' JᵀJ
(condition numbers up to 1e9 here: the rounding-level difference between
the closed-form and the forward-mode Jacobians moves them by cond·eps).
"""

import math

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.pipelines.didv import DIDVAnalysis as JaxDIDV
from detprocess_tpu.pipelines.ivsweep import IVSweepProcessing as JaxIVP
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.io.filterdata import FilterData, Table
from detprocess_tpu_torch.models import didv as didv_models
from detprocess_tpu_torch.pipelines.didv import DIDVAnalysis
from detprocess_tpu_torch.pipelines.ivsweep import IVSweepProcessing

torch.set_num_threads(2)

RTOL = 1e-9
FIT_RTOL = 1e-6
ERR_RTOL = 1e-5
CHAN = "chan1"
FS, SGFREQ, SGAMP, RSH = entry.FS, entry.IV_SGFREQ, entry.IV_SGAMP, 5e-3
TRUTH3 = np.array([0.309, -0.41, 0.3, -1.1e-4, 3.3e-6, 3e-4])
I0, R0 = 3.16e-6, 0.1
IV = {"i0": I0, "r0": R0, "rp": 4e-3, "rshunt": RSH, "ibias": 100e-6,
      "p0": I0 ** 2 * R0, "i0_err": 1e-9, "r0_err": 1e-3, "p0_err": 1e-15}
N_TEMPLATE = 4096


def _didv_traces(rng, nev=8, nper=3):
    """The response of the 3-pole model to the square wave, white noise
    and an offset; trace 2 carries a step for the cuts."""
    period = int(FS / SGFREQ)
    n = period * nper
    t = np.arange(n)
    square_v = np.where((t % period) < period // 2, 0.5, -0.5) * SGAMP * RSH
    f = np.fft.fftfreq(n, 1 / FS)
    resp = didv_models.didv_model(TRUTH3, f, 3).numpy()
    resp_t = np.real(np.fft.ifft(resp * np.fft.fft(square_v)))
    x = resp_t[None] + 2e-10 * rng.standard_normal((nev, n)) + 2e-6
    x[2, n // 2:] += 2e-8
    return x


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("didv")
    rng = np.random.default_rng(5)
    w = RawWriter(str(root), "I1_D20260820_T100000", FS, [CHAN, "chan2"],
                  prefix="didv", data_type="didv",
                  adc_conversion_factor=1e-10)
    x = _didv_traces(rng)
    path = w.write_dump(np.stack([x, 0.5 * x], axis=1))
    return root, [path]


def _template():
    t = np.arange(N_TEMPLATE) / FS
    t0 = t[N_TEMPLATE // 2]
    tmpl = np.where(t >= t0, np.exp(-(t - t0) / 2e-4)
                    - np.exp(-(t - t0) / 2e-5), 0.0)
    return tmpl / tmpl.max()


def _chain(cls, files, store_path, **kw):
    ana = cls(verbose=False, **kw)
    ana.process_raw_data(CHAN, files, SGFREQ, SGAMP, RSH)
    ana.enable_auto_save(str(store_path))
    ana.dofit(CHAN, poles=(2, 3))
    ana.set_ivsweep_results(CHAN, dict(IV))
    ana.calc_smallsignal_params(CHAN, poles=(2, 3))
    out = {"ilg": ana.calc_bias_params_infinite_loop_gain(CHAN, poles=3)}
    freqs = np.fft.fftfreq(N_TEMPLATE, 1 / FS)
    out["dpdi"] = ana.calc_dpdi(CHAN, freqs, poles=3)[CHAN]
    psd = 1e-22 * (1 + 1e3 / (np.abs(freqs) + 1.0))
    out["sigma"] = ana.calc_energy_resolution(CHAN, _template(), psd, FS,
                                              poles=3)
    out["results"] = {p: ana.get_fit_results(CHAN, p) for p in (2, 3)}
    out["compare"] = ana.compare_with_ivsweep(CHAN, poles=3)
    ana.save_didv_data(CHAN)
    out["ana"] = ana
    return out


@pytest.fixture(scope="module")
def chains(raw, tmp_path_factory):
    _, files = raw
    tmp = tmp_path_factory.mktemp("stores")
    return (_chain(DIDVAnalysis, files, tmp / "port.hdf5", device="cpu"),
            _chain(JaxDIDV, files, tmp / "jax.hdf5"), tmp)


def test_processed_data_matches_jax(chains):
    got, want, _ = chains
    g = got["ana"].get_didv_data(CHAN)
    w = want["ana"].get_didv_data(CHAN)
    for field in w._fields:
        a, b = np.asarray(getattr(g, field)), np.asarray(getattr(w, field))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=RTOL * max(np.abs(b).max(), 1e-300),
                                   err_msg=field)
    assert g.nb_traces_kept == 7
    assert got["ana"].get_qetpy_object(CHAN) is g


@pytest.mark.parametrize("poles", [2, 3])
def test_fits_and_smallsignal_match_jax(chains, poles):
    got, want, _ = chains
    g, w = got["results"][poles], want["results"][poles]
    assert list(g) == list(w)
    np.testing.assert_allclose(g["params"], w["params"], rtol=FIT_RTOL)
    np.testing.assert_allclose(g["cost"], w["cost"], rtol=FIT_RTOL)
    gs, ws = g["smallsignalparams"], w["smallsignalparams"]
    assert list(gs) == list(ws)
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=ERR_RTOL
                                   if k.endswith("_err") else FIT_RTOL,
                                   err_msg=k)
    assert g["biasparams"] == w["biasparams"]
    if poles == 3:
        # τ₂ (a 50 kHz corner) lies above the 200 harmonics that dofit
        # uses (up to 40 kHz): the other parameters hold the truth
        keep = [0, 1, 2, 3, 5]
        np.testing.assert_allclose(g["params"][keep], TRUTH3[keep],
                                   rtol=0.05)


def test_ilg_dpdi_and_energy_resolution_match_jax(chains):
    got, want, _ = chains
    assert got["ilg"][CHAN] == pytest.approx(want["ilg"][CHAN],
                                             rel=FIT_RTOL)
    for a, b in zip(got["dpdi"], want["dpdi"]):
        np.testing.assert_allclose(a, b, rtol=FIT_RTOL,
                                   atol=FIT_RTOL * np.abs(b).max())
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=FIT_RTOL)
    assert math.isfinite(got["sigma"]) and got["sigma"] > 0


def test_compare_with_ivsweep_is_the_dataframe(chains):
    got, want, _ = chains
    g, w = got["compare"], want["compare"]
    assert isinstance(g, Table)
    assert list(g) == list(w.columns)
    assert g.index == list(w.index)
    for col in w.columns:
        assert list(g[col]) == list(w[col]), col


def test_dofit_prior_matches_jax(chains):
    got, want, _ = chains
    mean = np.array(got["results"][2]["params"]) * 1.01
    cov = np.diag((0.1 * mean) ** 2)
    for ana in (got["ana"], want["ana"]):
        ana.dofit_prior(CHAN, mean, cov, poles=2)
    g, w = got["ana"].get_fit(CHAN, 2), want["ana"].get_fit(CHAN, 2)
    np.testing.assert_allclose(g.params, w.params, rtol=FIT_RTOL)
    np.testing.assert_allclose(g.cost, w.cost, rtol=FIT_RTOL)


def test_print_and_getters(chains, capsys):
    got, want, _ = chains
    for ana in (got["ana"], want["ana"]):
        ana.print_fit_result(CHAN, poles=3)
        ana.print_fit_result(CHAN, poles=1)
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert [line.split("=")[0] for line in out[:half]] == [
        line.split("=")[0] for line in out[half:]]
    ana = got["ana"]
    assert ana.get_bias_params(CHAN, poles=3) == IV
    assert ana.get_bias_params_infinite_loop_gain(CHAN, 3) is \
        ana._ilg[CHAN][3]
    with pytest.raises(ValueError, match="infinite loop gain"):
        ana.get_bias_params_infinite_loop_gain(CHAN, 2)
    with pytest.raises(ValueError, match="No dIdV data"):
        ana.get_qetpy_object("chan9")
    assert ana.get_fit_results("chan9", 2, verbose=False) == {}


STORE_KEYS = ("didv_results_2poles_default", "didv_results_3poles_default",
              "didv_results_3poles_smallsignalparams_default",
              "didv_results_3poles_biasparams_default",
              "ivsweep_results_noise_default", "dpdi_3poles_default")


def _same(a, b, what):
    if isinstance(b, pd.Series):
        b = b.to_numpy()
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _same(a[k], b[k], f"{what}.{k}")
        return
    if isinstance(b, pd.DataFrame):
        assert list(a) == list(b.columns), what
        for c in b.columns:
            _same(list(a[c]), list(b[c]), f"{what}.{c}")
        return
    if isinstance(b, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            assert (x is None) == (y is None or (isinstance(y, float)
                                                 and np.isnan(y))), what
            if x is not None:
                _same(x, y, what)
        return
    b = np.asarray(b)
    if b.dtype.kind in "OUS":
        assert np.asarray(a).astype(str).tolist() == b.astype(str).tolist()
        return
    np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL, equal_nan=True,
                               err_msg=what)


@pytest.fixture(scope="module")
def sweep_tables(tmp_path_factory):
    """A small processed sweep (both packages) for the store."""
    root = tmp_path_factory.mktemp("sweep_store")
    pts = entry.ivsweep_points(normal=(400e-6, 350e-6, 300e-6),
                               transition_r0=(0.1,), sc=(3e-6, 2e-6, 1e-6))
    gen = torch.Generator().manual_seed(2)
    bps = []
    for k, pt in enumerate(pts):
        w = RawWriter(str(root), f"I1_D20260820_T{110000 + k:06d}", FS,
                      [CHAN], prefix="iv", data_type="noise")
        noise = entry.ivsweep_noise(gen, pt["params"], 4, 1024, "cpu")
        bps.append({"tes_bias": pt["tes_bias"],
                    "noise_files": [w.write_dump(noise.numpy()[:, None])]})
    return (IVSweepProcessing(verbose=False, device="cpu").process(CHAN, bps),
            JaxIVP(verbose=False).process(CHAN, bps))


def test_store_written_by_the_port_reads_in_jax(chains, sweep_tables,
                                                tmp_path):
    got, want, tmp = chains
    port = got["ana"]
    port.set_ivsweep_data(CHAN, sweep_tables[0])
    port.set_didv_dataframe(CHAN, Table({
        "series_name": np.array(["I1_D1_T1", "I1_D1_T2"], dtype=object),
        "chi2_2poles_fit": np.array([1.5, 2.5])}))
    path = tmp_path / "port.hdf5"
    port.save_hdf5(str(path))
    jfd = JaxFilterData(verbose=False).load_hdf5(str(path))
    for key in STORE_KEYS:
        _same(jfd._get(CHAN, key), port._get(CHAN, key)[0], key)
    _same(port._get(CHAN, "ivsweep_data_default")[0],
          jfd._get(CHAN, "ivsweep_data_default"), "ivsweep_data")
    _same(port._get(CHAN, "didv_processing_default")[0],
          jfd._get(CHAN, "didv_processing_default"), "didv_processing")
    # auto-save wrote the port's store as it went
    auto = FilterData(verbose=False).load_hdf5(str(tmp / "port.hdf5"))
    assert auto.has(CHAN, "didv_results_3poles_smallsignalparams_default")


def test_store_written_by_jax_reads_in_the_port(chains, sweep_tables,
                                                tmp_path):
    got, want, _ = chains
    jax_ana = want["ana"]
    jax_ana.set_ivsweep_data(CHAN, sweep_tables[1])
    path = tmp_path / "jax.hdf5"
    jax_ana.save_hdf5(str(path))
    fd = FilterData(verbose=False).load_hdf5(str(path))
    for key in STORE_KEYS:
        _same(fd._get(CHAN, key)[0], jax_ana._get(CHAN, key), key)
    _same(fd._get(CHAN, "ivsweep_data_default")[0], sweep_tables[1],
          "ivsweep_data")
    # the JAX file's IV results feed a port analysis
    ana = DIDVAnalysis(verbose=False, device="cpu")
    ana.set_ivsweep_results_from_file(CHAN, str(path))
    assert ana._bias_params[CHAN] == pytest.approx(IV)


def test_iv_bor_data_matches_jax(chains, tmp_path):
    rng = np.random.default_rng(9)
    biases = (400e-6, 350e-6, 300e-6, 100e-6)
    rl = RSH + 4e-3
    for k, ib in enumerate(biases):
        r0 = 0.3 if k < 3 else 0.1
        i0 = ib * RSH / (r0 + rl) - 1.3e-6
        w = RawWriter(str(tmp_path), f"I1_D20260820_T12000{k}", FS, [CHAN],
                      prefix="iv_bor", data_type="iv",
                      detector_config={CHAN: {"tes_bias": ib}})
        w.write_dump(i0 + 1e-9 * rng.standard_normal((3, 1, 2048)))
    out = []
    for cls, kw in ((DIDVAnalysis, {"device": "cpu"}), (JaxDIDV, {})):
        ana = cls(verbose=False, **kw)
        ana.set_ivsweep_results(CHAN, {"rp": 4e-3, "rshunt": RSH})
        out.append(ana.set_iv_bor_data(str(tmp_path), 0, CHAN))
        assert ana._bias_params[CHAN]["r0"] == out[-1]["r0"]
    assert list(out[0]) == list(out[1])
    for k in out[1]:
        np.testing.assert_allclose(out[0][k], out[1][k], rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(out[0]["r0"], 0.1, rtol=0.01)
    with pytest.raises(ValueError, match="Unable to find rp"):
        DIDVAnalysis(verbose=False, device="cpu").set_iv_bor_data(
            str(tmp_path), 0, CHAN)


def test_clear_and_refusals(raw):
    _, files = raw
    ana = DIDVAnalysis(verbose=False, device="cpu")
    ana.process_raw_data(CHAN, files, SGFREQ, SGAMP, RSH, nevents=5)
    # of 5 traces none can lie 2.5σ out: (n − 1)/√n < 2.5
    assert ana.get_didv_data(CHAN).nb_traces_kept == 5
    with pytest.raises(ValueError, match="IV sweep results required"):
        ana.dofit(CHAN, poles=1).calc_smallsignal_params(CHAN, poles=1)
    ana.clear(CHAN)
    assert CHAN not in ana._didv_data and CHAN not in ana._fits
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DIDVAnalysis(verbose=False)
