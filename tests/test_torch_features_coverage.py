"""The port's FeatureProcessing runs every built-in algorithm of the JAX
shell, with the same table.

The configuration of tests/test_feature_full_coverage.py (of1x2x2 with
its full circular scan, ofnxmx2, psd_peaks, phase, energyabsorbed, a
base_algorithm variant and a weighted difference channel), extended with
ofnxm on a chan1|chan2 template shared by both channels (a 2 × 2 CSD with
a cross term), psd_amp and rftau, on the same RawWriter HDF5 of 6 events
of N = 2048 (int16 codes here, so that both shells read the same
values). One JAX run, module-scoped. The port's float64 table equals the
JAX shell's in rows, columns, dtypes and values at 1e-9, rftau's columns
at RFTAU_RTOL (tests/test_torch_pulsefit.py says why).

Also: one rFFT a batch for each spectral compound channel, shared by all
its specs; the plan's refusal of an ofnxmx2 spec without ``fit_window``
(the JAX shell fails there with a bare KeyError in its first batch); and
``entry.feature_coverage_entry`` at a cut size.
"""

import os

import jax  # noqa: F401  (conftest sets the platform and x64)
import numpy as np
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.ops import fft as tfft
from detprocess_tpu_torch.pipelines.features import FeatureProcessing

import torch_feature_cases as cases

torch.set_num_threads(1)

FS = 1.25e6
N = 2048
PRETRIG = 512
CHANNELS = ["chan1", "chan2"]
NB = 6
RFTAU_RTOL = 1e-7


def config():
    return {
        "chan1": {
            "of1x2x2": {"run": True, "template_tag_1": "Scintillation",
                        "template_tag_2": "Evaporation"},
            "ofnxmx2": {"run": True, "template_tag": "both",
                        "template_group_ids": [0, 1],
                        "fit_window": [[PRETRIG - 30, PRETRIG + 30],
                                       [PRETRIG - 10, PRETRIG + 60]]},
            "energyabsorbed": {"run": True, "vb": 1e-6, "i0": 2e-7,
                               "rl": 0.03, "window_min_index": 100,
                               "window_max_index": 1800},
            "of_scint": {"run": True, "base_algorithm": "of1x1_nodelay",
                         "template_tag": "Scintillation"},
            "rftau": {"run": True, "rtau": 30.0, "ftau": 100.0,
                      "t0": PRETRIG - 10},
        },
        "chan2": {
            "psd_peaks": {"run": True, "f_lims": [[10e3, 50e3]],
                          "npeaks": 2, "min_separation_hz": 2000.0},
            "phase": {"run": True, "f_lims": [[10e3, 50e3]], "npeaks": 1},
            "psd_amp": {"run": True, "f_lims": [[45, 65], [1000, 10000],
                                                25e3]},
            "tau2": {"run": True, "base_algorithm": "rftau"},
        },
        "chan1|chan2": {
            "ofnxm": {"run": True, "template_tag": "shared",
                      "amplitude_names": ["shared"],
                      "window_min_from_trig_usec": -40.0,
                      "window_max_from_trig_usec": 40.0},
        },
        "chan1-chan2": {
            "weight_chan1": 1.0,
            "weight_chan2": 2.0,
            "baseline": {"run": True},
        },
    }


def _filter_data(fd, scint, evap, psd):
    for chan in CHANNELS:
        fd.set_psd(chan, psd, FS)
        fd.set_template(chan, scint, FS, pretrigger_length_samples=PRETRIG,
                        tag="Scintillation")
        fd.set_template(chan, evap, FS, pretrigger_length_samples=PRETRIG,
                        tag="Evaporation")
        fd.set_template(chan, scint, FS, pretrigger_length_samples=PRETRIG)
    fd.set_csd("chan1", np.full((1, 1, N), psd[0], dtype=complex), FS)
    fd.set_template("chan1", np.stack([scint, evap])[None, :, :], FS,
                    pretrigger_length_samples=PRETRIG, tag="both")
    csd = np.zeros((2, 2, N), complex)
    csd[0, 0], csd[1, 1] = psd, 1.5 * psd
    csd[1, 0] = 0.5 * psd * np.exp(-2j * np.pi * np.fft.fftfreq(N) * 2)
    csd[0, 1] = np.conj(csd[1, 0])
    fd.set_csd("chan1|chan2", csd, FS)
    fd.set_template("chan1|chan2", np.stack([scint, 0.6 * evap])[:, None, :],
                    FS, pretrigger_length_samples=PRETRIG, tag="shared")
    return fd


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cov")
    rng = np.random.default_rng(77)
    scint = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=10e-6,
                                tau_f1=60e-6)
    evap = pulse.make_template(FS, N, PRETRIG, A=1.0, tau_r=30e-6,
                               tau_f1=400e-6)
    psd = np.full(N, 4e-18)
    sigma = np.sqrt(psd[0] * FS)
    # a scintillation pulse at the pretrigger and an evaporation pulse 40
    # samples later; on chan2 a 25 kHz line and the shared pulse's part
    t = np.arange(N) / FS
    line = 5e-7 * np.sin(2 * np.pi * 25e3 * t + 0.7)
    traces = rng.standard_normal((NB, 2, N)) * sigma
    for ev in range(NB):
        traces[ev, 0] += 30e-6 * scint + 20e-6 * np.roll(evap, 40)
        traces[ev, 1] += line + 18e-6 * np.roll(evap, int(rng.integers(
            -5, 6)))
    w = RawWriter(str(root / "raw"), "I1_D20260816_T250000", FS, CHANNELS,
                  adc_conversion_factor=cases.CAL)
    w.write_dump(traces, dump_num=1)
    jfd = _filter_data(JaxFilterData(verbose=False), scint, evap, psd)
    fpath = str(root / "filter.h5")
    jfd.save_hdf5(fpath)
    cpath = str(root / "cfg.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(config(), f)
    raw_files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    jdf = JaxFP(raw_files, cpath, filter_data=jfd, verbose=False).process(
        batch_size=NB, dtype=np.float64)
    return dict(raw=raw_files, cpath=cpath, fpath=fpath, jdf=jdf,
                scint=scint, evap=evap, psd=psd, root=root)


def _shell(data, cfg=None):
    return FeatureProcessing(data["raw"], cfg or data["cpath"],
                             FilterData(verbose=False).load_hdf5(
                                 data["fpath"]),
                             verbose=False, device="cpu")


@pytest.fixture(scope="module")
def table(data):
    return _shell(data).process(batch_size=NB, dtype=np.float64)


def test_coverage_table_matches_jax(data, table):
    jdf = data["jdf"]
    rftau = [c for c in jdf.columns if "rftau" in c or "tau2" in c]
    assert len(rftau) == 8
    cases.assert_tables_equal({k: v for k, v in table.items()
                               if k not in rftau},
                              jdf.drop(columns=rftau), "coverage")
    cases.assert_tables_equal({k: table[k] for k in rftau}, jdf[rftau],
                              "rftau", rtol=RFTAU_RTOL)


def test_coverage_columns_are_the_jax_columns(data, table):
    want = {"scintillation_amp_of1x2x2_chan1", "time_diff_of1x2x2_chan1",
            "amp1_ofnxmx2_chan1", "delta_t_ofnxmx2_chan1",
            "shared_ofnxm_constrained_chan1|chan2",
            "shared_ofnxm_nodelay_chan1|chan2",
            "t0_ofnxm_constrained_chan1|chan2",
            "psd_amp_45_65_chan2", "psd_amp_25000_chan2",
            "psd_peaks_10000_50000_freq_2_chan2", "psd_peaks_dc_amp_chan2",
            "phase_10000_50000_phase_1_chan2", "amplitud_rftau_chan1",
            "risetime_tau2_chan2", "energyabsorbed_chan1",
            "baseline_chan1-chan2", "amp_of_scint_chan1"}
    assert want <= set(table)
    for k in want:
        assert table[k].dtype == data["jdf"][k].dtype, k


def test_joint_fits_recover_the_pulses(table):
    np.testing.assert_allclose(table["amp1_ofnxmx2_chan1"], 30e-6, rtol=0.1)
    np.testing.assert_allclose(table["amp2_ofnxmx2_chan1"], 20e-6,
                               rtol=0.15)
    np.testing.assert_allclose(table["delta_t_ofnxmx2_chan1"], 40 / FS,
                               atol=5 / FS)
    np.testing.assert_allclose(table["psd_peaks_10000_50000_freq_1_chan2"],
                               25e3, atol=FS / N + 1)


def test_one_rfft_per_spectral_channel_a_batch(data, monkeypatch):
    calls = []
    rfft = tfft.rfft

    def counted(x):
        calls.append(tuple(x.shape))
        return rfft(x)

    monkeypatch.setattr(tfft, "rfft", counted)
    shell = _shell(data)
    shell.process(batch_size=4, dtype=np.float64)
    # chan1 (of1x2x2, the no-delay fit, the NxM fits, rftau) and chan2
    # (the PSD features, rftau, the NxM fit), over 2 batches
    assert calls == [(4, N), (4, N), (2, N), (2, N)]
    (step,) = shell.group_steps(torch.float64)
    assert len(step.spectral) == 2


def test_ofnxmx2_without_fit_window_is_refused_by_name(data):
    cfg = {"chan1": {"ofnxmx2": {
        "run": True, "template_tag": "both", "template_group_ids": [0, 1],
        "window_min_from_trig_usec": -100.0,
        "window_max_from_trig_usec": 100.0}}}
    cpath = str(data["root"] / "no_fit_window.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.raises(KeyError, match="fit_window"):
        JaxFP(data["raw"], cpath, filter_data=data["fpath"],
              verbose=False).process(batch_size=NB, dtype=np.float64)
    with pytest.raises(ValueError, match='Missing "fit_window" for ofnxmx2 '
                                         'on channel chan1'):
        _shell(data, cpath)


def test_feature_coverage_entry_runs_here(tmp_path):
    shell, index, truth = entry.feature_coverage_entry(
        "cpu", str(tmp_path / "d"), nevents=4)
    assert len(index) == 4 and len(truth["delay"]) == 4
    got = shell.process(batch_size=4, dtype=np.float64)
    cols = [k for k in got if k.endswith(("_chan1", "_chan2", "_chan3",
                                          "_chan4", "|chan2"))]
    # of1x2x2 3, of1x1_nodelay 3, ofnxmx2 4, ofnxm 5, psd_amp 2,
    # psd_peaks 7, phase 2, rftau 4 on each of two channels
    assert len(cols) == 34
    for k in cols:
        assert np.isfinite(got[k]).all(), k
    assert np.all(got["psd_peaks_10000_50000_freq_1_chan2"]
                  == entry.coverage_line_freq())
