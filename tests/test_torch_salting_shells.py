"""Salted runs of the port's TriggerProcessing and FeatureProcessing
against the JAX package's, and the feature shell's ``resume``.

Data: one dump of 3 continuous events of 2 channels × 2^17 samples (int16
codes, written by the JAX RawWriter; chan2's close_loop_norm 2), white
noise, no pulses of its own; salts made by the JAX Salting (2 an event on
both channels, about 50 resolutions each), templates of Nt = 1024
(pretrigger 256), and for the full-trace feature runs a template and PSD
of 2^17 samples. The port runs on the CPU in float64 with its host and
its device injector; the JAX shells run with their host injector.

Tolerances:

- the trigger shell: as tests/test_torch_triggers.py, rows, indices and
  every column but Δχ² and the amplitudes exactly, those at rtol 1e-4
  (the JAX shell filters and packs in float32);
- the feature shell in full-trace and trigger-table mode, with all
  channels and with a channel subset (chan2 only): tests/torch_feature_cases
  .assert_tables_equal at 1e-9; a float32 run with the device injector
  (int16 upload) at rtol 1e-4 on the amplitudes;
- ``resume`` after a cut run: the dumps hold the uncut run's table, the
  float columns within 1e-12 relative (the batches differ in size).
"""

import glob
import os

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.pipelines.salting import Salting as JaxSalting
from detprocess_tpu.pipelines.triggers import TriggerProcessing as JaxTP
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.salting import Salting
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing

import torch_feature_cases as cases

torch.set_num_threads(1)

FS = 1.25e6
L = 2 ** 17
NT = 1024
PRE = 256
CHANNELS = ["chan1", "chan2"]
NEV = 3
SIGMA = 2e-7                  # white noise, A
CAL = 2.0 ** -28
SERIES = "I1_D20260903_T100000"
RTOL = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("saltshells")
    rng = np.random.default_rng(11)
    w = RawWriter(str(root / "raw"), SERIES, FS, CHANNELS,
                  data_type="continuous", adc_conversion_factor=CAL,
                  detector_config={"chan1": {"close_loop_norm": 1.0},
                                   "chan2": {"close_loop_norm": 2.0}})
    w.write_dump(rng.standard_normal((NEV, 2, L)) * SIGMA, dump_num=1)
    files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    fd = JaxFilterData(verbose=False)
    for i, chan in enumerate(CHANNELS):
        fd.set_template(chan, pulse.make_template(
            FS, NT, PRE, A=1.0, tau_r=20e-6, tau_f1=(80e-6, 120e-6)[i]),
            FS, pretrigger_length_samples=PRE)
        fd.set_psd(chan, np.full(NT, SIGMA ** 2 / FS), FS)
        fd.set_template(chan, pulse.make_template(
            FS, L, L // 2, A=1.0, tau_r=20e-6, tau_f1=100e-6), FS,
            pretrigger_length_samples=L // 2, tag="full")
        fd.set_psd(chan, np.full(L, SIGMA ** 2 / FS), FS, tag="full")
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    jsalt = JaxSalting(fd, verbose=False)
    salts = jsalt.generate_salt(files, CHANNELS, energies=[2e3], nsalt=6,
                                energy_norm_ev_per_amp=1e9, seed=3,
                                min_separation_msec=12.0,
                                edge_exclusion_msec=4.0)
    tpath = str(root / "trigger.yaml")
    with open(tpath, "w") as f:
        yaml.safe_dump({"trigger": {c: {
            "run": True, "template_tag": "default", "threshold_sigma": 10.0,
            "pileup_window_msec": 0.5} for c in CHANNELS}}, f)
    jtp = JaxTP(files, tpath, filter_data=fd, verbose=False)
    jtp.set_salting(jsalt.make_injector(CHANNELS))
    jtrig = jtp.process(capacity=64, event_batch=NEV)
    return dict(root=root, files=files, fd=fd, fpath=fpath, salts=salts,
                jsalt=jsalt, tpath=tpath, jtrig=jtrig, jax={})


def _port_salting(data):
    s = Salting(data["fpath"], verbose=False)
    s.set_dataframe(data["salts"])          # the DataFrame adapter
    return s


def _injector(data, kind):
    s = _port_salting(data)
    return (s.make_device_injector(CHANNELS) if kind == "device"
            else s.make_injector(CHANNELS))


def assert_shell_equal(got, want, what=""):
    got = tables.to_dataframe(got)
    assert list(got.columns) == list(want.columns), what
    assert len(got) == len(want) > 0, what
    for col in want.columns:
        g, w = got[col], want[col]
        assert g.dtype == w.dtype, (what, col, g.dtype, w.dtype)
        if "delta_chi2" in col or "amplitude" in col:
            np.testing.assert_allclose(g.to_numpy(float), w.to_numpy(float),
                                       rtol=RTOL, err_msg=f"{what} {col}")
        else:
            pd.testing.assert_series_equal(g, w, check_exact=True,
                                           obj=f"{what} {col}")


def _tshell(data, kind=None):
    shell = TriggerProcessing(data["files"], data["tpath"],
                              filter_data=data["fpath"], verbose=False,
                              device="cpu")
    if kind is not None:
        shell.set_salting(_injector(data, kind))
    return shell


@pytest.mark.parametrize("kind", ["device", "host"])
def test_salted_trigger_shell_matches_jax(data, kind):
    shell = _tshell(data, kind)
    got = shell.process(capacity=64, event_batch=2, dtype=np.float64)
    assert_shell_equal(got, data["jtrig"], kind)
    st = shell.stats
    assert st["upload_samples"] == NEV * 2 * L
    # int16 codes with the device injector; float64 after the host one
    assert st["upload_bytes"] == (2 if kind == "device" else 8) * \
        st["upload_samples"]
    found = np.asarray(got["trigger_index"])
    for ti in data["salts"]["trigger_index"]:
        assert np.min(np.abs(found - ti)) <= 2
    plain = _tshell(data).process(capacity=64, event_batch=2,
                                  dtype=np.float64)
    assert len(plain.get("trigger_index", ())) < len(found)


FEATURES = {"of1x1_nodelay": {"run": True}, "integral": {"run": True},
            "maximum": {"run": True}}


def _feature_config(mode, subset):
    chans = "chan2" if subset else ",".join(CHANNELS)
    if mode == "full":
        spec = dict(FEATURES, of1x1_nodelay={
            "run": True, "template_tag": "full", "psd_tag": "full"})
        geom = {"trace_length_samples": L,
                "pretrigger_length_samples": L // 2}
    else:
        spec, geom = FEATURES, {"trace_length_samples": NT,
                                "pretrigger_length_samples": PRE}
    return {"feature": {**geom, chans: spec}}


def _jax_features(data, mode, subset):
    key = (mode, subset)
    if key not in data["jax"]:
        cpath = str(data["root"] / f"f_{mode}_{subset}.yaml")
        with open(cpath, "w") as f:
            yaml.safe_dump(_feature_config(mode, subset), f)
        fp = JaxFP(data["files"], cpath, filter_data=data["fpath"],
                   trigger_dataframe=(data["jtrig"] if mode == "trigger"
                                      else None), verbose=False)
        fp.set_salting(data["jsalt"].make_injector(CHANNELS))
        data["jax"][key] = fp.process(batch_size=2, dtype=np.float64)
    return data["jax"][key]


def _fshell(data, mode, subset=False, kind=None):
    shell = FeatureProcessing(
        data["files"], _feature_config(mode, subset),
        filter_data=data["fpath"],
        trigger_table=data["jtrig"] if mode == "trigger" else None,
        verbose=False, device="cpu")
    if kind is not None:
        shell.set_salting(_injector(data, kind))
    return shell


@pytest.mark.parametrize("mode,kind,subset", [
    (m, k, s) for m in ("full", "trigger") for k in ("device", "host")
    for s in (False, True)])
def test_salted_feature_shell_matches_jax(data, mode, kind, subset):
    shell = _fshell(data, mode, subset, kind)
    got = shell.process(batch_size=2, dtype=np.float64)
    want = _jax_features(data, mode, subset)
    cases.assert_tables_equal(got, want, f"{mode} {kind} {subset}")
    assert shell.plan.read_channels == (["chan2"] if subset else None)
    if mode == "trigger":
        # every window holds chan2's salt: its amplitude comes back
        np.testing.assert_allclose(got["amp_of1x1_nodelay_chan2"],
                                   data["salts"]["salt_amplitude"][1],
                                   rtol=0.05)


def test_salted_feature_shell_float32_keeps_the_int16_upload(data):
    shell = _fshell(data, "trigger", kind="device")
    got = shell.process(batch_size=4, dtype=np.float32)
    assert shell.stats["upload_bytes"] == 2 * shell.stats["upload_samples"]
    want = _jax_features(data, "trigger", False)
    for chan in CHANNELS:
        col = f"amp_of1x1_nodelay_{chan}"
        np.testing.assert_allclose(got[col], want[col], rtol=RTOL)
    host = _fshell(data, "trigger", kind="host")
    host.process(batch_size=4, dtype=np.float32)
    assert host.stats["upload_bytes"] == 4 * host.stats["upload_samples"]


def _dumps(path):
    files = sorted(glob.glob(os.path.join(path, "*_F*.hdf5")))
    assert files
    return tables.concat_tables([tables.read_table(f) for f in files])


def _assert_same_table(got, want):
    """The same columns and rows; float columns within 1e-12 relative (a
    batch of another size sums its FFTs in another order), the rest
    exactly."""
    assert sorted(got) == sorted(want)
    for col in want:
        g, w = np.asarray(got[col]), np.asarray(want[col])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=col)
        else:
            np.testing.assert_array_equal(g, w, err_msg=col)


@pytest.mark.parametrize("mode,ncut", [("full", 1), ("trigger", 3)])
def test_feature_resume_gives_the_uncut_table(data, tmp_path, mode, ncut):
    """A run cut after ``ncut`` rows, then resumed: its dumps hold the
    uncut run's table, in one series, and the resumed call returns the
    rest."""
    kw = dict(batch_size=2, dtype=np.float64, lgc_save=True,
              nb_events_per_dump=2, series_name="I1_D20260903_T110000")
    whole = _fshell(data, mode, kind="device").process(
        output_path=str(tmp_path / "whole"), **kw)
    cut = str(tmp_path / "cut")
    _fshell(data, mode, kind="device").process(nevents=ncut,
                                               output_path=cut, **kw)
    kw["series_name"] = "I1_D20260903_T120000"      # ignored on resume
    rest = _fshell(data, mode, kind="device").process(output_path=cut,
                                                      resume=True, **kw)
    nrow = len(whole["event_number"])
    assert nrow > ncut and len(rest["event_number"]) == nrow - ncut
    _assert_same_table(_dumps(cut), _dumps(str(tmp_path / "whole")))
    _assert_same_table(rest, {k: v[ncut:] for k, v in whole.items()})
    names = sorted(os.listdir(cut))
    assert all("I1_D20260903_T110000" in n for n in names
               if n.endswith(".hdf5"))
    # nothing left: a further resume processes no rows
    assert _fshell(data, mode).process(output_path=cut, resume=True,
                                       **kw) == {}


def test_salted_trigger_resume_gives_the_uncut_table(data, tmp_path):
    kw = dict(capacity=64, event_batch=1, dtype=np.float64, lgc_save=True,
              nb_events_per_dump=1, series_name="I1_D20260903_T130000")
    _tshell(data, "device").process(output_path=str(tmp_path / "whole"),
                                    **kw)
    cut = str(tmp_path / "cut")
    _tshell(data, "device").process(nevents=1, output_path=cut, **kw)
    _tshell(data, "device").process(output_path=cut, resume=True, **kw)
    whole = _dumps(str(tmp_path / "whole"))
    resumed = _dumps(cut)
    assert len(whole["trigger_index"]) >= 2 * NEV
    for col in whole:
        if col == "trigger_prod_id":
            continue    # each call numbers its triggers from 1, as in JAX
        np.testing.assert_array_equal(resumed[col], whole[col], err_msg=col)


@pytest.mark.parametrize("what,error,match", [
    ("feature mesh", NotImplementedError, "item 7"),
    ("trigger mesh", NotImplementedError, "item 7"),
    ("trigger dynamic unknown channel", ValueError,
     "no trigger channel named"),
    ("feature readers with resume", ValueError, "without resume"),
])
def test_refusals_name_their_roadmap_item(data, tmp_path, what, error,
                                          match):
    call = {
        "feature mesh": lambda: _fshell(data, "full").process(
            mesh=object()),
        "trigger mesh": lambda: _tshell(data).process(mesh=object()),
        "trigger dynamic unknown channel": lambda: _tshell(
            data).set_dynamic_threshold("chan9", lambda m: 100.0),
        "feature readers with resume": lambda: _fshell(data, "full").process(
            nreaders=2, resume=True, lgc_save=True,
            output_path=str(tmp_path)),
    }[what]
    with pytest.raises(error, match=match):
        call()
