"""Raw continuous files → the port's TriggerProcessing → the port's
FeatureProcessing in trigger-table mode, against the same chain in the
JAX package (tests/test_torch_features_trigger.py:44-79: two channels of
100,000 samples with coincident pulses, chan1 triggered at 10σ, windows
of 2048 samples around each trigger).

The trigger tables agree as in tests/test_torch_triggers.py (rows and
indices exact, Δχ² and amplitudes at 1e-4: the JAX shell runs in
float32); the feature columns, computed from windows at the same trigger
indices, at tests/torch_feature_cases.py's 1e-9, the columns carried over
from the trigger table at the trigger table's tolerance.
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.pipelines.triggers import TriggerProcessing as JaxTP
from detprocess_tpu_torch import entry
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
from test_torch_triggers import assert_shell_equal

import torch_feature_cases as cases

torch.set_num_threads(1)

FS = 1.25e6
NT = 2048
PRETRIG = 512
L = 100000
TRIGGER_FLOATS = ("trigger_delta_chi2", "trigger_amplitude")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain")
    rng = np.random.default_rng(21)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = np.sqrt(psd[0] * FS)
    positions = [[20000, 50000, 80000], [35000, 70000]]
    traces = rng.standard_normal((2, 2, L)) * sigma
    for ev, poss in enumerate(positions):
        for pos in poss:
            for c in range(2):
                traces[ev, c, pos - PRETRIG:pos - PRETRIG + NT] += (
                    (30e-6 + 5e-6 * c) * tmpl)
    RawWriter(str(root / "raw"), "I1_D20260816_T210000", FS,
              ["chan1", "chan2"],
              detector_config={"chan1": {"close_loop_norm": 2.0}}
              ).write_dump(traces, dump_num=1)
    raw = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    fd = FilterData(verbose=False)
    for chan in ("chan1", "chan2"):
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, psd, FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    tpath = str(root / "t.yaml")
    with open(tpath, "w") as f:
        yaml.safe_dump({"trigger": {
            "chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 10.0, "pileup_window_msec": 0.5},
            "chan2": {"run": True, "template_tag": "default",
                      "threshold_sigma": 10.0, "pileup_window_msec": 0.5},
            "coincident_window_msec": 0.2}}, f)
    cpath = str(root / "f.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump({"feature": {
            "trace_length_samples": NT, "pretrigger_length_samples": PRETRIG,
            "chan1,chan2": {
                "of1x1_nodelay": {"run": True},
                "of1x1_constrained": {"run": True,
                                      "window_min_from_trig_usec": -40.0,
                                      "window_max_from_trig_usec": 40.0},
                "baseline": {"run": True, "window_max_from_trig_usec": -50},
                "maximum": {"run": True}},
            "chan1-chan2": {"integral": {"run": True}}}}, f)
    jtrig = JaxTP(raw, tpath, filter_data=fpath, verbose=False).process(
        capacity=128)
    jfeat = JaxFP(raw, cpath, filter_data=fpath, trigger_dataframe=jtrig,
                  verbose=False).process(batch_size=8, dtype=np.float64)
    return dict(raw=raw, fpath=fpath, tpath=tpath, cpath=cpath,
                jtrig=jtrig, jfeat=jfeat)


@pytest.mark.parametrize("trigger_dtype", [np.float64, np.float32])
def test_chain_matches_jax(chain, trigger_dtype):
    trig = TriggerProcessing(chain["raw"], chain["tpath"],
                             filter_data=chain["fpath"], verbose=False,
                             device="cpu").process(capacity=128,
                                                   dtype=trigger_dtype)
    # 5 coincidences of chan1 and chan2, one row each
    assert len(chain["jtrig"]) == 5
    assert chain["jtrig"]["trigger_index_chan2"].notna().all()
    if trigger_dtype == np.float64:
        assert_shell_equal(trig, chain["jtrig"], "trigger table")
    feats = FeatureProcessing(chain["raw"], chain["cpath"],
                              filter_data=chain["fpath"], trigger_table=trig,
                              verbose=False, device="cpu").process(
        batch_size=8, dtype=np.float64)
    want = chain["jfeat"]
    assert len(want) == 5
    for col in TRIGGER_FLOATS:
        np.testing.assert_allclose(feats.pop(col), want[col], rtol=1e-4,
                                   err_msg=col)
    cases.assert_tables_equal(feats, want.drop(columns=list(TRIGGER_FLOATS)),
                              "chain")


def test_entry_chain_recovers_pulses(tmp_path):
    """``trigger_processing_entry`` at a cut size, its table into the
    feature shell of ``shell_config(4096, 1024)``: every 10σ pulse of
    every channel in its channel's columns, and chan1's large pulses'
    amplitudes and times from the of1x1 fit."""
    length = 400000
    shell, index = entry.trigger_processing_entry(
        "cpu", str(tmp_path), nevents=2, length=length, ncoincident=8,
        nsingles=1)
    table = shell.process(event_batch=2, dtype=np.float32)
    pulses = entry.trigger_shell_pulses(torch.Generator().manual_seed(0), 2,
                                        length, ncoincident=8, nsingles=1)
    res = entry.trigger_shell_resolutions()
    ev = table["event_number"] - 1 + 1 * (table["dump_number"] - 1)
    for c, chan in enumerate(entry.SHELL_CHANNELS):
        at = [pulses["coincident"][:, :, c]]
        if c:
            at.append(pulses["single"][:, c - 1])
        for e, where in enumerate(np.concatenate(at, axis=1)):
            idx = table[f"trigger_index_{chan}"][ev == e]
            amp = table[f"trigger_amplitude_{chan}"][ev == e]
            for t in where:
                k = np.nanargmin(np.abs(idx - t))
                assert abs(idx[k] - t) <= 256, (chan, e, t)
                assert abs(amp[k] - 10 * res[c]) < 5 * res[c], (chan, e, t)
    feats = FeatureProcessing(
        index, entry.shell_config(entry.TRIGGER_NT, entry.TRIGGER_PRETRIG),
        entry.shell_filter_data(entry.TRIGGER_NT, entry.TRIGGER_PRETRIG),
        trigger_table=table, verbose=False, device="cpu").process(
        batch_size=64, dtype=np.float64)
    fev = feats["event_number"] - 1 + (feats["dump_number"] - 1)
    for e in range(2):
        for t, a in zip(list(pulses["big"][e]) + [pulses["sat"][e]],
                        list(pulses["big_amp"][e]) + [entry.TSHELL_SAT_PULSE]):
            rows = np.flatnonzero((fev == e) & (np.abs(
                feats["trigger_index"] - t) <= 2))
            assert len(rows) == 1, (e, t)
            r = rows[0]
            got = feats["amp_of1x1_unconstrained_chan1"][r]
            assert abs(got - a) < 5 * res[0], (e, t, got, a)
            t0 = feats["t0_of1x1_unconstrained_chan1"][r] * entry.FS
            assert abs(t0 - (t - feats["trigger_index"][r])) <= 1
