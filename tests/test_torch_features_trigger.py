"""The port's FeatureProcessing in trigger-table mode equals the JAX
package's.

The chain of tests/test_trigger_to_feature.py: continuous raw data with
pulses, the JAX TriggerProcessing's trigger table, then windowed feature
extraction around each trigger. The table gets rows of its own beside
the JAX triggers: windows out of the trace on both sides, a row of a dump
that is not in the raw data, and 28 windows in one event (enough for a
coalesced read of the whole event). The JAX FeatureProcessing takes the
DataFrame, ``process(dtype=np.float64, batch_size=8)``; the port takes the
same table as written to a file by the JAX table writer. Same tolerances
as tests/test_torch_features.py.
"""

import os
import threading

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.io import tables as jtables
from detprocess_tpu.io.filterfile import FilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.pipelines.triggers import TriggerProcessing
from detprocess_tpu_torch.io import fastio
from detprocess_tpu_torch.pipelines import features as tfeatures
from detprocess_tpu_torch.pipelines.features import FeatureProcessing

import torch_feature_cases as cases

torch.set_num_threads(1)

FS = 1.25e6
NT = 2048
PRETRIG = 512
L = 100000
N_EXTRA = 28            # windows added in event 1
N_DROPPED = 3           # rows added that must be dropped


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("tchain")
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
    w = RawWriter(str(root / "raw"), "I1_D20260816_T210000", FS,
                  ["chan1", "chan2"],
                  detector_config={"chan1": {"close_loop_norm": 2.0}})
    w.write_dump(traces, dump_num=1)
    raw = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))

    fd = FilterData(verbose=False)
    for chan in ("chan1", "chan2"):
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, psd, FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)

    tpath = str(root / "t.yaml")
    with open(tpath, "w") as f:
        yaml.safe_dump({"trigger": {"chan1": {
            "run": True, "template_tag": "default", "threshold_sigma": 10.0,
            "pileup_window_msec": 0.5}}}, f)
    trig = TriggerProcessing(raw, tpath, filter_data=fpath,
                             verbose=False).process(capacity=128)
    assert len(trig) == 5

    # rows of our own: N_EXTRA windows in event 1, and N_DROPPED rows that
    # must be dropped (out of the trace at either end, unknown dump)
    first = trig.iloc[0]
    extra = []
    for k, ti in enumerate(np.linspace(PRETRIG, L - NT + PRETRIG, N_EXTRA)
                           .astype(int)):
        row = first.copy()
        row["trigger_index"] = ti
        row["event_number"] = 1
        row["trigger_amplitude"] = float(k)
        extra.append(row)
    for ti, dump in ((PRETRIG - 1, 1), (L - NT + PRETRIG + 1, 1),
                     (40000, 99)):
        row = first.copy()
        row["trigger_index"] = ti
        row["dump_number"] = dump
        extra.append(row)
    table = pd.concat([trig, pd.DataFrame(extra)], ignore_index=True)
    table = table.iloc[np.random.default_rng(3).permutation(len(table))]
    table = table.reset_index(drop=True)
    table_path = str(root / "trigger_table.hdf5")
    jtables.write_table(table, table_path)

    cfg = {"feature": {
        "trace_length_samples": NT, "pretrigger_length_samples": PRETRIG,
        "chan1,chan2": {
            "of1x1_nodelay": {"run": True},
            "of1x1_constrained": {"run": True,
                                  "window_min_from_trig_usec": -40.0,
                                  "window_max_from_trig_usec": 40.0},
            "baseline": {"run": True, "window_max_from_trig_usec": -50},
            "maximum": {"run": True}},
        "chan1-chan2": {"integral": {"run": True}},
    }}
    cpath = str(root / "f.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    jdf = JaxFP(raw, cpath, filter_data=fpath, trigger_dataframe=table,
                verbose=False).process(batch_size=8, dtype=np.float64)
    return dict(raw=raw, fpath=fpath, cpath=cpath, table=table,
                table_path=table_path, jdf=jdf)


def _port(chain):
    return FeatureProcessing(chain["raw"], chain["cpath"],
                             filter_data=chain["fpath"],
                             trigger_table=chain["table_path"],
                             verbose=False, device="cpu")


def test_trigger_table_matches_jax(chain):
    shell = _port(chain)
    got = shell.process(batch_size=8, dtype=np.float64)
    assert len(chain["jdf"]) == len(chain["table"]) - N_DROPPED
    assert shell.stats["dropped"] == N_DROPPED
    cases.assert_tables_equal(got, chain["jdf"], "trigger")
    assert shell.get_nb_samples() == NT
    assert shell.get_nb_pretrigger_samples() == PRETRIG


class CountingReader(fastio.FastReader):
    whole = 0

    def read(self, entry, window=None, rows=None, out=None):
        if window is None:
            type(self).whole += 1
        return super().read(entry, window, rows, out)


@pytest.mark.parametrize("batch_size,nreaders", [(8, 1), (32, 1), (32, 3),
                                                 (5, 2)])
def test_coalesced_and_parallel_reads_leave_the_table(chain, monkeypatch,
                                                      batch_size, nreaders):
    """A batch holding more than 25 windows of event 1 reads it whole
    (COALESCE_FRACTION of its 100000 samples); the table stays that of
    the JAX run, whatever the batch size and reader count. The shell's
    ``read_calls`` and ``read_bytes``, counted from each batch's windows
    and whole-event reads, are the ``os.preadv`` calls and their bytes."""
    monkeypatch.setattr(tfeatures, "FastReader", CountingReader)
    CountingReader.whole = 0
    preadv, lock = [0, 0], threading.Lock()
    real = os.preadv

    def counting(*args):
        n = real(*args)
        with lock:
            preadv[0] += 1
            preadv[1] += n
        return n

    monkeypatch.setattr(os, "preadv", counting)
    shell = _port(chain)
    got = shell.process(batch_size=batch_size, dtype=np.float64,
                        nreaders=nreaders)
    assert (CountingReader.whole > 0) == (batch_size >= 32)
    cases.assert_tables_equal(got, chain["jdf"], f"batch {batch_size}")
    assert preadv[0] > 0
    assert [shell.stats["read_calls"], shell.stats["read_bytes"]] == preadv


def test_float32_windows_agree(chain):
    shell = _port(chain)
    got = shell.process(batch_size=8, dtype=np.float32)
    # float-stored raw data upload as float32
    assert shell.stats["upload_bytes"] == 4 * shell.stats["upload_samples"]
    want = chain["jdf"]
    for col in ("amp_of1x1_nodelay_chan1", "amp_of1x1_constrained_chan2"):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-4)
    np.testing.assert_array_equal(got["trigger_index"],
                                  want["trigger_index"])


def test_nevents_caps_the_table_rows(chain):
    shell = _port(chain)
    got = shell.process(nevents=12, batch_size=4, dtype=np.float64)
    jdf = JaxFP(chain["raw"], chain["cpath"], filter_data=chain["fpath"],
                trigger_dataframe=chain["table"], verbose=False).process(
        nevents=12, batch_size=4, dtype=np.float64)
    cases.assert_tables_equal(got, jdf, "nevents")
    assert shell.stats["dropped"] == 12 - len(jdf)
