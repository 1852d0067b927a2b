"""The port's TriggerProcessing, its batched drain and its EventBuilder
against the JAX package's.

Data: the 3-channel coincidence traces of tests/test_trigger_coincidence.py
(3 continuous events of 60,000 samples; pure, mixed pileup-and-
coincidence and single-channel cases) in plain, edge-exclusion and
residual mode, and its NxM case ('chan1|chan2', two templates, beside
'chan3'). The JAX TriggerProcessing and the port's (``device="cpu"``,
float64) read the same HDF5 files.

Tolerances:

- the shell: rows, trigger indices, channels, column order and dtypes,
  and every column but Δχ² and the amplitudes exact; Δχ² and the
  amplitudes at rtol 1e-4. The JAX shell runs in float32 even under x64
  (float-stored traces and int16 codes are converted in float32, its
  kernels' constants are float32, and it packs Δχ² and the amplitudes as
  float32 before the drain), the port in float64; 1e-4 is chip_smoke.py's
  TRIG_RTOL for float32 against float64. The data keep every trigger far
  from the threshold, so that both find the same rows;
- the drain and the EventBuilder, fed identical host inputs: exact
  (``check_exact`` through ``io.tables.to_dataframe``). The drain is held
  to the JAX per-event path: JAX's EventBuilder on the per-event tables of
  ``TriggerProcessing._trigger_set_to_df``, with the residual combine and
  the edge exclusion of ``process()``'s per-event drain.
"""

import glob
import json
import os
from types import SimpleNamespace

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.ops import trigger as jtrig
from detprocess_tpu.pipelines import triggers as jtp
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.ops.saltinject import DeviceInjector, split_injector
from detprocess_tpu_torch.pipelines import salting as ttp_salting
from detprocess_tpu_torch.pipelines import triggers as ttp
from test_trigger_coincidence import CHANNELS, FS, NT, PRE, L, _config, \
    _make_raw

torch.set_num_threads(1)

RTOL = 1e-4
SERIES = "I1_D20260820_T250000"


def assert_shell_equal(got, want, what=""):
    """The port's table against the JAX DataFrame at the shell's
    tolerances."""
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


@pytest.fixture(scope="module")
def coinc(tmp_path_factory):
    root = tmp_path_factory.mktemp("tshell")
    files, fd, _ = _make_raw(root, np.random.default_rng(47))
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    cfgs = {}
    for mode in ("plain", "edge", "residual"):
        d = root / mode
        d.mkdir()
        cfgs[mode] = _config(d, mode)
    return dict(root=root, files=files, fd=fd, fpath=fpath, cfgs=cfgs,
                jax={})


def _jax_run(coinc, mode, **kw):
    key = (mode, tuple(sorted(kw.items())))
    if key not in coinc["jax"]:
        tp = jtp.TriggerProcessing(coinc["files"], coinc["cfgs"][mode],
                                   filter_data=coinc["fd"], verbose=False)
        coinc["jax"][key] = tp.process(capacity=64, event_batch=3, **kw)
    return coinc["jax"][key]


def _port(coinc, mode, **kw):
    return ttp.TriggerProcessing(coinc["files"], coinc["cfgs"][mode],
                                 filter_data=coinc["fpath"],
                                 verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["plain", "edge", "residual"])
def test_shell_matches_jax(coinc, mode):
    want = _jax_run(coinc, mode, coincident_window_msec=0.16)
    shell = _port(coinc, mode)
    got = shell.process(capacity=64, event_batch=2, dtype=np.float64,
                        coincident_window_msec=0.16)
    assert_shell_equal(got, want, mode)
    # cross-channel merges happened: merged rows carry another channel
    c1 = want["trigger_channel"] == "chan1"
    assert want.loc[c1, "trigger_index_chan2"].notna().any()
    assert shell.stats["events"] == 3
    assert shell.stats["upload_samples"] == 3 * 3 * L


def test_shell_float32_and_readers_match_jax(coinc):
    """float32 and two reader threads: the same rows; values at the
    float32 tolerance. The rows of each event stay together whatever
    order the readers deliver the events in."""
    want = _jax_run(coinc, "residual", coincident_window_msec=0.16)
    got = _port(coinc, "residual").process(
        capacity=64, event_batch=1, dtype=np.float32, nreaders=2,
        coincident_window_msec=0.16)
    got = tables.to_dataframe(got).sort_values(
        ["event_number", "trigger_index"], kind="stable")
    assert len(got) == len(want)
    for col in ("trigger_index", "trigger_channel", "trigger_index_chan3"):
        pd.testing.assert_series_equal(got[col].reset_index(drop=True),
                                       want[col], check_exact=True)
    np.testing.assert_allclose(got["trigger_delta_chi2"], want[
        "trigger_delta_chi2"], rtol=RTOL)


def test_window_from_config_and_no_merge(coinc, tmp_path):
    """The coincidence window comes from the config's ``overall`` when
    the call gives none; without any window, nothing merges."""
    cfg = yaml.safe_load(open(coinc["cfgs"]["plain"]))
    cfg["trigger"]["coincident_window_samples"] = 200
    cpath = str(tmp_path / "w.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    want = _jax_run(coinc, "plain", coincident_window_samples=200)
    shell = ttp.TriggerProcessing(coinc["files"], cpath,
                                  filter_data=coinc["fpath"],
                                  verbose=False, device="cpu")
    assert_shell_equal(shell.process(capacity=64, dtype=np.float64), want,
                       "config window")
    want = _jax_run(coinc, "plain")
    got = _port(coinc, "plain").process(capacity=64, dtype=np.float64)
    assert_shell_equal(got, want, "no window")
    assert (want["trigger_channel"] == "chan2").sum() >= 4


def test_nxm_channel_matches_jax(tmp_path):
    """An 'a|b' NxM trigger channel (M = 2, no unsuffixed
    trigger_amplitude) beside a 1x1 one, merged by a window in samples."""
    rng = np.random.default_rng(61)
    tmpl_a = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                                 tau_f1=60e-6)
    tmpl_b = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                                 tau_f1=150e-6)
    traces = rng.standard_normal((2, 3, L)) * 1e-9
    for ev in range(2):
        for p, a in ((9000, 1.8e-9), (30000, 1.6e-9)):
            traces[ev, 0, p - PRE:p - PRE + NT] += a * tmpl_a
            traces[ev, 1, p - PRE:p - PRE + NT] += 0.8 * a * tmpl_a
            q = p + 30
            traces[ev, 2, q - PRE:q - PRE + NT] += 1.5e-9 * tmpl_a
        traces[ev, 2, 45000 - PRE:45000 - PRE + NT] += 1.5e-9 * tmpl_a
    RawWriter(str(tmp_path / "raw"), SERIES, FS, CHANNELS,
              data_type="continuous",
              nb_pretrigger_samples=PRE).write_dump(traces, dump_num=1)
    files = sorted(str(p) for p in (tmp_path / "raw").glob("*.hdf5"))
    fd = JaxFilterData(verbose=False)
    tm = np.stack([np.stack([tmpl_a, tmpl_b]),
                   np.stack([0.8 * tmpl_a, 0.8 * tmpl_b])])
    fd.set_template("chan1|chan2", tm, FS, pretrigger_length_samples=PRE)
    csd = np.zeros((2, 2, NT), complex)
    csd[0, 0] = csd[1, 1] = 1e-9 ** 2 / FS
    fd.set_csd(["chan1", "chan2"], csd, FS)
    fd.set_template("chan3", tmpl_a, FS, pretrigger_length_samples=PRE)
    fd.set_psd("chan3", np.full(NT, 1e-9 ** 2 / FS), FS)
    fpath = str(tmp_path / "filter.h5")
    fd.save_hdf5(fpath)
    chan = {"run": True, "template_tag": "default", "threshold_sigma": 7.0,
            "pileup_window_msec": 0.04}
    cpath = str(tmp_path / "t.yaml")
    yaml.safe_dump({"trigger": {"chan1|chan2": chan, "chan3": chan}},
                   open(cpath, "w"))
    want = jtp.TriggerProcessing(files, cpath, filter_data=fd,
                                 verbose=False).process(
        capacity=64, event_batch=2, coincident_window_samples=200)
    shell = ttp.TriggerProcessing(files, cpath, filter_data=fpath,
                                  verbose=False, device="cpu")
    assert [tc.bank.ntmps for tc in shell.channels] == [2, 1]
    assert shell.channels[0].chan_indices == [0, 1]
    got = shell.process(capacity=64, event_batch=2, dtype=np.float64,
                        coincident_window_samples=200)
    assert_shell_equal(got, want, "NxM")
    assert want["trigger_index_chan3"].notna().any()


def test_dumps_resume_and_summary_match_jax(coinc, tmp_path):
    """Dumps every event, an interrupted run continued with ``resume``,
    and the job summary beside the dumps: the same files, tables and
    summary counts as the JAX shell's."""
    kw = dict(capacity=64, event_batch=1, pipeline_depth=0, lgc_save=True,
              nb_events_per_dump=1, coincident_window_samples=200)
    outs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        if side == "jax":
            tp = jtp.TriggerProcessing(coinc["files"], coinc["cfgs"]["edge"],
                                       filter_data=coinc["fd"],
                                       processing_id="run7", verbose=False)
            run = tp.process
        else:
            tp = _port(coinc, "edge", processing_id="run7")
            run = (lambda **k: tp.process(dtype=np.float64, **k))
        run(nevents=2, output_path=out, series_name="I1_D20260820_T280000",
            **kw)
        run(resume=True, output_path=out, **kw)
        assert tp.get_output_path() == out
        outs[side] = out
    names = {s: sorted(os.path.basename(f) for f in glob.glob(o + "/*"))
             for s, o in outs.items()}
    assert names["port"] == names["jax"]
    assert sum(n.endswith(".hdf5") for n in names["jax"]) == 3
    assert names["jax"][0].startswith("run7_threshtrig_trigger_")
    for name in names["jax"]:
        if name.endswith(".hdf5"):
            got = tables.read_table(os.path.join(outs["port"], name))
            want = pd.DataFrame(tables.read_table(os.path.join(outs["jax"],
                                                               name)))
            assert_shell_equal(got, want, name)
    summary = {s: json.load(open(glob.glob(o + "/*_summary.json")[0]))
               for s, o in outs.items()}
    for key in ("workload", "processing_id", "series_name",
                "continuous_events", "triggers", "livetime_sec", "dumps",
                "channels", "thresholds_sigma", "restricted", "calib",
                "invocations"):
        assert summary["port"][key] == summary["jax"][key], key
    assert summary["port"]["continuous_events"] == 3
    assert summary["port"]["invocations"] == 2


def test_template_info_matches_jax(coinc):
    cfg = yaml.safe_load(open(coinc["cfgs"]["edge"]))["trigger"]
    cfg = {"channels": {k: dict(v, channel_name=k) for k, v in cfg.items()}}
    got = ttp.get_trigger_template_info(
        cfg, FilterData(verbose=False).load_hdf5(coinc["fpath"]))
    assert got == jtp.get_trigger_template_info(cfg, coinc["fd"])
    assert got["chan1"]["nb_pretrigger_samples"] == PRE


def test_refusals_and_device(coinc, tmp_path):
    shell = _port(coinc, "plain")
    host = ttp_salting.Salting(FilterData(verbose=False)).make_injector(
        ["chan1"])
    shell.set_salting(host)                   # both kinds of injector
    assert split_injector(shell._injector) == (host, None)
    device = DeviceInjector(
        {"salt_channel": ["chan1"], "series_number": [1], "event_number": [1],
         "trigger_index": [100], "salt_amplitude": [1.0]},
        lambda chan, tag: (np.ones(4), 1), ["chan1"])
    shell.set_salting(device)
    assert split_injector(shell._injector) == (None, device)
    with pytest.raises(ValueError, match="no trigger channel named"):
        shell.set_dynamic_threshold("chan9", lambda m: 100.0)
    with pytest.raises(NotImplementedError, match="mesh"):
        shell.process(mesh=object())
    with pytest.raises(ValueError, match="nreaders"):
        shell.process(nreaders=2, nevents=1)
    cfg = yaml.safe_load(open(coinc["cfgs"]["plain"]))
    cfg["trigger"]["chan2"]["pileup_window_msec"] = 0.004     # 5 samples
    cpath = str(tmp_path / "small.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    small = ttp.TriggerProcessing(coinc["files"], cpath,
                                  filter_data=coinc["fpath"],
                                  verbose=False, device="cpu")
    assert [tc.pileup_window for tc in small.channels][1] == 5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttp.TriggerProcessing(coinc["files"], coinc["cfgs"]["plain"],
                              filter_data=coinc["fpath"],
                              verbose=False)
    fd = FilterData(verbose=False)
    tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    for c in CHANNELS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=PRE)
        fd.set_psd(c, np.full(NT // 2, 1e-18 / FS), FS)
    with pytest.raises(ValueError, match="not consistent"):
        ttp.TriggerProcessing(coinc["files"], coinc["cfgs"]["plain"],
                              filter_data=fd, verbose=False, device="cpu")


# ---------------------------------------------------------------------------
# the trigger modes: dynamic windows and sub-tile windows
# ---------------------------------------------------------------------------

PAIR_NT, PAIR_PRE, PAIR_L = 1024, 256, 200_000


@pytest.fixture(scope="module")
def pair_data(tmp_path_factory):
    """The data of tests/test_trigger_pipeline.py:278: one channel, two
    40 µA pulses 4000 samples apart, whose above-threshold spans stay
    apart under the static 0.5 ms window and merge under the dynamic
    one."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(9)
    tmpl = pulse.make_template(FS, PAIR_NT, PAIR_PRE, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((1, 1, PAIR_L)) * sigma
    for pos in (60_000, 64_000):
        traces[0, 0, pos - PAIR_PRE:pos - PAIR_PRE + PAIR_NT] += 40e-6 * tmpl
    RawWriter(str(root / "raw"), "I1_D20260816_T300000", FS,
              ["chan1"]).write_dump(traces, dump_num=1)
    fd = JaxFilterData(verbose=False)
    fd.set_psd("chan1", np.full(PAIR_NT, sigma ** 2 / FS), FS)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PAIR_PRE)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    cpath = str(root / "cfg.yaml")
    yaml.safe_dump({"trigger": {"chan1": {
        "run": True, "template_tag": "default", "threshold_sigma": 8.0,
        "pileup_window_msec": 0.5}}}, open(cpath, "w"))
    files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(files=files, fd=fd, fpath=fpath, cpath=cpath)


def _near_pair(table):
    idx = np.asarray(table["trigger_index"])
    return int(((idx > 55_000) & (idx < 65_000)).sum())


def test_dynamic_threshold_shell_matches_jax(pair_data):
    """Static window: two rows at the pair; dynamic window: one; the
    port's tables equal JAX's in both runs."""
    d = pair_data
    runs = {}
    for mode in ("static", "dynamic"):
        jshell = jtp.TriggerProcessing(d["files"], d["cpath"],
                                       filter_data=d["fd"], verbose=False)
        tshell = ttp.TriggerProcessing(d["files"], d["cpath"],
                                       filter_data=d["fpath"],
                                       verbose=False, device="cpu")
        if mode == "dynamic":
            jshell.set_dynamic_threshold(
                "chan1", lambda m: jnp.where(m > 1000.0, 6000.0, 200.0))
            tshell.set_dynamic_threshold(
                "chan1", lambda m: torch.where(m > 1000.0, 6000.0, 200.0))
        want = jshell.process()
        got = tshell.process(dtype=np.float64)
        assert_shell_equal(got, want, mode)
        runs[mode] = got
    assert _near_pair(runs["static"]) == 2
    assert _near_pair(runs["dynamic"]) == 1


def test_dynamic_threshold_set_after_process_takes_effect(pair_data):
    """A step built for the static run is not reused after
    set_dynamic_threshold, nor the first function's after a second."""
    d = pair_data
    shell = ttp.TriggerProcessing(d["files"], d["cpath"],
                                  filter_data=d["fpath"], verbose=False,
                                  device="cpu")
    assert _near_pair(shell.process(dtype=np.float64)) == 2
    shell.set_dynamic_threshold(
        "chan1", lambda m: torch.where(m > 1000.0, 6000.0, 200.0))
    assert _near_pair(shell.process(dtype=np.float64)) == 1
    shell.set_dynamic_threshold("chan1", lambda m: 200.0)
    assert _near_pair(shell.process(dtype=np.float64)) == 2
    assert shell.trigger_steps(dtype=torch.float64)[0].window_fn(0.0) == 200.0


@pytest.mark.parametrize("premerge", [None, 0])
def test_dynamic_residual_shell_matches_jax(coinc, premerge):
    """Dynamic windows on every channel of the coincidence data in
    residual mode (both passes merge with the dynamic window)."""
    jshell = jtp.TriggerProcessing(coinc["files"], coinc["cfgs"]["residual"],
                                   filter_data=coinc["fd"], verbose=False)
    tshell = _port(coinc, "residual")
    for c in CHANNELS:
        jshell.set_dynamic_threshold(
            c, lambda m: jnp.where(m > 60.0, 2500.0, 50.0),
            premerge_window=premerge)
        tshell.set_dynamic_threshold(
            c, lambda m: torch.where(m > 60.0, 2500.0, 50.0),
            premerge_window=premerge)
    want = jshell.process(capacity=64, event_batch=3,
                          coincident_window_msec=0.16)
    got = tshell.process(capacity=64, event_batch=2, dtype=np.float64,
                         coincident_window_msec=0.16)
    assert_shell_equal(got, want, "dynamic residual")
    static = _jax_run(coinc, "residual", coincident_window_msec=0.16)
    assert len(want) < len(static)       # the wider windows merged pulses


def test_subtile_window_shell_matches_jax(coinc, tmp_path):
    """The 5-sample pileup window on chan2 (tiles of 4 samples)."""
    cfg = yaml.safe_load(open(coinc["cfgs"]["residual"]))
    cfg["trigger"]["chan2"]["pileup_window_msec"] = 0.004     # 5 samples
    cpath = str(tmp_path / "small.yaml")
    yaml.safe_dump(cfg, open(cpath, "w"))
    want = jtp.TriggerProcessing(coinc["files"], cpath,
                                 filter_data=coinc["fd"],
                                 verbose=False).process(
        capacity=64, event_batch=3, coincident_window_msec=0.16)
    shell = ttp.TriggerProcessing(coinc["files"], cpath,
                                  filter_data=coinc["fpath"],
                                  verbose=False, device="cpu")
    assert shell.channels[1].pileup_window == 5
    got = shell.process(capacity=64, event_batch=2, dtype=np.float64,
                        coincident_window_msec=0.16)
    assert_shell_equal(got, want, "5-sample window")


def test_candidate_capacity_warning_matches_jax(coinc, capsys):
    """Sample-level units past a candidate capacity of 8: the drain's
    warning, word for word as JAX's."""
    lines = []
    for make, fn in (
            (lambda: jtp.TriggerProcessing(
                coinc["files"], coinc["cfgs"]["plain"],
                filter_data=coinc["fd"], verbose=False),
             lambda m: jnp.where(m > 110.0, 400.0, 50.0)),
            (lambda: _port(coinc, "plain"),
             lambda m: torch.where(m > 110.0, 400.0, 50.0))):
        shell = make()
        shell.set_dynamic_threshold("chan1", fn, candidate_capacity=8,
                                    premerge_window=0)
        capsys.readouterr()
        shell.process(capacity=64, event_batch=3)
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if "candidate capacity exceeded" in ln])
    assert lines[0] and lines[1] == lines[0]
    assert "set_dynamic_threshold(candidate_capacity=...)" in lines[1][0]


# ---------------------------------------------------------------------------
# exact: the drain against the JAX per-event path
# ---------------------------------------------------------------------------

def _channels(edge, ms):
    return [SimpleNamespace(name=f"chan{i + 1}", threshold_sigma=5.0 + i,
                            pileup_window=50 + i,
                            edge_exclusion_msec=(3.0 if edge and i != 1
                                                 else None),
                            dynamic_candidate_capacity=4096, m=m)
            for i, m in enumerate(ms)]


def _host_set(rng, nev, cap, m, length, bases, tie):
    """A batched host trigger set [E, cap] as the packed device buffers
    give it (int32 indices, float32 Δχ² and amplitudes): each event holds
    some of ``bases`` (coincidence partners, offset by up to ±150 samples,
    ``tie`` of them exactly on the base) and a few triggers of its own."""
    idx = np.full((nev, cap), -1, np.int32)
    dchi2 = np.zeros((nev, cap), np.float32)
    amps = np.zeros((nev, m, cap), np.float32)
    count = np.zeros(nev, np.int32)
    for e in range(nev):
        pick = bases[e][rng.random(len(bases[e])) < 0.7]
        off = rng.integers(-150, 151, len(pick))
        off[:tie] = 0
        own = rng.integers(1000, length - 1000, rng.integers(0, 4))
        got = np.unique(np.concatenate([pick + off, own]))[:cap]
        k = len(got)
        idx[e, :k] = got
        dchi2[e, :k] = rng.uniform(30.0, 900.0, k)
        amps[e, :, :k] = rng.normal(0.0, 1e-6, (m, k))
        count[e] = k
    total = count + (rng.random(nev) < 0.2)     # a truncation now and then
    return jtrig.TriggerSet(idx, dchi2, amps, count, total.astype(np.int32))


def _residual_set(rng, first, length):
    """A residual-pass set: some of the first pass's indices again (the
    combine drops them) and some new ones."""
    nev, cap = first.indices.shape
    idx = np.full((nev, cap), -1, np.int32)
    dchi2 = np.zeros((nev, cap), np.float32)
    amps = np.zeros((nev,) + first.amplitudes.shape[1:], np.float32)
    count = np.zeros(nev, np.int32)
    for e in range(nev):
        old = first.indices[e, :int(first.count[e])]
        again = old[rng.random(len(old)) < 0.3]
        new = rng.integers(1000, length - 1000, rng.integers(0, 3))
        got = np.concatenate([again, new])[:cap]
        k = len(got)
        idx[e, :k] = got
        dchi2[e, :k] = rng.uniform(30.0, 900.0, k)
        amps[e, :, :k] = rng.normal(0.0, 1e-6, (amps.shape[1], k))
        count[e] = k
    return jtrig.TriggerSet(idx, dchi2, amps, count, count.copy())


def _admins(rng, nev, first_event, length):
    """Admin dicts of continuous events: event times that overlap now and
    then (the chain takes the later), stamps on some events only."""
    out = []
    for e in range(nev):
        num = first_event + e
        a = {"series_number": 100203004050, "event_number": num,
             "dump_number": 1 + num // 4, "group_name": "g",
             "data_type": "continuous",
             "event_time": 1000.0 + num * length / FS
             - (0.01 if num % 3 == 2 else 0.0)}
        if num % 2:
            a["series_start_time"] = 900
            a["fridge_run_number"] = 12
        out.append(a)
    return out


def _jax_per_event(channels, batches, length, window_kw, processing_id):
    """JAX's per-event drain: per event, each channel's residual combine,
    its ``_trigger_set_to_df`` table and edge exclusion into JAX's
    EventBuilder, then ``build_event``."""
    fake = SimpleNamespace(_fs=FS)
    fake._trigger_set_arrays = (
        lambda tc, ts: jtp.TriggerProcessing._trigger_set_arrays(
            fake, tc, ts))
    builder = jtp.EventBuilder()
    frames, livetime = [], 0.0
    max_edge = max(tc.edge_exclusion_msec or 0.0 for tc in channels)
    for sets, admins in batches:
        for e, admin in enumerate(admins):
            livetime += max(length / FS - 2 * max_edge * 1e-3, 0.0)
            builder.clear_event()
            builder.set_current_nb_samples(length)
            for tc in channels:
                ts_b, ts2_b = sets[tc.name]
                ts = jtrig.TriggerSet(*(f[e] for f in ts_b[:5]))
                if ts2_b is not None:
                    ts = jtrig.combine_trigger_sets(
                        ts, jtrig.TriggerSet(*(f[e] for f in ts2_b[:5])))
                df = jtp.TriggerProcessing._trigger_set_to_df(fake, tc, ts)
                if tc.edge_exclusion_msec is not None and len(df):
                    tmin = tc.edge_exclusion_msec * 1e-3
                    tmax = length / FS - tmin
                    keep = ((df["trigger_time"] > tmin)
                            & (df["trigger_time"] < tmax))
                    df = df[keep].reset_index(drop=True)
                    df[f"trigger_edge_exclusion_time_{tc.name}"] = tmin
                    df[f"trigger_livetime_{tc.name}"] = livetime
                builder.add_triggers(df)
            meta = dict(admin, sample_rate=FS,
                        processing_id=processing_id or "")
            out = builder.build_event(event_metadata=meta, fs=FS,
                                      nb_trigger_channels=len(channels),
                                      **window_kw)
            if out is not None and len(out):
                frames.append(out.copy())
    return pd.concat(frames, ignore_index=True)


@pytest.mark.parametrize("seed,edge,residual,ms,window_kw", [
    (1, False, False, (1, 1, 1), {"coincident_window_samples": 200}),
    (2, True, False, (1, 1, 1), {"coincident_window_msec": 0.16}),
    (3, False, True, (1, 1, 1), {"coincident_window_samples": 120.5}),
    (4, True, True, (2, 1, 1), {"coincident_window_samples": 200}),
    (5, False, False, (1, 1, 1), {}),
])
def test_drain_equals_jax_per_event_path(seed, edge, residual, ms,
                                         window_kw):
    rng = np.random.default_rng(seed)
    length, cap = 60000, 24
    channels = _channels(edge, ms)
    batches = []
    for first_event, nev in ((1, 3), (4, 2)):
        bases = [np.sort(rng.choice(np.arange(2000, length - 2000, 400), 8,
                                    replace=False)) for _ in range(nev)]
        sets = {}
        for i, tc in enumerate(channels):
            ts = _host_set(rng, nev, cap, tc.m, length, bases, tie=i % 2 + 1)
            ts2 = (_residual_set(rng, ts, length)
                   if residual and i == 0 else None)
            sets[tc.name] = (ts, ts2)
        batches.append((sets, _admins(rng, nev, first_event, length)))
    want = _jax_per_event(channels, batches, length, window_kw, "p1")

    window = 0
    if "coincident_window_msec" in window_kw:
        window = int(window_kw["coincident_window_msec"] * FS / 1000)
    elif "coincident_window_samples" in window_kw:
        window = window_kw["coincident_window_samples"]
    state = ttp.DrainState()
    parts = []
    for sets, admins in batches:
        port_sets = {k: tuple(None if t is None else t[:5] for t in pair)
                     for k, pair in sets.items()}
        part = ttp.drain_batch(channels, port_sets, admins, length, FS,
                               state, window, "p1")
        if part is not None:
            parts.append(part)
    got = tables.to_dataframe(tables.concat_tables(parts))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if window_kw:
        merged = want["trigger_channel"] != want["trigger_channel_chan1"]
        assert (merged & (want["trigger_channel"] == "chan1")).any() or (
            want["trigger_index_chan1"].notna()
            & (want["trigger_channel"] != "chan1")).any()
    assert state.trigger_id == len(want)


# ---------------------------------------------------------------------------
# exact: the EventBuilder against JAX's
# ---------------------------------------------------------------------------

def _both_builders(frames, meta, **kw):
    """Each frame into a JAX and a port builder, then build_event on
    both; returns (port table as a DataFrame, JAX DataFrame)."""
    jb, tb = jtp.EventBuilder(), ttp.EventBuilder()
    for b in (jb, tb):
        for f in frames:
            b.add_triggers(f)
        b.set_current_nb_samples(L)
    want = jb.build_event(dict(meta), fs=FS, **kw)
    got = tb.build_event(dict(meta), fs=FS, **kw)
    return tables.to_dataframe(got), want


def test_builder_pileup_not_merged():
    df = pd.DataFrame({
        "trigger_index": [1000, 1050],
        "trigger_time": [1000 / FS, 1050 / FS],
        "trigger_delta_chi2": [500.0, 400.0],
        "trigger_channel": ["chan1", "chan1"],
        "trigger_amplitude_chan1": [1e-6, 2e-6]})
    got, want = _both_builders([df], {"event_time": 0.0},
                               coincident_window_samples=100)
    assert len(want) == 2
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_builder_mixed_split():
    df = pd.DataFrame({
        "trigger_index": [1000, 1020, 1040, 1060],
        "trigger_time": np.array([1000, 1020, 1040, 1060]) / FS,
        "trigger_delta_chi2": [500.0, 400.0, 600.0, 100.0],
        "trigger_channel": ["chan1", "chan2", "chan1", "chan2"],
        "trigger_amplitude_chan1": [1e-6, np.nan, 3e-6, np.nan],
        "trigger_amplitude_chan2": [np.nan, 2e-6, np.nan, 4e-6]})
    got, want = _both_builders([df], {"event_time": 0.0},
                               coincident_window_samples=100)
    assert list(want["trigger_index"]) == [1000, 1040]
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_builder_rebuild_overwrites_columns():
    """Admin columns that arrive with the triggers, and a second
    build_event, overwrite in place; trigger_prod_id runs on."""
    df = pd.DataFrame({
        "trigger_index": [1000], "trigger_time": [1000 / FS],
        "trigger_delta_chi2": [500.0], "trigger_channel": ["chan1"],
        "trigger_amplitude_chan1": [1e-6], "event_number": [77]})
    meta = {"event_time": 0.0, "event_number": 5, "series_number": 9}
    jb, tb = jtp.EventBuilder(), ttp.EventBuilder()
    for b in (jb, tb):
        b.add_triggers(df)
        b.set_current_nb_samples(L)
    for _ in range(2):
        want = jb.build_event(dict(meta), fs=FS)
        got = tables.to_dataframe(tb.build_event(dict(meta), fs=FS))
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert int(want["event_number"].iloc[0]) == 5
    assert int(want["trigger_prod_id"].iloc[0]) == 2


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_builder_randomized_patterns(seed):
    """Random coincidence patterns (chains, triples, near-window gaps,
    ties), per-channel tables from JAX's ``_trigger_set_to_df``, event
    after event: every event's table equal, the event-time chain and
    trigger_prod_id included."""
    rng = np.random.default_rng(seed)
    fake = SimpleNamespace(_fs=FS)
    fake._trigger_set_arrays = (
        lambda tc, ts: jtp.TriggerProcessing._trigger_set_arrays(
            fake, tc, ts))
    channels = _channels(False, (1, 2, 1))
    jb, tb = jtp.EventBuilder(), ttp.EventBuilder()
    for ev in range(4):
        bases = [np.sort(rng.choice(np.arange(2000, L - 2000, 300), 10,
                                    replace=False))]
        for b in (jb, tb):
            b.clear_event()
            b.set_current_nb_samples(L)
        for i, tc in enumerate(channels):
            ts = _host_set(rng, 1, 32, tc.m, L, bases, tie=1)
            df = jtp.TriggerProcessing._trigger_set_to_df(
                fake, tc, jtrig.TriggerSet(*(f[0] for f in ts[:5])))
            for b in (jb, tb):
                b.add_trigger_data(tc.name, df)
        meta = {"event_time": 5.0 + ev * 0.03, "series_number": 3,
                "event_number": ev + 1, "sample_rate": FS,
                "group_start_time": 2}
        want = jb.build_event(dict(meta), coincident_window_msec=0.12,
                              nb_trigger_channels=3)
        got = tables.to_dataframe(tb.build_event(
            dict(meta), coincident_window_msec=0.12, nb_trigger_channels=3))
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    with pytest.raises(ValueError, match="already added"):
        tb.add_trigger_data("chan1", df)
