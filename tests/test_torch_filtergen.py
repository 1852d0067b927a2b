"""The port's filter generation against the JAX package.

- ``pipelines/template.Template``: every branch (2/3/4-pole, the C-without-B
  refusal, sum of two-poles, average pulses, the power template with dPdI
  given or stored, ``fit_templates``, the current template from the fit,
  ``clear``), stored values and metadata equal;
- ``io/filterdata.FilterData``: the accessors (dPdI, IV-sweep, dIdV and
  noise tables, results dicts, ``has``, ``clear_data``, ``set_data``,
  ``describe``), and ``save_hdf5`` read by the JAX ``FilterData`` and the
  JAX file read by the port, equal both ways;
- ``pipelines/filtergen.FilterDataProcessing``: ``process`` on a raw group
  of pytesdaq files written by the JAX ``RawWriter`` (two continuous
  series as int16 codes, glitches for the cuts), with ``lgc_by_series``,
  every stored array and its metadata equal; the average-pulse template
  branch; ``check_config``; the saved file;
- the chain: port filter generation → port ``FeatureProcessing`` gives
  the table of JAX filter generation → JAX ``FeatureProcessing``;
- the dIdV branch (per-series table and the combined fit's results) and
  ``FilterBuilder`` against the JAX classes on the same files.

Float64 on the CPU; values within 1e-9 relative (of the largest |value|
for arrays); the fit's cost, at the rounding level of a noiseless
template, within 1e-20 absolute.
"""

import os

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.pipelines.filtergen import FilterDataProcessing as JaxFDP
from detprocess_tpu.pipelines.template import Template as JaxTemplate
from detprocess_tpu_torch.io.filterdata import FilterData, Table
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.filtergen import FilterDataProcessing
from detprocess_tpu_torch.pipelines.template import FilterBuilder, Template

import torch_feature_cases as cases

torch.set_num_threads(1)

FS = 1.25e6
RTOL = 1e-9
NT, PRE = 2048, 1024
CHANNELS = ["chan1", "chan2"]
SERIES = ["I1_D20260818_T100000", "I1_D20260818_T101000"]


def _assert_value_equal(got, want, what):
    if isinstance(want, pd.Series):
        want = want.to_numpy()
    if isinstance(want, pd.DataFrame):
        assert list(got) == list(want.columns), what
        for col in want.columns:
            w = want[col].to_numpy()
            g = got[col]
            if w.dtype == object:
                assert [np.asarray(v).tolist() if v is not None else None
                        for v in g] == [np.asarray(v).tolist()
                                        if v is not None else None
                                        for v in w], (what, col)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what} {col}")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_value_equal(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, list):                  # array-valued table cells
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            assert (g is None) == (w is None), what
            if w is not None:
                _assert_value_equal(g, w, what)
        return
    w = np.asarray(want)
    g = np.asarray(got)
    assert g.shape == w.shape, what
    if w.dtype.kind in "fc" and w.size:
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=RTOL * np.abs(w).max(), err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def assert_stores_equal(port_store: dict, jax_store: dict):
    """Every parameter of the JAX store (and no other) in the port's, with
    equal values, index axes and metadata."""
    assert set(port_store) == set(jax_store)
    for chan, params in jax_store.items():
        names = {k for k in params if not k.endswith("_metadata")}
        assert set(port_store[chan]) == names, chan
        for name in names:
            value, index, md = port_store[chan][name]
            want = params[name]
            if isinstance(want, pd.Series):
                np.testing.assert_array_equal(index, want.index.to_numpy())
            else:
                assert index is None, (chan, name)
            _assert_value_equal(value, want, f"{chan}/{name}")
            assert md == params[name + "_metadata"], (chan, name)


# -- templates ---------------------------------------------------------------

def _both(fn):
    jt, tt = JaxTemplate(verbose=False), Template(verbose=False)
    fn(jt)
    fn(tt)
    assert_stores_equal(tt.data, jt.data)
    return jt, tt


@pytest.mark.parametrize("poles", [2, 3, 4])
def test_create_template_matches_jax(poles):
    kw = dict(A=1.0, tau_r=20e-6, tau_f1=200e-6, tag=f"p{poles}")
    if poles > 2:
        kw.update(B=0.4, tau_f2=800e-6)
    if poles > 3:
        kw.update(C=0.1, tau_f3=3e-3)
    _both(lambda t: t.create_template(["chan1", "chan2"], FS,
                                      trace_length_msec=1.6384,
                                      pretrigger_length_samples=PRE, **kw))


def test_template_branches_match_jax():
    rng = np.random.default_rng(2)
    events = rng.standard_normal((6, 2, NT)) * 0.05
    dpdi = np.exp(2j * np.pi * rng.uniform(size=NT)) * 3.0

    def build(t):
        t.create_template("chan1", FS, trace_length_samples=NT,
                          pretrigger_length_msec=PRE / FS * 1e3,
                          tau_r=20e-6, tau_f1=200e-6)
        t.create_template_sum_twopoles("chan2", [1.0, 0.3], [20e-6, 30e-6],
                                       [200e-6, 2e-3], FS, NT, PRE,
                                       tag="sum")
        t.calc_average_pulses("chan2", events[:, 0], FS, PRE, tag="avg")
        t.calc_average_pulses(["chan1", "chan2"], events, FS, PRE,
                              tag="avg2")
        t.calc_power_template("chan1", dpdi, FS)
        t.set_dpdi("chan1", dpdi, np.fft.fftfreq(NT, 1 / FS), 2)
    jt, tt = _both(build)
    for kw in ({}, {"dpdi": dpdi}, {"domain": "freq", "use_fit": False}):
        _assert_value_equal(tt.get_template_in_power("chan1", **kw),
                            jt.get_template_in_power("chan1", **kw),
                            str(kw))
    got, gmd = tt.get_template_in_current(["chan1", "chan2"], tag="avg2",
                                          return_metadata=True)
    want, wmd = jt.get_template_in_current(["chan1", "chan2"], tag="avg2",
                                           return_metadata=True)
    _assert_value_equal(got, want, "current")
    assert gmd == wmd
    with pytest.raises(ValueError, match="domain"):
        tt.get_template_in_current("chan1", domain="laplace")
    assert tt.qp_template is tt
    with pytest.raises(ValueError, match="requires B"):
        tt.create_template("chan1", FS, trace_length_samples=NT,
                           pretrigger_length_samples=PRE, tau_r=1e-5,
                           tau_f1=1e-4, C=0.1)
    with pytest.raises(ValueError, match="trace length"):
        tt.create_template("chan1", FS, pretrigger_length_samples=PRE,
                           tau_r=1e-5, tau_f1=1e-4)
    for store in (jt, tt):
        store.clear("chan2", tag="avg")
        store.clear("chan1", clear_filter_data=True, tag="power")
    assert_stores_equal(tt.data, jt.data)
    for store in (jt, tt):
        store.clear()
    assert_stores_equal(tt.data, jt.data)


def test_fit_templates_matches_jax():
    truth = dict(tau_r=25e-6, tau_f=300e-6)

    def build(t):
        t.create_template("chan1", FS, trace_length_samples=NT,
                          pretrigger_length_samples=PRE,
                          tau_r=truth["tau_r"], tau_f1=truth["tau_f"])
    jt, tt = _both(build)
    want = jt.fit_templates("chan1")
    got = tt.fit_templates("chan1")
    for key in ("tau_r", "tau_f", "amplitude"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    np.testing.assert_allclose(got["tau_r"], truth["tau_r"], rtol=1e-9)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=0,
                               atol=1e-20)
    _assert_value_equal(tt.get_template_in_current("chan1"),
                        jt.get_template_in_current("chan1"), "from fit")
    assert tt.get_template_in_current("chan1", return_metadata=True)[1][
        "from_fit"]


# -- filter data -------------------------------------------------------------

def _rich_store(store, table_kind):
    rng = np.random.default_rng(4)
    store.set_template("chan1", rng.standard_normal(64), FS,
                       pretrigger_length_samples=32, tag="t",
                       metadata={"nb_poles": 2, "note": None})
    store.set_template("chan1|chan2", rng.standard_normal((2, 1, 64)), FS,
                       pretrigger_length_samples=32)
    store.set_psd(["chan1", "chan2"], rng.uniform(1, 2, 64), FS)
    store.set_csd(["chan1", "chan2"],
                  rng.standard_normal((2, 2, 64)) * (1 + 1j), FS)
    store.set_dpdi("chan1", rng.standard_normal(64) + 1j, np.arange(64.0), 3,
                   tag="iv")
    sweep = {"tes_bias": np.linspace(1e-6, 5e-6, 4),
             "state": np.array(["sc", "normal", "normal", "sc"],
                               dtype=object),
             "psd": [rng.uniform(size=8), None, rng.uniform(size=6),
                     rng.uniform(size=8)]}
    store.set_ivsweep_data("chan1", table_kind(sweep))
    store.set_ivsweep_results("chan1", {"i0": 1e-6, "r0": 0.1,
                                        "fit": {"a": 1.0, "b": [1, 2]}},
                              "noise")
    store.set_didv_results("chan2", {"params": np.arange(5.0),
                                     "cost": 3.0}, 2)
    store.set_didv_dataframe("chan2", table_kind(
        {"series": np.array(["s1", "s2"], dtype=object),
         "chi2": np.array([1.0, 2.0])}), metadata={"sgfreq": 100.0})
    store.set_noise_dataframe("chan2", table_kind(
        {"n": np.array([1, 2, 3])}))


def test_filter_data_accessors_match_jax(capsys):
    jfd, fd = JaxFilterData(verbose=False), FilterData(verbose=False)
    _rich_store(jfd, pd.DataFrame)
    _rich_store(fd, dict)
    assert_stores_equal(fd.data, jfd.data)
    for got, want in zip(fd.get_dpdi("chan1", 3, "iv", True),
                         jfd.get_dpdi("chan1", 3, "iv", True)):
        _assert_value_equal(got, want, "dpdi")
    assert isinstance(fd.get_ivsweep_data("chan1"), Table)
    _assert_value_equal(fd.get_ivsweep_data("chan1"),
                        jfd.get_ivsweep_data("chan1"), "sweep")
    _assert_value_equal(fd.get_ivsweep_results("chan1", "noise"),
                        jfd.get_ivsweep_results("chan1", "noise"), "iv")
    _assert_value_equal(fd.get_didv_results("chan2", 2),
                        jfd.get_didv_results("chan2", 2), "didv")
    _assert_value_equal(fd.get_didv_dataframe("chan2"),
                        jfd.get_didv_dataframe("chan2"), "didv df")
    _assert_value_equal(fd.get_noise_dataframe("chan2"),
                        jfd.get_noise_dataframe("chan2"), "noise df")
    assert fd.has("chan1", "psd_default") and not fd.has("chan3", "x")
    fd.describe()
    out = capsys.readouterr().out
    assert "SC points=2" in out and "normal points=2" in out
    assert "fs=1.25e+06 Hz" in out
    for store in (jfd, fd):
        store.clear_data(["chan1"], tag="iv")
        store.clear_data("chan2")
    assert_stores_equal(fd.data, jfd.data)
    with pytest.raises(ValueError, match="channels"):
        fd.clear_data(tag="x")
    with pytest.raises(ValueError, match="dictionary"):
        fd.set_data([1])
    with pytest.raises(ValueError, match="not a table"):
        fd.set_noise_dataframe("chan2", [1, 2])
    other = FilterData(verbose=False)
    other.set_psd("chan1", np.ones(8), FS, tag="x")
    other.set_psd("chan9", np.ones(8), FS)
    fd.set_data(other.data)
    assert fd.has("chan1", "psd_x") and fd.has("chan9", "psd_default")
    assert fd.has("chan1", "psd_default")
    fd.clear_data()
    assert fd.channels() == []


def test_filter_file_round_trips_both_ways(tmp_path):
    jfd, fd = JaxFilterData(verbose=False), FilterData(verbose=False)
    _rich_store(jfd, pd.DataFrame)
    _rich_store(fd, dict)
    port_path, jax_path = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    fd.save_hdf5(port_path)
    jfd.save_hdf5(jax_path)
    # the port's file, read by JAX, is the JAX file read by JAX
    from_port = JaxFilterData(verbose=False).load_hdf5(port_path)
    from_jax = JaxFilterData(verbose=False).load_hdf5(jax_path)
    assert set(from_port.data) == set(from_jax.data)
    for chan, params in from_jax.data.items():
        assert set(from_port.data[chan]) == set(params)
        for name, want in params.items():
            _assert_value_equal(from_port.data[chan][name], want,
                                f"{chan}/{name}")
    # the JAX file, read by the port, is the port's store
    back = FilterData(verbose=False).load_hdf5(jax_path)
    for chan, params in fd.data.items():
        for name, (value, index, md) in params.items():
            bval, bidx, bmd = back.data[chan][name]
            if isinstance(value, Table):
                assert isinstance(bval, Table)
            _assert_value_equal(bval, value, f"{chan}/{name}")
            if index is not None:
                np.testing.assert_array_equal(bidx, index)
            assert bmd == {k: v for k, v in md.items() if v is not None}
    mine = FilterData(verbose=False).load_hdf5(port_path)
    assert set(mine.data) == set(back.data)


# -- FilterDataProcessing -----------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Two continuous series of int16 codes (5 events of 150,000 samples
    a dump, two dumps each; in each dump a drifting event, a jumping one
    and events with a glitch every 1000 samples, for the cuts) and event
    files of the feature fixtures."""
    root = tmp_path_factory.mktemp("torch_filtergen")
    rng = np.random.default_rng(12)
    length = 150000
    for sname in SERIES:
        w = RawWriter(str(root / "raw"), sname, FS, CHANNELS, prefix="cont",
                      adc_conversion_factor=2e-10,
                      detector_config={c: {"close_loop_norm": cases.CLN[c]}
                                       for c in CHANNELS})
        for dump in (1, 2):
            x = rng.standard_normal((5, 2, length)) * 1.2e-7
            x[:, 1] += 0.3 * x[:, 0]
            x += np.array([4e-7, -2e-7])[None, :, None]
            x[1, 0] += np.linspace(0.0, 4e-6, length)
            x[3, 1, length // 3:] += 5e-7
            x[2, 1, ::1000] += 1e-6
            x[4, 0, 500::1000] -= 1.5e-6
            w.write_dump(x, dump_num=dump, start_time=10.0 * dump)
    events = cases.write_raw(str(root / "events"), rng)
    return dict(root=root, raw=str(root / "raw"), events=events)


def _config(nrandoms=40):
    lengths = {"trace_length_samples": NT, "pretrigger_length_samples": PRE}
    return {
        "noise": {**lengths, "nrandoms": nrandoms},
        "template": {
            "chan1": {"template_tag_list": ["default", "sum", "avg"],
                      "default": {"template_poles": 2, "amplitude_A": 1.0,
                                  "rise_time": 20e-6, "fall_time_1": 200e-6,
                                  **lengths},
                      "sum": {"template_poles": 2,
                              "amplitude_A": [1.0, 0.5],
                              "rise_time": [20e-6, 40e-6],
                              "fall_time_1": [200e-6, 800e-6], **lengths},
                      "avg": {"from_average_pulses": True, "nevents": 2,
                              **lengths}},
            "chan2": {"run": True, "A": 1.0, "tau_r": 12e-6,
                      "tau_f1": 90e-6, "tag": "default", **lengths},
        },
    }


def _write_cfg(root, cfg, name):
    path = str(root / name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def generated(group):
    cpath = _write_cfg(group["root"], _config(), "fg.yaml")
    jfd = JaxFDP(raw_path=group["raw"], config=cpath, verbose=False).process(
        seed=3, lgc_by_series=True)
    proc = FilterDataProcessing(raw_path=group["raw"], config=cpath,
                                verbose=False, device="cpu")
    fd = proc.process(seed=3, lgc_by_series=True)
    return dict(cpath=cpath, jfd=jfd, fd=fd, proc=proc)


def test_filtergen_process_matches_jax(generated):
    fd, jfd = generated["fd"], generated["jfd"]
    assert_stores_equal(fd.data, jfd.data)
    names = set(fd.data["chan1"])
    assert {"psd_default", "template_default", "template_sum",
            "template_avg"} <= names
    assert {f"psd_{s}" for s in SERIES} <= names
    assert "csd_default" in fd.data["chan1|chan2"]
    stats = generated["proc"].stats
    for chan in CHANNELS:                                  # the cuts cut
        assert stats["kept"][chan] < stats["windows"]
    assert set(stats["offsets"]) == set(CHANNELS)


def test_filtergen_from_files_and_save(group, generated, tmp_path):
    """noise_files as paths (no by-series) and as a RawIndex; the saved
    file reads back equal in the JAX store."""
    files = sorted(os.path.join(group["raw"], f)
                   for f in os.listdir(group["raw"]))
    cfg = _config()
    del cfg["template"]["chan1"]["template_tag_list"][2]
    jfd = JaxFDP(noise_files=files, config=_write_cfg(
        group["root"], cfg, "fg2.yaml"), verbose=False).proces_noise(seed=5)
    from detprocess_tpu_torch.io.rawdata import RawIndex
    for noise in (files, RawIndex.from_pytesdaq(files)):
        proc = FilterDataProcessing(noise_files=noise, config=cfg,
                                    verbose=False, device="cpu")
        fd = proc.proces_noise(seed=5, lgc_save=True,
                               output_path=str(tmp_path), file_name="f.h5")
        assert_stores_equal(fd.data, jfd.data)
    back = JaxFilterData(verbose=False).load_hdf5(str(tmp_path / "f.h5"))
    for chan, params in jfd.data.items():
        for name, want in params.items():
            got = back.data[chan][name]
            if name.endswith("_metadata"):
                assert got == want
            else:
                _assert_value_equal(got, want, f"{chan}/{name}")


def test_check_config_matches_jax(group):
    cases_ = [
        ({"template": {"chan1": {"template_tag_list": ["fast"]}}},
         "template", "tag fast"),
        ({"template": {"chan1": {"template_tag_list": ["fast"],
                                 "fast": {"amplitude_A": 1.0}}}},
         "template", "template_poles"),
        ({"template": {"chan1": {"template_tag_list": ["fast"],
                                 "fast": {"template_poles": 2}}}},
         "template", "missing template parameters"),
        ({"template": {"chan1": {"run": True}}}, "template",
         "no template parameters"),
        ({"noise": {}}, "template", "template generation"),
        ({"noise": {}}, "didv", "no dIdV raw data"),
        ({"noise": {}}, "nonsense", "unknown processing_type"),
    ]
    for i, (cfg, kind, match) in enumerate(cases_):
        cpath = _write_cfg(group["root"], cfg, f"cc{i}.yaml")
        for cls, kw in ((JaxFDP, {}), (FilterDataProcessing,
                                       {"device": "cpu"})):
            proc = cls(raw_path=group["raw"], config=cpath, verbose=False,
                       **kw)
            with pytest.raises(ValueError, match=match):
                proc.check_config(kind)
    cpath = _write_cfg(group["root"], {"noise": {"nrandoms": 4}}, "ok.yaml")
    FilterDataProcessing(raw_path=group["raw"], config=cpath, verbose=False,
                         device="cpu").check_config("noise")
    with pytest.raises(ValueError, match="config not found"):
        FilterDataProcessing(raw_path=group["raw"], verbose=False,
                             device="cpu").check_config("noise")
    with pytest.raises(ValueError, match="no raw files"):
        FilterDataProcessing(raw_path=str(group["root"] / "nothing"),
                             device="cpu")


def _close_tree(got, want, rtol, what):
    """``got`` (the port's value) within ``rtol`` of ``want`` (the JAX
    value): dicts key by key, tables column by column, numbers relative
    to an array's largest |value|, strings exactly."""
    if isinstance(want, pd.Series):
        want = want.to_numpy()
    if isinstance(want, pd.DataFrame):
        assert list(got) == list(want.columns), what
        for col in want.columns:
            _close_tree(got[col], want[col].to_numpy(), rtol, f"{what}.{col}")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], rtol, f"{what}.{k}")
        return
    w, g = np.asarray(want), np.asarray(got)
    if w.dtype.kind in "OUS":
        assert g.astype(str).tolist() == w.astype(str).tolist(), what
        return
    assert g.shape == w.shape, what
    scale = max(float(np.nanmax(np.abs(w))) if w.size else 0.0, 1e-300)
    np.testing.assert_allclose(g.astype(w.dtype), w, rtol=0,
                               atol=rtol * scale, equal_nan=True,
                               err_msg=what)


DIDV_CFG = {"didv": {"chan1": {
    "sgfreq": 100.0, "sgamp": 2e-8, "rshunt": 5e-3, "poles": [2],
    "ivsweep_results": {"i0": 3.16e-6, "r0": 0.1, "rp": 4e-3,
                        "rshunt": 5e-3, "ibias": 97.8e-6}}}}


def _didv_group(tmp_path):
    """A raw group of one continuous series and two dIdV series (6 traces
    of 2 periods of a transition point's response, chan2 at half)."""
    from detprocess_tpu_torch import entry

    raw = tmp_path / "raw"
    rng = np.random.default_rng(0)
    RawWriter(str(raw), "I1_D20260818_T110000", FS, CHANNELS,
              prefix="cont").write_dump(rng.standard_normal((2, 2, 8192)))
    gen = torch.Generator().manual_seed(3)
    point = entry.ivsweep_points(normal=(), transition_r0=(0.1,), sc=())[0]
    for k in range(2):
        x = entry.ivsweep_didv(gen, point["params"], 6, 2, "cpu").numpy()
        RawWriter(str(raw), f"I1_D20260818_T11{k + 1}000", FS, CHANNELS,
                  prefix="didv", data_type="didv",
                  adc_conversion_factor=1e-10).write_dump(
            np.stack([x, 0.5 * x], axis=1))
    return raw


def test_refusals_name_their_roadmap_item(group, tmp_path):
    """The dIdV branch and FilterBuilder, once refused (ROADMAP §1 item
    6), match the JAX classes on the same files: every stored dIdV
    result (fits at 1e-6, their small-signal errors at 1e-5: they come
    from the inverse of the fits' JᵀJ, condition number up to 1e9) and
    the per-series table."""
    raw = _didv_group(tmp_path)
    cpath = _write_cfg(tmp_path, DIDV_CFG, "didv.yaml")
    want = JaxFDP(raw_path=str(raw), config=cpath,
                  verbose=False).proces_didv()
    proc = FilterDataProcessing(raw_path=str(raw), config=DIDV_CFG,
                                verbose=False, device="cpu")
    got = proc.proces_didv()
    names = {k for k in want.data["chan1"] if not k.endswith("_metadata")}
    assert set(got.data["chan1"]) == names
    assert "didv_processing_default" in names
    for name in sorted(names):
        value, _, md = got.data["chan1"][name]
        assert md == want.data["chan1"][name + "_metadata"], name
        rtol = 1e-5 if "smallsignal" in name else 1e-6
        _close_tree(value, want.data["chan1"][name], rtol, name)
    table = got.get_didv_dataframe("chan1")
    assert list(table["series_name"]) == ["I1_D20260818_T111000",
                                          "I1_D20260818_T112000"]
    assert 5 < table["l_2poles_fit"][0] < 15
    # the same branch through process(), and skipped without a didv section
    proc.process(enable_noise=False)
    FilterDataProcessing(raw_path=str(raw), config={"noise": {}},
                         verbose=False, device="cpu").process(
        enable_noise=False)

    # FilterBuilder: one store under Noise, Template and DIDVAnalysis
    from detprocess_tpu.pipelines.template import FilterBuilder as JaxFB

    files = sorted(str(f) for f in raw.glob("didv_*.hdf5"))
    builders = (FilterBuilder(verbose=False, device="cpu"),
                JaxFB(verbose=False))
    for fb in builders:
        assert fb.didv._filter_data is fb.template._filter_data \
            is fb.noise._filter_data
        fb.didv.process_raw_data("chan1", files, 100.0, 2e-8, 5e-3)
        fb.didv.dofit("chan1", poles=2)
        fb.template.create_template("chan1", FS, trace_length_samples=NT,
                                    pretrigger_length_samples=PRE,
                                    tau_r=20e-6, tau_f1=200e-6)
    fbt, fbj = builders
    for name in ("didv_results_2poles_fit_default", "template_default"):
        _close_tree(fbt._filter_data["chan1"][name][0],
                    fbj._filter_data["chan1"][name], 1e-6, name)
    fbt.save_hdf5(str(tmp_path / "fb.hdf5"))
    back = FilterBuilder(verbose=False, device="cpu").load_hdf5(
        str(tmp_path / "fb.hdf5"))
    assert back.didv.has("chan1", "didv_results_2poles_fit_default")
    fbt.clear(clear_template_state=True)
    assert fbt.noise.data == {} and fbt.didv._fits == {}


# -- the chain ---------------------------------------------------------------

FEATURES = {"feature": {
    "trace_length_samples": cases.N, "pretrigger_length_samples":
    cases.PRETRIG,
    "chan1,chan2": {k: cases.COMMON[k] for k in (
        "of1x1_nodelay", "of1x1_unconstrained", "of1x1_constrained",
        "baseline")}}}


def test_chain_matches_jax(group):
    """Filter data generated at the events' length (N = 4096) feeds the
    feature shell; both packages' chains give the same table."""
    cfg = _config(nrandoms=40)
    lengths = {"trace_length_samples": cases.N,
               "pretrigger_length_samples": cases.PRETRIG}
    cfg["noise"].update(lengths)
    cfg["template"]["chan1"] = {"run": True, "A": 1.0, "tau_r": 20e-6,
                                "tau_f1": 200e-6, **lengths}
    cfg["template"]["chan2"].update(lengths)
    cpath = _write_cfg(group["root"], cfg, "chain.yaml")
    fpath = _write_cfg(group["root"], FEATURES, "chain_features.yaml")
    jfd = JaxFDP(raw_path=group["raw"], config=cpath, verbose=False).process(
        seed=1)
    want = JaxFP(group["events"], fpath, filter_data=jfd,
                 verbose=False).process(batch_size=8, dtype=np.float64)
    fd = FilterDataProcessing(raw_path=group["raw"], config=cpath,
                              verbose=False, device="cpu").process(seed=1)
    got = FeatureProcessing(group["events"], fpath, filter_data=fd,
                            verbose=False, device="cpu").process(
        batch_size=8, dtype=np.float64)
    assert len(want) == cases.NEVENTS
    cases.assert_tables_equal(got, want, "chain")


def test_compound_channel_reaches_the_csd_as_in_jax(group):
    """A compound channel passed to ``process`` reaches ``calc_csd``,
    whose reader cannot look it up: both packages raise (ROADMAP §3)."""
    cfg = {"noise": {"trace_length_samples": NT, "nrandoms": 8}}
    cpath = _write_cfg(group["root"], cfg, "compound.yaml")
    for cls, kw in ((JaxFDP, {}), (FilterDataProcessing, {"device": "cpu"})):
        proc = cls(raw_path=group["raw"], config=cpath, verbose=False, **kw)
        with pytest.raises(ValueError, match="not in list"):
            proc.proces_noise(channels=["chan1", "chan1+chan2"], seed=1)
