"""The feature shell's host copies held to their JAX originals.

- utils: ``extract_window_indices``, ``split_channel_name``,
  ``channel_combination_weights``, ``unique_list``, ``StageTimer``;
- config: ``normalize_config`` of the reference example config
  (tests/test_config_reference_example.py's ``CONFIG``) written to YAML,
  against ``YamlConfig.get_config()``, and the duplicate-key refusal;
- filter data: the port's ``FilterData.load_hdf5`` against the JAX store
  (templates, folded PSDs, CSDs, metadata);
- raw data: the pread index and reader against the JAX ``RawReader`` on
  RawWriter files and on the independent fixture
  tests/fixtures/raw_fixture (sequential, random-access, windowed,
  channel-subset and stored-dtype reads, admin dicts), the refusal of a
  chunked dataset, and the flat dump layout;
- prefetch: the three prefetchers' ordering against the JAX ones;
- tables: the vaex-layout writer and reader against the JAX ones;
- the raw fixture through the shell: int16 codes uploaded and converted
  (float32) against host-converted float64, and float64 against the JAX
  FeatureProcessing.
"""

import os
import threading
import time

import h5py
import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.config.yamlconfig import YamlConfig
from detprocess_tpu.io import prefetch as jprefetch
from detprocess_tpu.io import tables as jtables
from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawReader as JaxRawReader
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.utils import channels as jchannels
from detprocess_tpu.utils import misc as jmisc
from detprocess_tpu.utils import windows as jwindows
from detprocess_tpu_torch.config import yamlconfig
from detprocess_tpu_torch.io import prefetch, tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex, RawReader
from detprocess_tpu_torch.io.rawdata import write_flat_dump
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.utils import channels, misc, windows
from detprocess_tpu_torch.utils.logging import StageTimer

import torch_feature_cases as cases
from test_config_reference_example import CHANS as REF_CHANS
from test_config_reference_example import CONFIG as REF_CONFIG

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "raw_fixture")
FIX_CHANNELS = ["Melange1pc1ch", "Melange4pc1ch"]


# -- utils ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"window_min_from_start_usec": 100},
    {"window_min_to_end_usec": 300, "window_max_to_end_usec": 10},
    {"window_min_from_trig_usec": -200, "window_max_from_trig_usec": 400},
    {"window_max_from_trig_usec": -200}, {"window_max_from_start_usec": 1e6},
    {"window_min_from_trig_usec": 500, "window_max_from_trig_usec": -500},
])
def test_window_indices(kw):
    args = (4096, 2048, 1.25e6)
    try:
        want = jwindows.extract_window_indices(*args, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="max index smaller"):
            windows.extract_window_indices(*args, **kw)
        return
    assert windows.extract_window_indices(*args, **kw) == want


@pytest.mark.parametrize("name,available,sep", [
    ("chan1", ["chan1", "chan2"], None),
    ("chan1+chan2", ["chan1", "chan2"], None),
    ("chan1-chan2", ["chan1", "chan2"], None),
    ("chan1|chan2", ["chan1", "chan2"], None),
    ("chan1,chan2", ["chan1", "chan2"], ","),
    ("Mv1+v1", ["Mv1", "v1"], None),
    ("a|b", None, "|"),
    ("chan1+chan2+chan3+chan4", ["chan1", "chan2", "chan3", "chan4"], ","),
])
def test_channel_names(name, available, sep):
    assert (channels.split_channel_name(name, available, sep)
            == jchannels.split_channel_name(name, available, sep))
    if available is not None and "|" not in name and "," not in name:
        assert (channels.channel_combination_weights(name, available)
                == jchannels.channel_combination_weights(name, available))


def test_unique_list_and_timer():
    items = ["b", "a", "b", "c", "a"]
    assert misc.unique_list(items) == jmisc.unique_list(items)
    assert misc.create_series_name(3).startswith("I3_D")
    timer = StageTimer()
    with timer.stage("read"):
        time.sleep(0.01)
    timer.add_seconds("read", 1.0)
    timer.add_items("read", 10)
    rep = timer.report(log=False)
    assert rep["read"]["seconds"] > 1.0 and rep["read"]["items"] == 10


# -- config ----------------------------------------------------------------

def test_normalize_config_matches_yamlconfig(tmp_path):
    path = str(tmp_path / "ref.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(REF_CONFIG, f)
    want = YamlConfig(path, available_channels=REF_CHANS,
                      sample_rate=1.25e6).get_config()
    got = yamlconfig.normalize_config(yamlconfig.load_yaml(path),
                                      REF_CHANS, 1.25e6)
    assert got == want
    # and the shell cases' config, with an include file
    inc = str(tmp_path / "inc.yaml")
    with open(inc, "w") as f:
        yaml.safe_dump({"filter_file": "/x/filter.h5"}, f)
    main = str(tmp_path / "main.yaml")
    with open(main, "w") as f:
        yaml.safe_dump({**cases.CONFIG, "include": inc}, f)
    want = YamlConfig(main, cases.CHANNELS, sample_rate=cases.FS).get_config()
    assert yamlconfig.normalize_config(yamlconfig.load_yaml(main),
                                       cases.CHANNELS, cases.FS) == want


def test_yaml_refuses_duplicate_keys(tmp_path):
    path = str(tmp_path / "dup.yaml")
    with open(path, "w") as f:
        f.write("chan1:\n  baseline:\n    run: true\n    run: false\n")
    with pytest.raises(ValueError, match='Duplicate key "run"'):
        yamlconfig.load_yaml(path)
    with pytest.raises(ValueError, match="No configuration"):
        yamlconfig.normalize_config({}, ["chan1"])


# -- filter data -------------------------------------------------------------

def test_filter_data_load_matches_jax(tmp_path):
    jfd = cases.filter_data()
    csd = np.random.default_rng(1).standard_normal((2, 2, 64)) + 0j
    jfd.set_csd(["chan1", "chan2"], csd, cases.FS)
    path = str(tmp_path / "filter.h5")
    jfd.save_hdf5(path)
    jfd = JaxFilterData(verbose=False).load_hdf5(path)
    fd = FilterData(verbose=False).load_hdf5(path)
    assert sorted(fd.channels()) == sorted(jfd.channels())
    for chan, tag in (("chan1", "default"), ("chan2", "short"),
                      ("chan1+chan2", "default")):
        for got, want in zip(fd.get_template(chan, tag, True),
                             jfd.get_template(chan, tag, True)):
            if isinstance(want, dict):
                assert got == want
            else:
                np.testing.assert_array_equal(got, want)
        for fold in (False, True):
            for got, want in zip(fd.get_psd(chan, tag, fold, True),
                                 jfd.get_psd(chan, tag, fold, True)):
                if isinstance(want, dict):
                    assert got == want
                else:
                    np.testing.assert_array_equal(got, want)
    for got, want in zip(fd.get_csd("chan1|chan2", fold=True),
                         jfd.get_csd("chan1|chan2", fold=True)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        fd.get_template("chan1", "nosuch")


def test_filter_fixture_loads_as_the_jax_store():
    """tests/fixtures/filter_fixture.h5, written with bare h5py: the
    entries the shell reads equal the JAX store's; tables and dicts load
    too (a table as a dict of columns)."""
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "filter_fixture.h5")
    jfd = JaxFilterData(verbose=False).load_hdf5(path)
    fd = FilterData(verbose=False).load_hdf5(path)
    for got, want in (
            (fd.get_template("chanA", return_metadata=True),
             jfd.get_template("chanA", return_metadata=True)),
            (fd.get_psd("chanA", fold=True, return_metadata=True),
             jfd.get_psd("chanA", fold=True, return_metadata=True)),
            (fd.get_csd("chanA|chanB", return_metadata=True),
             jfd.get_csd("chanA|chanB", return_metadata=True))):
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)
    table, _, _ = fd._get("chanB", "ivsweep_data_default")
    want = jfd.get_ivsweep_data("chanB")
    assert list(table) == list(want.columns)
    np.testing.assert_array_equal(table["tes_bias"],
                                  want["tes_bias"].to_numpy())


def test_filter_data_in_memory_matches_jax():
    tmpl = np.hanning(64)
    psd = np.linspace(1.0, 2.0, 64)
    jfd, fd = JaxFilterData(verbose=False), FilterData(verbose=False)
    for store in (jfd, fd):
        store.set_template("c", tmpl, 1e6, pretrigger_length_msec=0.02,
                           tag="t")
        store.set_psd(["c", "d"], psd, 1e6, tag="p")
    for got, want in zip(fd.get_template("c", "t", True),
                         jfd.get_template("c", "t", True)):
        assert (got == want) if isinstance(want, dict) else \
            np.array_equal(got, want)
    for got, want in zip(fd.get_psd("d", "p", True, True),
                         jfd.get_psd("d", "p", True, True)):
        assert (got == want) if isinstance(want, dict) else \
            np.array_equal(got, want)


# -- raw data ----------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rawio"))
    return cases.write_raw(root, np.random.default_rng(2), nevents=6,
                           dumps=2)


def _fixture_files():
    return sorted(os.path.join(FIXDIR, f) for f in os.listdir(FIXDIR)
                  if f.endswith(".hdf5"))


def _assert_read_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype
    ga, wa = dict(got[1]), dict(want[1])
    if "adc_conv" in wa:
        np.testing.assert_array_equal(ga.pop("adc_conv"), wa.pop("adc_conv"))
    assert ga == wa


@pytest.mark.parametrize("which", ["writer", "fixture"])
def test_sequential_reads_match_jax(raw_files, which):
    files = raw_files if which == "writer" else _fixture_files()
    jr, tr = JaxRawReader(files), RawReader(files)
    chans = jr.channels
    assert tr.channels == chans and tr.sample_rate == jr.sample_rate
    assert tr.total_events() == jr.total_events()
    for kw in ({}, {"channels": chans[1:]},
               {"dtype": None, "adctoamp": False},
               {"channels": chans[1:], "dtype": None, "adctoamp": False},
               {"dtype": np.float32}):
        jr.rewind()
        tr.rewind()
        while True:
            want = jr.read_next_event(**kw)
            got = tr.read_next_event(**kw)
            if want[0] is None:
                assert got == (None, None)
                break
            _assert_read_equal(got, want)
    for f in files:
        md, jmd = tr.get_metadata(f), jr.get_metadata(f)
        assert md.keys() == jmd.keys()
        assert tr.get_detector_config(f) == jr.get_detector_config(f)
    jr.close()
    tr.close()


@pytest.mark.parametrize("window", [None, (100, 700), (-50, 200),
                                    (3900, 900), (0, 4096)])
def test_random_access_reads_match_jax(raw_files, window):
    jr, tr = JaxRawReader(raw_files), RawReader(raw_files)
    for f in raw_files:
        for ev in (1, 3):
            for kw in ({}, {"channels": ["chan2"], "dtype": None,
                            "adctoamp": False}):
                _assert_read_equal(
                    tr.read_single_event(ev, f, trace_window=window, **kw),
                    jr.read_single_event(ev, f, trace_window=window, **kw))
    with pytest.raises(KeyError):
        tr.read_single_event(99, raw_files[0])
    with pytest.raises(ValueError, match="adctoamp"):
        tr.read_next_event(dtype=None)
    jr.close()
    tr.close()


def test_split_and_prefetch_match_jax(raw_files):
    jr, tr = JaxRawReader(raw_files), RawReader(raw_files)
    assert ([r.files for r in tr.split(2)]
            == [r.files for r in jr.split(2)])
    jev = [a["event_number"] for _, a in jprefetch.EventPrefetcher(jr)]
    tev = [a["event_number"] for _, a in prefetch.EventPrefetcher(tr)]
    assert tev == jev and len(tev) == 6
    src = prefetch.prefetch_events(RawReader(raw_files), nreaders=2,
                                   raw=True)
    got = []
    while (item := src.read_next_event())[0] is not None:
        assert item[0].dtype == np.int16
        got.append((item[1]["dump_number"], item[1]["event_number"]))
    src.close()
    assert sorted(got) == sorted((d, e) for d in (1, 2) for e in (1, 2, 3))


def test_ordered_chunks_match_jax():
    def work(state, chunk):
        time.sleep(0.001 * ((chunk * 7) % 5))
        return (chunk, threading.current_thread().name != "")

    chunks = list(range(23))
    want = list(jprefetch.OrderedChunkPrefetcher(work, chunks, [0, 1, 2]))
    got = list(prefetch.OrderedChunkPrefetcher(work, chunks, [0, 1, 2]))
    assert got == want and [c for c, _ in got] == chunks

    def fail(state, chunk):
        if chunk == 5:
            raise IOError("bad dump")
        return chunk

    with pytest.raises(IOError, match="bad dump"):
        list(prefetch.OrderedChunkPrefetcher(fail, chunks, [0, 1]))


def test_chunked_dataset_is_refused(tmp_path):
    path = str(tmp_path / "cont_I1_D20260101_T000000_F0001.hdf5")
    with h5py.File(path, "w") as f:
        f.attrs["series_num"] = 1
        g = f.create_group("adc1")
        g.attrs.update({"nb_events": 1, "nb_samples": 64, "sample_rate": 1e6,
                        "channel_list": ["c"]})
        g.create_dataset("event_1", data=np.zeros((1, 64), np.int16),
                         chunks=(1, 16), compression="gzip")
    with pytest.raises(ValueError, match="event_1 is not stored as a "
                                         "contiguous"):
        RawIndex.from_pytesdaq([path])


def test_flat_dumps(tmp_path):
    codes = (np.arange(2 * 3 * 2 * 50) % 300 - 150).astype(np.int16)
    codes = codes.reshape(2, 3, 2, 50)
    paths = []
    for d in range(2):
        paths.append(str(tmp_path / f"f{d}.bin"))
        write_flat_dump(paths[-1], codes[d, :2])
        write_flat_dump(paths[-1], codes[d, 2:], append=True)
    idx = RawIndex.from_flat(paths, ["a", "b"], 50, 1e5,
                             "I1_D20260101_T000000",
                             adc_conversion_factor=0.5,
                             detector_config={"b": {"close_loop_norm": 2.0}})
    r = RawReader(idx)
    assert len(idx) == 6
    got = [r.read_next_event() for _ in range(6)]
    for k, (tr, admin) in enumerate(got):
        d, e = divmod(k, 3)
        np.testing.assert_array_equal(tr, codes[d, e] * np.array(
            [[0.5], [0.25]]))
        assert (admin["dump_number"], admin["event_number"]) == (d + 1, e + 1)
        assert admin["event_time"] == pytest.approx(k * 50 / 1e5)
    with open(paths[0], "ab") as f:
        f.write(b"x")
    with pytest.raises(ValueError, match="not a whole number"):
        RawIndex.from_flat(paths, ["a", "b"], 50, 1e5,
                           "I1_D20260101_T000000")


# -- tables ------------------------------------------------------------------

def test_tables_round_trip_with_jax(tmp_path):
    table = {"x": np.arange(4, dtype=np.int64),
             "y": np.linspace(0, 1, 4),
             "s": np.array(["a", "bb", "", "d"]),
             "o": np.array(["u", None, "w", np.nan], dtype=object)}
    path = str(tmp_path / "t.hdf5")
    tables.write_table(table, path)
    want = pd.DataFrame(table)
    jpath = str(tmp_path / "j.hdf5")
    jtables.write_table(want, jpath)
    for p in (path, jpath):
        back = jtables.read_table(p)
        mine = tables.read_table(p)
        for c in table:
            want_c, got_c = back[c].to_numpy(), np.asarray(mine[c])
            miss = pd.isna(want_c)
            np.testing.assert_array_equal(pd.isna(got_c), miss)
            np.testing.assert_array_equal(got_c[~miss], want_c[~miss])
    assert tables.read_table(path)["o"][1] is None
    assert (tables.config_digest(cases.CONFIG)
            == jtables.config_digest(cases.CONFIG))
    assert (tables.output_file_name("d", "feature", "g", "s", 3)
            == jtables.output_file_name("d", "feature", "g", "s", 3))
    for kw in ({}, {"processing_id": "p"}, {"restricted": True},
               {"calib": True}):
        assert (tables.build_prefix("feature", **kw)
                == jtables.build_prefix("feature", **kw))
    parts = tables.concat_tables([{"a": np.arange(2), "b": np.ones(2)},
                                  {"a": np.arange(3)}])
    np.testing.assert_array_equal(parts["b"], [1, 1, np.nan, np.nan, np.nan])


# -- the raw fixture through the shell ---------------------------------------

@pytest.fixture(scope="module")
def fixture_shell_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixshell")
    n, pre, fs = 4096, 2048, 1.25e6
    fd = JaxFilterData(verbose=False)
    from detprocess_tpu.models import pulse
    tmpl = pulse.make_template(fs, n, pre, A=1.0, tau_r=20e-6, tau_f1=2e-4)
    for chan in FIX_CHANNELS:
        fd.set_template(chan, tmpl, fs, pretrigger_length_samples=pre)
        fd.set_psd(chan, np.full(n, 1e-24), fs)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    cfg = {"feature": {"trace_length_samples": n,
                       "pretrigger_length_samples": pre,
                       "all": {"of1x1_nodelay": {"run": True},
                               "of1x1_unconstrained": {"run": True},
                               "baseline": {"run": True},
                               "maximum": {"run": True}},
                       "+".join(FIX_CHANNELS): {"integral": {"run": True}}}}
    cpath = str(root / "cfg.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    return fpath, cpath


def test_fixture_codes_converted_on_the_device_path(fixture_shell_inputs):
    fpath, cpath = fixture_shell_inputs
    shell = FeatureProcessing(_fixture_files(), cpath, fpath, verbose=False,
                              device="cpu")
    t64 = shell.process(batch_size=2, dtype=np.float64)
    assert shell.stats["upload_bytes"] == 8 * shell.stats["upload_samples"]
    t32 = shell.process(batch_size=2, dtype=np.float32)
    assert shell.stats["upload_bytes"] == 2 * shell.stats["upload_samples"]
    assert shell.stats["upload_samples"] == 3 * 2 * 4096
    for k in t64:
        if k.startswith(("amp_", "baseline_", "maximum_", "integral_")):
            scale = np.abs(t64[k]).max()
            np.testing.assert_allclose(t32[k], t64[k], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
    # the conversion itself: codes × (cal / close_loop_norm)
    adc = np.load(os.path.join(FIXDIR, "expected_adc.npy"))
    want = adc[:, 0, :-1].astype(np.float64).max(axis=-1) * 2.5e-7 / 1.6e4
    np.testing.assert_allclose(t32["maximum_Melange1pc1ch"], want,
                               rtol=1e-6)
    np.testing.assert_allclose(t64["maximum_Melange1pc1ch"], want,
                               rtol=1e-14)
    jdf = JaxFP(_fixture_files(), cpath, filter_data=fpath,
                verbose=False).process(batch_size=2, dtype=np.float64)
    cases.assert_tables_equal(t64, jdf, "fixture")


def test_shell_reads_a_raw_writer_int16_file(raw_files, tmp_path):
    w = RawWriter(str(tmp_path / "f32"), cases.SERIES, cases.FS,
                  cases.CHANNELS)
    w.write_dump(np.zeros((1, 2, 8)), dump_num=1)
    idx = RawIndex.from_pytesdaq(raw_files)
    assert [d.dtype for d in idx.datasets[:1]] == [np.dtype(np.int16)]
    assert RawIndex.from_pytesdaq(
        sorted(str(p) for p in (tmp_path / "f32").iterdir())
    ).datasets[0].dtype == np.float32
