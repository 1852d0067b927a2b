"""The port's randoms, raw-group scan and batch reads against JAX.

- ``pipelines/randoms.Randoms.process``: the table column by column
  against the JAX DataFrame, for ``random_rate`` with an event fraction
  below 1, for ``nrandoms`` with the subsample, in the separation-shrink
  case, and across dumps whose event times do not advance; the
  accessors; the saved table read by the JAX reader;
- ``Randoms.read_random_traces``: the windows equal (float64, exactly),
  a negative start clamped, the windows that overrun the trace dropped;
  the int16 upload converted in float32;
- ``io/rawdata.RawData`` (the group scan and its queries) and
  ``RawReader.read_many_events``.
"""

import os

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from detprocess_tpu.io import tables as jtables
from detprocess_tpu.io.rawdata import RawData as JaxRawData
from detprocess_tpu.io.rawdata import RawReader as JaxRawReader
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.pipelines.randoms import Randoms as JaxRandoms
from detprocess_tpu_torch.io.rawdata import RawData, RawIndex, RawReader
from detprocess_tpu_torch.pipelines.randoms import Randoms

torch.set_num_threads(1)

FS = 1.25e6
L = 60000
CHANNELS = ["chan1", "chan2"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A raw group: two continuous series (the second's second dump
    restarts its event times at 0), a dIdV series and a restricted one."""
    root = tmp_path_factory.mktemp("torch_randoms") / "raw"
    rng = np.random.default_rng(21)
    det = {"chan2": {"close_loop_norm": 2.0}}
    for k, sname in enumerate(["I1_D20260816_T170000",
                               "I1_D20260816_T171000"]):
        w = RawWriter(str(root), sname, FS, CHANNELS, prefix="cont",
                      adc_conversion_factor=1e-9, detector_config=det)
        for dump in (1, 2):
            w.write_dump(rng.standard_normal((3, 2, L)) * 1e-6 + 2e-7,
                         dump_num=dump, start_time=0.0 if k else 10.0 * dump)
    RawWriter(str(root), "I1_D20260816_T172000", FS, CHANNELS,
              prefix="didv", data_type="didv").write_dump(
        rng.standard_normal((2, 2, 4000)) * 1e-6)
    RawWriter(str(root), "I1_D20260816_T173000", FS, CHANNELS,
              prefix="cont_restricted").write_dump(
        rng.standard_normal((1, 2, 4000)) * 1e-6)
    cont = sorted(str(p) for p in root.glob("cont_I1*.hdf5"))
    return dict(root=str(root), cont=cont)


DRAWS = {
    "rate_fraction": dict(random_rate=10.0, seed=3,
                          min_separation_msec=1.0, edge_exclusion_msec=2.0),
    "rate_many": dict(random_rate=300.0, seed=5, min_separation_msec=2.0,
                      edge_exclusion_msec=1.0),
    "nrandoms_subsample": dict(nrandoms=17, seed=8,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=2.0),
    "separation_shrink": dict(nrandoms=60, seed=1),
    "edge_shrink": dict(random_rate=2000.0, seed=2, min_separation_msec=0.0),
}


def _assert_table_equal(table, df):
    assert list(table) == list(df.columns)
    for col in df.columns:
        want = df[col].to_numpy()
        got = np.asarray(table[col])
        assert got.shape == want.shape, col
        if want.dtype == object:
            assert got.tolist() == want.tolist(), col
        else:
            np.testing.assert_array_equal(got, want, err_msg=col)
            assert got.dtype == want.dtype, col


@pytest.mark.parametrize("case", sorted(DRAWS))
def test_randoms_table_matches_jax(group, case):
    draw = DRAWS[case]
    jdf = JaxRandoms(group["cont"], processing_id="p1",
                     verbose=False).process(**draw)
    table = Randoms(group["cont"], processing_id="p1", verbose=False,
                    device="cpu").process(**draw)
    _assert_table_equal(table, jdf)
    assert len(jdf) > 0
    if "nrandoms" in draw:
        assert len(jdf) == draw["nrandoms"]


def test_randoms_accessors_and_save(group, tmp_path):
    jr = JaxRandoms(group["cont"], verbose=False)
    tr = Randoms(RawIndex.from_pytesdaq(group["cont"]), verbose=False,
                 device="cpu")
    assert tr.get_series_dict() == jr.get_series_dict()
    assert tr.get_base_path() == jr.get_base_path()
    assert tr.get_group_name() == jr.get_group_name() == "raw"
    assert tr.get_output_path() is None
    with pytest.raises(ValueError, match="random_rate"):
        tr.process()
    table = tr.process(nrandoms=9, seed=4, lgc_save=True,
                       output_path=str(tmp_path), series_name="I1_D1_T1")
    assert tr.get_output_path() == str(tmp_path)
    path = [p for p in os.listdir(tmp_path) if p.endswith(".hdf5")]
    assert path == ["rand_randoms_I1_D1_T1_F0001.hdf5"]
    back = jtables.read_table(str(tmp_path / path[0]))
    _assert_table_equal(table, back[list(table)])


def _table_for_windows(group):
    df = JaxRandoms(group["cont"], verbose=False).process(
        random_rate=400.0, seed=6, min_separation_msec=1.0,
        edge_exclusion_msec=0.0)
    # a window that starts before the trace (read from 0) and two that
    # overrun its end (dropped)
    df.loc[0, "trigger_index"] = 100
    df.loc[3, "trigger_index"] = L - 10
    df.loc[len(df) - 1, "trigger_index"] = L - 1000
    return df


@pytest.mark.parametrize("channels", [None, ["chan2"]])
def test_read_random_traces_match_jax(group, channels):
    df = _table_for_windows(group)
    n, pre = 2048, 1024
    want = JaxRandoms(group["cont"], verbose=False).read_random_traces(
        df, n, pre, channels=channels)
    rnd = Randoms(group["cont"], verbose=False, device="cpu")
    table = {c: df[c].to_numpy() for c in df.columns}
    got = rnd.read_random_traces(table, n, pre, channels=channels)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    assert rnd.stats["windows"] == len(want) < len(df)
    assert rnd.stats["dropped"] == len(df) - len(want)
    rows, starts, kept = rnd.window_rows(table, n, pre)
    assert starts[0] == 0 and 3 not in kept and len(df) - 1 not in kept
    # int16 codes converted in float32 (the GPU path's arithmetic)
    got32 = rnd.read_random_traces(table, n, pre, channels=channels,
                                   dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want, rtol=1e-6, atol=0)


def test_read_random_traces_refuses_unknown_dump(group):
    df = _table_for_windows(group)
    table = {c: df[c].to_numpy() for c in df.columns}
    table["dump_number"] = table["dump_number"].copy()
    table["dump_number"][2] = 9
    with pytest.raises(ValueError, match="dump 9"):
        Randoms(group["cont"], verbose=False, device="cpu") \
            .read_random_traces(table, 1024, 512)


# -- raw data ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["continuous", "didv", "rand"])
@pytest.mark.parametrize("restricted", [False, True])
def test_raw_data_matches_jax(group, kind, restricted):
    jrd = JaxRawData(group["root"], data_type=kind, restricted=restricted)
    rd = RawData(group["root"], data_type=kind, restricted=restricted)
    assert rd.get_data_files() == jrd.get_data_files()
    assert rd.get_series_list() == jrd.get_series_list()
    assert rd.get_group_name() == jrd.get_group_name()
    assert rd.get_base_path() == jrd.get_base_path()
    assert rd.get_facility() == jrd.get_facility()
    assert rd.get_available_channels() == jrd.get_available_channels()
    got, want = rd.get_sample_rate(), jrd.get_sample_rate()
    assert got == want or (np.isnan(got) and np.isnan(want))
    assert rd.get_duration(include_nb_events=True) == \
        jrd.get_duration(include_nb_events=True)
    for name, cfg in jrd.get_data_config().items():
        mine = rd.get_data_config()[name]
        assert mine["channel_list"] == cfg["channel_list"]
        assert mine["detector_config"] == cfg["detector_config"]
        assert sorted(mine["overall"]) == sorted(cfg["overall"])


def test_raw_data_series_filter_and_traces(group):
    name = "I1_D20260816_T171000"
    jrd = JaxRawData(group["root"], series=[name])
    rd = RawData(group["root"], series=[name])
    assert rd.get_data_files() == jrd.get_data_files()
    assert list(rd.get_data_files()) == [name]
    for series, events in ((name, [1, 3, 2]),
                           (120260816171000, [2]),
                           ([name, name], [3, 1])):
        for kw in ({}, {"channels": ["chan2"], "adctoamp": False}):
            got, gad = rd.get_traces(series, events, include_metadata=True,
                                     **kw)
            want, wad = jrd.get_traces(series, events, include_metadata=True,
                                       **kw)
            np.testing.assert_array_equal(got, want)
            assert [a["event_number"] for a in gad] == \
                [a["event_number"] for a in wad]
    with pytest.raises(KeyError):
        rd.get_traces("I1_D20260101_T000000", [1])
    with pytest.raises(KeyError):
        rd.get_traces(name, [99])


@pytest.mark.parametrize("nevents", [None, 4, 100])
def test_read_many_events_matches_jax(group, nevents):
    want, wad = JaxRawReader(group["cont"]).read_many_events(
        nevents, channels=["chan2"])
    got, gad = RawReader(group["cont"]).read_many_events(
        nevents, channels=["chan2"])
    np.testing.assert_array_equal(got, want)
    assert [a["event_number"] for a in gad] == \
        [a["event_number"] for a in wad]
    assert [a["dump_number"] for a in gad] == [a["dump_number"] for a in wad]
