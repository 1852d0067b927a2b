"""The port's own file forms round-trip to what the JAX forms give.

- A flat raw group (``write_flat_series``: dumps plus a JSON manifest)
  indexes (``RawIndex.from_files``) to the same index as
  ``RawIndex.from_flat`` given the manifest's values; ``RawData`` answers
  from the manifests; mixed or manifest-less groups are refused by name.
- An ``.npz`` table reads back (``read_table``) as the vaex-layout HDF5 of
  the same table reads back, masks included.
- An ``.npz`` filter file (``FilterData.save_npz``/``load_npz``) reads
  back as ``load_hdf5`` reads the HDF5 file of the same store.
- A JSON setup through ``load_yaml`` equals PyYAML's parse of the same
  file (``write_json_setup`` keeps floats YAML reads as floats), and a
  repeated key is refused with the JAX loader's message.
"""

import json
import os

import numpy as np
import pytest
import yaml

from detprocess_tpu.config.yamlconfig import YamlConfig
from detprocess_tpu_torch.config.yamlconfig import (load_yaml,
                                                    normalize_config,
                                                    write_json_setup)
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData, Table
from detprocess_tpu_torch.io.rawdata import (RawData, RawIndex, RawReader,
                                             write_flat_series)

CHANS = ["chA", "chB", "chC"]
SERIES = "I2_D20260105_T101500"
DET = {"chA": {"close_loop_norm": 2.0, "tes_bias": 1e-4},
       "chB": {"close_loop_norm": 1.0, "tes_bias": -2e-5},
       "chC": {"close_loop_norm": 4.0}}


def dumps(rng, nev=(3, 2), n=64, nchan=len(CHANS)):
    return [rng.integers(-3000, 3000, (e, nchan, n)).astype(np.int16)
            for e in nev]


def assert_same_index(got: RawIndex, ref: RawIndex):
    assert got.paths == ref.paths
    for k in RawIndex.EVENT_KEYS:
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert got.datasets == ref.datasets
    np.testing.assert_array_equal(got.order, ref.order)
    assert got.lookup == ref.lookup
    for fg, fr in zip(got.files, ref.files):
        assert (fg.path, fg.sample_rate, fg.channels, fg.nb_samples) == (
            fr.path, fr.sample_rate, fr.channels, fr.nb_samples)
        np.testing.assert_array_equal(fg.conv, fr.conv)
        assert fg.admin == fr.admin
        assert fg.detector_config == fr.detector_config
        assert fg.metadata == fr.metadata


def test_flat_series_indexes_as_from_flat(tmp_path):
    rng = np.random.default_rng(0)
    data = dumps(rng)
    # the second dump written in two chunks
    parts = [data[0], iter([data[1][:1], data[1][1:]])]
    mpath, paths = write_flat_series(
        str(tmp_path / "raw"), "cont", SERIES, parts, CHANS, 1.25e6,
        adc_conversion_factor=3e-7, detector_config=DET,
        nb_pretrigger_samples=16)
    assert os.path.basename(mpath) == f"cont_{SERIES}.json"
    assert [os.path.basename(p) for p in paths] == [
        f"cont_{SERIES}_F0001.bin", f"cont_{SERIES}_F0002.bin"]
    with open(mpath) as f:
        md = json.load(f)
    assert md["data_type"] == "continuous" and md["facility"] == 2
    assert md["group_name"] == "raw" and md["dtype"] == "int16"
    ref = RawIndex.from_flat(paths, CHANS, 64, 1.25e6, SERIES,
                             dtype=np.int16, adc_conversion_factor=3e-7,
                             detector_config=DET, nb_pretrigger_samples=16,
                             group_name="raw", facility=2)
    got = RawIndex.from_files(paths)
    assert_same_index(got, ref)
    reader = RawReader(paths)
    traces, admin = reader.read_row(3, dtype=None, adctoamp=False)
    np.testing.assert_array_equal(traces, data[1][0])
    assert admin["dump_number"] == 2 and admin["event_number"] == 1
    # one dump alone keeps its number
    alone = RawIndex.from_files(paths[1:])
    assert alone.files[0].admin["dump_number"] == 2
    assert alone.get_detector_config()["chA"]["tes_bias"] == 1e-4


def test_raw_data_answers_from_manifests(tmp_path):
    rng = np.random.default_rng(1)
    raw = str(tmp_path / "group")
    write_flat_series(raw, "cont", SERIES, dumps(rng), CHANS, 1.25e6,
                      detector_config=DET)
    write_flat_series(raw, "cont", "I2_D20260105_T111500", dumps(rng, (1,)),
                      CHANS, 1.25e6)
    write_flat_series(raw, "iv", "I2_D20260105_T121500",
                      dumps(rng, (2,), nchan=1), CHANS[:1], 625e3)
    write_flat_series(raw, "cont_restricted", "I2_D20260105_T131500",
                      dumps(rng, (1,)), CHANS, 1.25e6)
    rd = RawData(raw)
    assert rd.get_series_list() == [SERIES, "I2_D20260105_T111500"]
    assert [len(v) for v in rd.get_data_files().values()] == [2, 1]
    assert rd.get_series_list("iv") == ["I2_D20260105_T121500"]
    assert rd.get_available_channels() == CHANS
    assert rd.get_sample_rate("iv") == 625e3
    cfg = rd.get_data_config(series=SERIES)[SERIES]
    assert cfg["detector_config"] == DET
    assert cfg["overall"]["nb_samples"] == 64
    assert rd.get_duration(series=SERIES, include_nb_events=True) == (
        5 * 64 / 1.25e6, 5)
    assert RawData(raw, restricted=True).get_series_list() == [
        "I2_D20260105_T131500"]
    assert rd.get_facility() == 2


def test_from_files_refusals(tmp_path):
    rng = np.random.default_rng(2)
    _, paths = write_flat_series(str(tmp_path), "cont", SERIES, dumps(rng),
                                 CHANS, 1.25e6)
    h5 = str(tmp_path / f"cont_{SERIES}_F0009.hdf5")
    open(h5, "wb").close()
    with pytest.raises(ValueError, match="mix pytesdaq HDF5"):
        RawIndex.from_files(paths + [h5])
    lone = str(tmp_path / "cont_I1_D20260101_T000000_F0001.bin")
    open(lone, "wb").close()
    with pytest.raises(ValueError, match="has no manifest: expected '.*"
                       "cont_I1_D20260101_T000000.json'"):
        RawIndex.from_files([lone])
    with pytest.raises(ValueError, match="neither a pytesdaq"):
        RawIndex.from_files([str(tmp_path / "x.txt")])
    with pytest.raises(ValueError, match="is not named"):
        RawIndex.from_files([str(tmp_path / "nodump.bin")])
    with pytest.raises(ValueError, match="no raw files"):
        RawIndex.from_files([])


def sample_table():
    return {"i": np.arange(5, dtype=np.int64),
            "f": np.array([0.5, np.nan, 2.0, -1.0, 3.25]),
            "b": np.array([True, False, True, True, False]),
            "s": np.array(["a", "bb", "", "d", "é"]),
            "o": np.array(["x", None, np.nan, "y", "z"], dtype=object),
            "n": np.array([1.0, "q", None, 2, b"r"], dtype=object)}


def assert_same_table(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        if ref[k].dtype.kind == "f":
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert list(got[k]) == list(ref[k]), k


def test_npz_table_reads_back_as_vaex_hdf5(tmp_path):
    table = sample_table()
    tables.write_table(table, str(tmp_path / "t.hdf5"))
    tables.write_table(table, str(tmp_path / "t.npz"), fmt="npz")
    ref = tables.read_table(str(tmp_path / "t.hdf5"))
    got = tables.read_table(str(tmp_path / "t.npz"))
    assert_same_table(got, ref)
    assert list(got) == list(table)          # npz keeps the column order
    # an empty table too
    empty = {k: v[:0] for k, v in table.items()}
    tables.write_table(empty, str(tmp_path / "e.hdf5"))
    tables.write_table(empty, str(tmp_path / "e.npz"))
    assert sorted(tables.read_table(str(tmp_path / "e.npz"))) == sorted(
        tables.read_table(str(tmp_path / "e.hdf5")))
    with pytest.raises(ValueError, match="unknown table format"):
        tables.table_ext("feather")


def test_npz_dumps_are_found_for_resume(tmp_path):
    for series, dump in (("I1_D20260101_T000000", 1),
                         ("I1_D20260102_T000000", 1),
                         ("I1_D20260102_T000000", 2)):
        tables.write_table(sample_table(), tables.output_file_name(
            str(tmp_path), "feature", "features", series, dump, "npz"))
    series, found = tables.newest_dumps(str(tmp_path), "feature", "features",
                                        "npz")
    assert series == "I1_D20260102_T000000"
    assert [d for d, _ in found] == [1, 2]
    assert tables.newest_dumps(str(tmp_path), "feature", "features",
                               "hdf5") is None


def filter_store():
    rng = np.random.default_rng(4)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", rng.standard_normal(32), 1.25e6,
                    pretrigger_length_samples=8, metadata={
                        "note": "t", "skip": None, "lst": [1, 2],
                        "cplx": 1 + 2j})
    fd.set_psd("chan1", rng.uniform(1, 2, 32), 1.25e6)
    fd.set_csd(["chan1", "chan2"], rng.standard_normal((2, 2, 32))
               + 1j * rng.standard_normal((2, 2, 32)), 1.25e6)
    fd.set_dpdi("chan1", rng.standard_normal(17) + 1j, np.arange(17.0), 2)
    fd.set_ivsweep_data("chan1", Table({
        "tes_bias": np.array([1e-4, 2e-4, 3e-4]),
        "state": np.array(["normal", None, "sc"], dtype=object),
        "psd": [rng.standard_normal(5), None, rng.standard_normal(4)],
        "didv": [rng.standard_normal(3) + 1j, rng.standard_normal(3), None],
        "n": np.array([1, 2, 3]),
        "fits": [{"a": 1}, None, {"b": 2}]}))
    fd.set_ivsweep_results("chan1", {
        "i0": 1e-6, "flag": True, "name": "x", "none": None,
        "arr": rng.standard_normal(4), "lst": [1.0, 2.0],
        "nested": {"r": 0.1, "cov": rng.standard_normal((2, 2)),
                   "deep": {"k": np.int64(3)}}, "z": 2 - 1j}, "noise")
    fd._set("chan2", "scalar_default", 3.5, {"sample_rate": 1.25e6})
    fd._set("chan2", "text_default", "hello", None)
    return fd


def assert_same_value(got, ref, where):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), where
        for k in ref:
            assert_same_value(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_value(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


def test_npz_filter_file_reads_back_as_hdf5(tmp_path):
    fd = filter_store()
    fd.save_hdf5(str(tmp_path / "f.hdf5"))
    fd.save_npz(str(tmp_path / "f.npz"))
    ref = FilterData(verbose=False).load_hdf5(str(tmp_path / "f.hdf5"))
    got = FilterData(verbose=False).load_npz(str(tmp_path / "f.npz"))
    assert sorted(got.data) == sorted(ref.data)
    for chan in ref.data:
        assert sorted(got.data[chan]) == sorted(ref.data[chan])
        for name, (value, index, md) in ref.data[chan].items():
            gv, gi, gmd = got.data[chan][name]
            where = f"{chan}/{name}"
            for kind in (np.ndarray, dict, Table):
                assert isinstance(gv, kind) == isinstance(value, kind), where
            assert_same_value(gv, value, where)
            assert_same_value(gi, index, where + " index")
            assert_same_value(gmd, md, where + " metadata")
    # the form follows the suffix
    fd.save(str(tmp_path / "g.npz"))
    again = FilterData(verbose=False).load(str(tmp_path / "g.npz"))
    np.testing.assert_array_equal(again.get_psd("chan1")[0],
                                  fd.get_psd("chan1")[0])
    for path in ("g.json", "g"):
        with pytest.raises(ValueError, match="the suffix names no form"):
            fd.save(str(tmp_path / path))
        with pytest.raises(ValueError, match="the suffix names no form"):
            FilterData(verbose=False).load(str(tmp_path / path))


def test_npz_filter_file_merges_without_overwrite(tmp_path):
    path = str(tmp_path / "m.npz")
    first = FilterData(verbose=False)
    first.set_psd("chan1", np.ones(8), 1e6)
    first.set_psd("chan2", np.ones(8), 1e6)
    first.save_npz(path)
    second = FilterData(verbose=False)
    second.set_psd("chan1", 2 * np.ones(8), 1e6)
    second.save_npz(path, overwrite=False)
    back = FilterData(verbose=False).load(path)
    assert sorted(back.data) == ["chan1", "chan2"]
    np.testing.assert_array_equal(back.get_psd("chan1")[0], 2 * np.ones(8))
    # present parameters stay unless overwrite
    mine = FilterData(verbose=False)
    mine.set_psd("chan1", 5 * np.ones(8), 1e6)
    mine.load(path)
    np.testing.assert_array_equal(mine.get_psd("chan1")[0], 5 * np.ones(8))
    mine.load(path, overwrite=True)
    np.testing.assert_array_equal(mine.get_psd("chan1")[0], 2 * np.ones(8))


SETUP = {
    "filter_file": "/data/filter.npz",
    "include": [],
    "trigger": {"coincident_window_msec": 0.2,
                "chan1": {"run": True, "threshold_sigma": 5.0,
                          "pileup_window_msec": 1e-1,
                          "saturation_amplitudes": [5e-7, 1e-05]}},
    "feature": {"trace_length_samples": 4096,
                "pretrigger_length_samples": 1024,
                "chan1,chan2": {"of1x1_nodelay": {"run": True,
                                                  "lowchi2_fcutoff": 1e4}},
                "chan3": {"baseline": {"run": False}}},
    "salting": {"energies": [2.0, 3.0], "nsalt": 7,
                "energy_norm_ev_per_amp": {"chan1": 2.5e7, "chan2": 3e-30}},
}


def test_json_setup_equals_pyyaml(tmp_path):
    inc = write_json_setup({"noise": {"nrandoms": 16}},
                           str(tmp_path / "inc.json"))
    setup = dict(SETUP, include=[inc])
    path = write_json_setup(setup, str(tmp_path / "setup.json"))
    with open(path) as f:
        text = f.read()
    assert load_yaml(path) == yaml.safe_load(text) == setup
    chans = ["chan1", "chan2", "chan3"]
    got = normalize_config(load_yaml(path), chans, 1.25e6)
    ref = YamlConfig(path, chans, sample_rate=1.25e6)
    for field in ("feature", "trigger", "salting", "noise"):
        assert got[field] == ref.get_config(field), field
    assert got["noise"]["overall"]["nrandoms"] == 16


def test_json_setup_refuses_a_repeated_key(tmp_path):
    path = str(tmp_path / "dup.json")
    with open(path, "w") as f:
        f.write('{"feature": {"chan1": {"of1x1_nodelay": {"run": true}, '
                '"of1x1_nodelay": {"run": false}}}}')
    with pytest.raises(ValueError) as port:
        load_yaml(path)
    with pytest.raises(ValueError) as jax_side:
        YamlConfig(path, ["chan1"])
    assert str(port.value) == str(jax_side.value)
    assert 'Duplicate key "of1x1_nodelay"' in str(port.value)


def test_json_setup_refuses_what_json_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="JSON has no such number"):
        write_json_setup({"x": float("nan")}, str(tmp_path / "n.json"))
