"""The port's utils/misc copies equal the JAX package's functions.

Each function of ``detprocess_tpu_torch/utils/misc.py`` copied from
``detprocess_tpu/utils/misc.py`` gets the same inputs as the original and
must give the same output (exactly: they are host code on the same
numpy). ``get_dataframe_series_list`` also finds the port's ``.npz``
dumps.
"""

import os
from datetime import datetime

import numpy as np
import pytest

from detprocess_tpu.utils import misc as jmisc
from detprocess_tpu_torch.utils import misc


@pytest.mark.parametrize("values", [[1, 2, 3, 5], [7], [3, 1, 2, 9, 10, 11],
                                    [], [4, 4, 5]])
def test_build_range_str(values):
    assert misc.build_range_str(values) == jmisc.build_range_str(values)


@pytest.mark.parametrize("text", ["1-3,5", "7", " 2 - 4 , 9,", "10-10"])
def test_hyphen_range(text):
    assert misc.hyphen_range(text) == jmisc.hyphen_range(text)


@pytest.mark.parametrize("arg", [None, "a,b", ["a, b", "c"], ["x", ",", "y"],
                                 [1, "2,3"]])
def test_extract_list(arg):
    assert misc.extract_list(arg) == jmisc.extract_list(arg)


@pytest.mark.parametrize("text", ["10s", "5m", "2h", "1d", "3.5", " 7 m "])
def test_convert_to_seconds(text):
    assert misc.convert_to_seconds(text) == jmisc.convert_to_seconds(text)


def test_convert_to_seconds_refuses_what_jax_refuses():
    for mod in (misc, jmisc):
        with pytest.raises(ValueError, match="cannot parse"):
            mod.convert_to_seconds("5 weeks")


@pytest.mark.parametrize("value", [None, [], "", (), [0], "x", 3, 0.0,
                                   np.zeros(0), np.zeros(2)])
def test_is_empty(value):
    assert misc.is_empty(value) == jmisc.is_empty(value)


@pytest.mark.parametrize("ftau", [200e-6, 10e-6, 20e-6])
def test_twopole(ftau):
    t = np.linspace(-1e-4, 2e-3, 777)
    np.testing.assert_array_equal(misc.twopole(t, 20e-6, ftau, 3.0, 1e-4),
                                  jmisc.twopole(t, 20e-6, ftau, 3.0, 1e-4))


def test_create_series_name_and_directory(tmp_path):
    now = datetime(2026, 3, 4, 5, 6, 7)
    assert (misc.create_series_name(2, now)
            == jmisc.create_series_name(2, now) == "I2_D20260304_T050607")
    path = str(tmp_path / "a" / "b")
    misc.create_directory(path)
    misc.create_directory(path)
    assert os.path.isdir(path)


def test_get_dataframe_series_list(tmp_path):
    names = ["feature_g_I1_D20260101_T000001_F0001.hdf5",
             "feature_g_I1_D20260101_T000001_F0002.hdf5",
             "feature_g_I1_D20260102_T000000_F0001.hdf5",
             "notes.txt"]
    for name in names:
        (tmp_path / name).write_text("")
    assert (misc.get_dataframe_series_list(str(tmp_path))
            == jmisc.get_dataframe_series_list(str(tmp_path))
            == ["I1_D20260101_T000001", "I1_D20260102_T000000"])
    # the port's npz dumps count too
    (tmp_path / "feature_g_I1_D20260103_T000000_F0001.npz").write_text("")
    assert misc.get_dataframe_series_list(str(tmp_path))[-1] == \
        "I1_D20260103_T000000"
    for mod in (misc, jmisc):
        with pytest.raises(ValueError, match="Expecting a directory"):
            mod.get_dataframe_series_list(str(tmp_path / "notes.txt"))
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (misc, jmisc):
        with pytest.raises(ValueError, match="No HDF5 files"):
            mod.get_dataframe_series_list(str(empty))


@pytest.mark.parametrize("kwargs", [
    {},
    {"fmin": 50.0, "fmax": 5000.0, "npeaks": 3},
    {"fmin": 50.0, "fmax": 5000.0, "npeaks": 2, "min_separation_hz": 300.0},
    {"fmin": 50.0, "fmax": 5000.0, "npeaks": 2, "min_prominence": 1.0},
    {"fmin": 1e6, "fmax": 2e6},                 # no bin in the band
    {"fmin": 600.0, "fmax": 640.0},             # no peak in the band
])
def test_find_psd_peaks(kwargs):
    rng = np.random.default_rng(4)
    f = np.arange(0, 8000.0, 10.0)
    psd = 1.0 + 0.1 * rng.standard_normal(f.size)
    for line, height in ((300.0, 8.0), (1200.0, 5.0), (1500.0, 6.0),
                         (3300.0, 3.0)):
        psd += height * np.exp(-0.5 * ((f - line) / 15.0) ** 2)
    psd[(f > 600) & (f < 640)] = np.linspace(2.0, 1.0, 3)
    assert (misc.find_psd_peaks(f, psd, **kwargs)
            == jmisc.find_psd_peaks(f, psd, **kwargs))


@pytest.mark.parametrize("alist", [[3, 1, 3, 2, 1], "a", np.array([2, 2, 5])])
def test_unique_list(alist):
    assert misc.unique_list(alist) == jmisc.unique_list(alist)
