"""The port's feature-table merge equals the JAX package's.

``detprocess_tpu_torch.pipelines.merge`` (on tables of numpy columns, a
DataFrame taken through its adapter) against
``detprocess_tpu.pipelines.merge`` (on DataFrames), on the same tables:
the stamps, the grouping by the merge window, the fill of missing
columns, ``merge_nb_matched`` and the duplicate rule (the largest Δχ² of
one table in a group, or the smallest χ² with only a plain χ² column),
exactly. pandas turns a merged row's integers into floats where the row
holds floats, so numeric columns are compared as float64.
"""

import numpy as np
import pandas as pd
import pytest

from detprocess_tpu.io import tables as jtables
from detprocess_tpu.pipelines import merge as jmerge
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.pipelines import merge

FS = 1.25e6


def feature_table(rng, chan, nrow, series=(10**14 + 20260101000000,
                                           10**14 + 20260102000000),
                  chi2="delta"):
    """A per-channel feature table with rows in two series, a few events,
    triggers spread within each event, and this channel's columns."""
    sn = rng.choice(series, nrow)
    ev = rng.integers(1, 4, nrow)
    ti = rng.integers(0, 5000, nrow)
    t = {"series_number": sn.astype(np.int64),
         "event_number": ev.astype(np.int64),
         "trigger_index": ti.astype(np.int64),
         "event_time": ev * 1.0 + ti / FS,
         f"amp_{chan}": rng.standard_normal(nrow),
         "trigger_channel": np.array([chan] * nrow)}
    if chi2 == "delta":
        t[f"trigger_delta_chi2_{chan}"] = rng.uniform(10, 100, nrow)
    elif chi2 == "plain":
        t[f"chi2_{chan}"] = rng.uniform(10, 100, nrow)
    missing = rng.random(nrow) < 0.2
    t[f"amp_{chan}"][missing] = np.nan
    return t


def assert_merged_equal(got: dict, ref: pd.DataFrame):
    assert list(got) == list(ref.columns)
    for c in ref.columns:
        r = ref[c].to_numpy()
        g = np.asarray(got[c])
        if r.dtype.kind in "if" or (r.dtype == object and all(
                isinstance(v, (int, float, np.number)) for v in r)):
            np.testing.assert_array_equal(g.astype(float), r.astype(float),
                                          err_msg=c)
        else:
            assert [None if v is None or (isinstance(v, float) and v != v)
                    else v for v in g] == [
                None if v is None or (isinstance(v, float) and v != v)
                else v for v in r], c


def tables_of(seed, kinds=("delta", "delta", "plain")):
    rng = np.random.default_rng(seed)
    return [feature_table(rng, f"chan{i + 1}", n, chi2=kind)
            for i, (kind, n) in enumerate(zip(kinds, (40, 30, 25)))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [0, 50, 400])
def test_merge_feature_tables(seed, window):
    parts = tables_of(seed)
    ref = jmerge.merge_feature_tables([pd.DataFrame(t) for t in parts], FS,
                                      merge_window_samples=window)
    got = merge.merge_feature_tables(parts, FS, merge_window_samples=window)
    assert_merged_equal(got, ref)
    # a DataFrame goes through the adapter
    got_df = merge.merge_feature_tables([pd.DataFrame(t) for t in parts], FS,
                                        merge_window_samples=window)
    assert_merged_equal(got_df, ref)


def test_duplicate_rule():
    """Three rows of one table in one group: the largest Δχ² wins (the
    named column over the first 'delta_chi2' one); with only a plain χ²
    column, the smallest."""
    base = {"series_number": np.array([5, 5, 5, 5], np.int64),
            "event_number": np.array([1, 1, 1, 2], np.int64),
            "trigger_index": np.array([100, 120, 140, 100], np.int64),
            "event_time": np.zeros(4)}
    a = {**base, "x_delta_chi2": np.array([3.0, 9.0, 4.0, 1.0]),
         "y_delta_chi2": np.array([8.0, 1.0, 2.0, 1.0]),
         "amp_a": np.array([0.1, 0.2, 0.3, 0.4])}
    b = {**base, "chi2_b": np.array([5.0, 2.0, 7.0, 1.0]),
         "amp_b": np.array([1.0, 2.0, 3.0, 4.0])}
    for kw in ({}, {"delta_chi2_column": "y_delta_chi2"}):
        ref = jmerge.merge_feature_tables([pd.DataFrame(a), pd.DataFrame(b)],
                                          FS, 50, **kw)
        got = merge.merge_feature_tables([a, b], FS, 50, **kw)
        assert_merged_equal(got, ref)
        assert list(got["merge_nb_matched"]) == [2, 2]
    got = merge.merge_feature_tables([a, b], FS, 50)
    assert got["amp_a"][0] == 0.2 and got["amp_b"][0] == 2.0
    got = merge.merge_feature_tables([a, b], FS, 50,
                                     delta_chi2_column="y_delta_chi2")
    assert got["amp_a"][0] == 0.1


def test_spicestamp_and_its_fallback():
    rng = np.random.default_rng(3)
    t = feature_table(rng, "chan1", 20)
    np.testing.assert_array_equal(merge.spicestamp(t, FS),
                                  jmerge.spicestamp(pd.DataFrame(t), FS))
    foreign = {"event_time": t["event_time"],
               "trigger_index": t["trigger_index"], "amp": t["amp_chan1"]}
    np.testing.assert_array_equal(
        merge.spicestamp(foreign, FS),
        jmerge.spicestamp(pd.DataFrame(foreign), FS))
    ref = jmerge.merge_feature_tables([pd.DataFrame(foreign)] * 2, FS, 10)
    assert_merged_equal(merge.merge_feature_tables([foreign] * 2, FS, 10),
                        ref)


def test_empty_tables():
    assert merge.merge_feature_tables([], FS) == {}
    empty = {"series_number": np.zeros(0, np.int64)}
    assert merge.merge_feature_tables([empty], FS) == {}
    assert len(jmerge.merge_feature_tables([pd.DataFrame(empty)], FS)) == 0


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
def test_merge_feature_files(tmp_path, fmt):
    parts = tables_of(7)
    paths = []
    for i, t in enumerate(parts):
        path = str(tmp_path / f"feature_c{i}_I1_D20260101_T000000_F0001.hdf5")
        jtables.write_table(pd.DataFrame(t), path)
        paths.append(path)
    ref = jmerge.merge_feature_files(paths, FS, 100)
    out = str(tmp_path / f"merged.{fmt}")
    got = merge.merge_feature_files(paths, FS, 100, output_path=out)
    assert_merged_equal(got, ref)
    back = tables.read_table(out)
    # HDF5 gives the columns back in name order, npz in the table's
    assert (list(back) == list(got) if fmt == "npz"
            else sorted(back) == sorted(got))
    for c in got:
        if got[c].dtype.kind == "f":
            np.testing.assert_array_equal(back[c], got[c])
        else:
            assert list(back[c]) == list(got[c])
