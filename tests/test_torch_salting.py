"""The port's Salting (pipelines/salting.py) against the JAX package's.

Data: 4 continuous events of 2 channels × 250,000 samples written by the
JAX RawWriter (int16 codes), read by the JAX Salting through its own
reader and by the port's through ``RawIndex.from_pytesdaq``; templates of
4096 samples (pretrigger 1024) in both packages' FilterData.

Tolerances: the samplers with the same rng, exactly; ``generate_salt``'s
table for the same seed (fixed energies, a tabulated dR/dE, a pickled DM
spectrum file, and the dPdI energy normalization with the dPdI on another
frequency grid): the same columns in the same order and dtypes, integer
and string columns exactly, float columns within 1e-12 relative;
``inject_raw_salt`` exactly; ``salt_efficiency``'s table and the
``recovered`` column exactly; ``save`` reads back the same table.
"""

import jax  # noqa: F401
import numpy as np
import pandas as pd
import pytest

from detprocess_tpu.io.filterfile import FilterData as JaxFilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu.pipelines import salting as jsalting
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.pipelines import salting

FS = 1.25e6
L = 250000
NT = 4096
PRE = 1024
CHANNELS = ["chan1", "chan2"]
SERIES = "I1_D20260902_T090000"


def _filter_data(cls, dpdi=False):
    fd = cls(verbose=False)
    for i, chan in enumerate(CHANNELS):
        tmpl = pulse.make_template(FS, NT, PRE, A=1.0, tau_r=20e-6,
                                   tau_f1=(150e-6, 250e-6)[i])
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRE)
        if dpdi:
            # a dPdI on its own frequency grid (not the template's axis)
            freqs = np.linspace(-FS / 2, FS / 2, 3001)
            val = (-(1.0 + i) * 1e-6 * (1 + 2j * np.pi * freqs * 1e-5)
                   / (1 + (freqs / 2e5) ** 2))
            fd.set_dpdi(chan, val, freqs, poles=2)
    return fd


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("salting")
    rng = np.random.default_rng(4)
    traces = rng.standard_normal((4, 2, L)) * 2e-7
    w = RawWriter(str(root / "raw"), SERIES, FS, CHANNELS,
                  data_type="continuous", adc_conversion_factor=2.0 ** -24,
                  detector_config={c: {"close_loop_norm": 1.0}
                                   for c in CHANNELS})
    w.write_dump(traces[:2], dump_num=1)
    w.write_dump(traces[2:], dump_num=2)
    files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(root=root, files=files, index=RawIndex.from_pytesdaq(files),
                traces=traces)


def assert_table_equal(got, want, what=""):
    """A port table against a JAX DataFrame: columns, order, dtypes;
    ints and strings exactly, floats within 1e-12 relative."""
    assert list(got) == list(want.columns), what
    for col in want.columns:
        g, w = np.asarray(got[col]), want[col].to_numpy()
        assert g.dtype == w.dtype, (what, col, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=f"{what} {col}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {col}")


def test_samplers_match_jax():
    e = np.geomspace(1.0, 1e3, 300)
    drde = 1 / e
    for seed in (0, 1):
        got = salting.sample_from_pdf(e, drde, 5000,
                                      np.random.default_rng(seed))
        want = jsalting.sample_from_pdf(e, drde, 5000,
                                        np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        got = salting.sample_pdf_function(lambda x: np.exp(-x / 0.1),
                                          (1e-5, 1.0), 5000,
                                          np.random.default_rng(seed),
                                          npoints=777)
        want = jsalting.sample_pdf_function(lambda x: np.exp(-x / 0.1),
                                            (1e-5, 1.0), 5000,
                                            np.random.default_rng(seed),
                                            npoints=777)
        np.testing.assert_array_equal(got, want)


def test_dm_draws_and_energy_splits_match_jax():
    port = salting.Salting(_filter_data(FilterData), verbose=False)
    ref = jsalting.Salting(_filter_data(JaxFilterData), verbose=False)
    for s in (port, ref):
        s.sample_DMpdf(lambda x: np.exp(-x / 0.2), (1e-3, 1.0), 400, seed=3)
        s.sample_DMpdf(lambda x: 1 + 0 * x, (0.1, 0.5), 100, seed=4)
    np.testing.assert_array_equal(port.get_DMenergies(),
                                  ref.get_DMenergies())
    got = port.channel_energy_split(npairs=6, seed=9)
    want = ref.channel_energy_split(npairs=6, seed=9)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (salting.Salting.set_energy_splits_to1([[0.2, 0.8]])
            == [[1, 1]])


def _pdf_file(tmp_path):
    import cloudpickle

    path = tmp_path / "dm.pkl"
    with open(path, "wb") as f:
        cloudpickle.dump({10.0: {"dmrate": lambda e: np.exp(-e / 0.05)},
                          100.0: {"dmrate": lambda e: np.exp(-e / 0.3)}}, f)
    return str(path)


GENERATE = {
    "energies": dict(energies=[50.0, 120.0], nsalt=5,
                     energy_norm_ev_per_amp=2e6),
    "dm_pdf": dict(dm_pdf=(np.geomspace(1, 500, 200),
                           np.geomspace(1, 500, 200) ** -1.5), nsalt=7,
                   energy_norm_ev_per_amp={"chan1": 1e6, "chan2": 3e6},
                   channel_fractions={"chan1": 0.7, "chan2": 0.3}),
    "pdf_file": dict(nsalt=4, energy_norm_ev_per_amp=1e7, coincident=False),
    "dpdi": dict(energies=[80.0], nsalt=6),
    "dm_energies": dict(energy_norm_ev_per_amp=5e6),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_salt_matches_jax(raw, tmp_path, case):
    kw = dict(GENERATE[case], seed=21, min_separation_msec=20.0,
              edge_exclusion_msec=10.0)
    if case == "pdf_file":
        kw["pdf_file"] = _pdf_file(tmp_path)
    port = salting.Salting(_filter_data(FilterData, case == "dpdi"),
                           verbose=False)
    ref = jsalting.Salting(_filter_data(JaxFilterData, case == "dpdi"),
                           verbose=False)
    if case == "dm_energies":
        for s in (port, ref):
            s.sample_DMpdf(lambda x: np.exp(-x / 0.1), (1e-3, 0.5), 9,
                           seed=2)
    got = port.generate_salt(raw["index"], CHANNELS, **kw)
    want = ref.generate_salt(raw["files"], CHANNELS, **kw)
    assert len(want) > 0
    assert_table_equal(got, want, case)
    assert got is port.get_dataframe()


def test_inject_raw_salt_matches_jax(raw):
    kw = dict(energies=[50.0], nsalt=12, energy_norm_ev_per_amp=2e6,
              seed=5, min_separation_msec=10.0, edge_exclusion_msec=2.0)
    port = salting.Salting(_filter_data(FilterData), verbose=False)
    ref = jsalting.Salting(_filter_data(JaxFilterData), verbose=False)
    table = port.generate_salt(raw["index"], CHANNELS, **kw)
    ref.generate_salt(raw["files"], CHANNELS, **kw)
    series = int(table["series_number"][0])
    for ev in range(1, 3):
        for first in (0, 2):
            admin = {"series_number": series, "event_number": ev}
            traces = raw["traces"][first + ev - 1]
            for ws in (0, int(table["trigger_index"][0]) - 2000):
                want = ref.inject_raw_salt(traces, admin, CHANNELS,
                                           window_start=ws)
                got = port.inject_raw_salt(traces, admin, CHANNELS,
                                           window_start=ws)
                np.testing.assert_array_equal(got, want)
                inj = port.make_injector(CHANNELS)
                np.testing.assert_array_equal(
                    inj(traces, admin, window_start=ws), want)
    # an event without salts comes back as given
    trace = raw["traces"][0]
    assert port.inject_raw_salt(trace, {"series_number": series,
                                        "event_number": 99},
                                CHANNELS) is trace


def test_salt_efficiency_matches_jax(raw):
    port = salting.Salting(_filter_data(FilterData), verbose=False)
    table = port.generate_salt(raw["index"], CHANNELS,
                               energies=[10.0, 20.0, 40.0, 80.0], nsalt=6,
                               energy_norm_ev_per_amp=1e6, seed=8,
                               min_separation_msec=5.0,
                               edge_exclusion_msec=2.0)
    rng = np.random.default_rng(1)
    n = len(table["trigger_index"])
    keep = rng.random(n) < 0.6
    trig = {"series_number": table["series_number"][keep],
            "event_number": table["event_number"][keep],
            "trigger_index": (table["trigger_index"][keep]
                              + rng.integers(-25, 26, keep.sum()))}
    # triggers of other events and series at the salts' indices
    trig = {k: np.concatenate([v, v[:5] + (1 if k != "trigger_index"
                                            else 0)])
            for k, v in trig.items()}
    for bins in (None, [0.0, 12.0, 30.0, 100.0]):
        for window in (0, 20):
            got_salts = {k: v.copy() for k, v in table.items()}
            want_salts = pd.DataFrame(table)
            got = salting.salt_efficiency(got_salts, trig, window, bins)
            want = jsalting.salt_efficiency(want_salts, pd.DataFrame(trig),
                                            window, bins)
            assert list(got) == list(want.columns)
            for col in want.columns:
                np.testing.assert_array_equal(got[col], want[col].to_numpy())
                assert got[col].dtype == want[col].dtype, col
            np.testing.assert_array_equal(got_salts["recovered"],
                                          want_salts["recovered"])
    # no triggers: nothing recovered; a DataFrame gets its column too
    frame = pd.DataFrame(table)
    out = salting.salt_efficiency(frame, {}, energy_bins=[0, 100])
    assert out["n_recovered"].tolist() == [0] and not frame[
        "recovered"].any()


def test_save_round_trip_and_set_dataframe(raw, tmp_path):
    port = salting.Salting(_filter_data(FilterData), verbose=False)
    table = port.generate_salt(raw["index"], CHANNELS, energies=[30.0],
                               nsalt=4, energy_norm_ev_per_amp=1e6, seed=2,
                               min_separation_msec=5.0,
                               edge_exclusion_msec=2.0)
    path = port.save(str(tmp_path / "out"), series_name=SERIES)
    assert path.endswith(f"salting_salting_{SERIES}_F0001.hdf5")
    back = tables.read_table(path)
    assert sorted(back) == sorted(table)
    for col, want in table.items():
        np.testing.assert_array_equal(np.asarray(back[col]).astype(
            want.dtype), want, err_msg=col)
    # a table read back (or a DataFrame) salts as the original does
    again = salting.Salting(_filter_data(FilterData), verbose=False)
    again.set_dataframe(tables.to_dataframe(back))
    admin = {"series_number": int(table["series_number"][0]),
             "event_number": int(table["event_number"][0])}
    trace = raw["traces"][0]
    np.testing.assert_array_equal(
        again.inject_raw_salt(trace, admin, CHANNELS),
        port.inject_raw_salt(trace, admin, CHANNELS))
    plan = again.make_device_injector(CHANNELS).plan(
        [admin["series_number"]], [admin["event_number"]], L)
    # salts are matched by (series, event), as in the JAX injectors
    assert (plan.amp != 0).sum() == (
        table["event_number"] == admin["event_number"]).sum()
    with pytest.raises(ValueError, match="no salting table"):
        salting.Salting(_filter_data(FilterData),
                        verbose=False).make_device_injector(CHANNELS)
