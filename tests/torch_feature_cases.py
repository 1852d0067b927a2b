"""Shared inputs of the FeatureProcessing parity tests
(tests/test_torch_features*.py): raw HDF5 written by the JAX package's
RawWriter (int16 ADC codes), a filter file and a processing YAML, and the
JAX FeatureProcessing run on them in float64.

The config exercises the port's algorithms: of1x1 no-delay,
unconstrained (with and without the parabolic refit) and constrained
fits, the five trace stats with windows, a ``chan1+chan2`` compound
channel, and a window-cut trace group (2048 of the 4096 raw samples)
whose templates store their own pretrigger (1000), different from the
group's (1024), so that the OF delay alignment follows the template.
"""

import os

import numpy as np
import yaml

from detprocess_tpu.io.filterfile import FilterData
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse

FS = 1.25e6
N = 4096
PRETRIG = 2048
N_CUT = 2048
PRE_CUT = 1024
PRE_CUT_TEMPLATE = 1000
CHANNELS = ["chan1", "chan2"]
NEVENTS = 24
CAL = 2.0 ** -22
CLN = {"chan1": 1.0, "chan2": 2.0}
SERIES = "I1_D20260901_T120000"
RTOL = 1e-9


def psd(n, white=1e-20, knee=100.0):
    f = np.abs(np.fft.fftfreq(n, 1 / FS))
    f[0] = f[1]
    return white * (1.0 + knee / f)


def templates(n, pre):
    return {"chan1": pulse.make_template(FS, n, pre, A=1.0, tau_r=20e-6,
                                         tau_f1=200e-6),
            "chan2": pulse.make_template(FS, n, pre, A=1.0, tau_r=12e-6,
                                         tau_f1=90e-6)}


def write_raw(root, rng, nevents=NEVENTS, dumps=2):
    """Two dumps of int16 events: white-ish noise plus pulses of 1-3 µA
    at offsets within ±40 samples; returns the sorted paths."""
    tm = templates(N, PRETRIG)
    detcfg = {c: {"close_loop_norm": CLN[c], "tes_bias": 1e-7 * (i + 1),
                  "output_gain": 10.0} for i, c in enumerate(CHANNELS)}
    w = RawWriter(os.path.join(root, "raw"), SERIES, FS, CHANNELS,
                  nb_pretrigger_samples=PRETRIG, detector_config=detcfg,
                  adc_conversion_factor=CAL, fridge_run=7,
                  series_start_time=1000)
    per = nevents // dumps
    for d in range(dumps):
        traces = rng.standard_normal((per, len(CHANNELS), N)) * 1.2e-7
        for e in range(per):
            shift = int(rng.integers(-40, 41))
            for c, chan in enumerate(CHANNELS):
                traces[e, c] += rng.uniform(1e-6, 3e-6) * np.roll(
                    tm[chan], shift)
        w.write_dump(traces, dump_num=d + 1, start_time=100.0 * d)
    return sorted(os.path.join(root, "raw", f)
                  for f in os.listdir(os.path.join(root, "raw")))


def filter_data():
    fd = FilterData(verbose=False)
    for chan, tmpl in templates(N, PRETRIG).items():
        fd.set_template(chan, tmpl, FS, pretrigger_length_samples=PRETRIG)
        fd.set_psd(chan, psd(N), FS)
    both = templates(N, PRETRIG)
    fd.set_template("chan1+chan2", both["chan1"] + both["chan2"], FS,
                    pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1+chan2", 2 * psd(N), FS)
    for chan, tmpl in templates(N_CUT, PRE_CUT_TEMPLATE).items():
        fd.set_template(chan, tmpl, FS,
                        pretrigger_length_samples=PRE_CUT_TEMPLATE,
                        tag="short")
        fd.set_psd(chan, psd(N_CUT), FS, tag="short")
    return fd


COMMON = {
    "of1x1_nodelay": {"run": True, "lowchi2_fcutoff": 20000},
    "of1x1_unconstrained": {"run": True},
    "of1x1_constrained": {"run": True, "window_min_from_trig_usec": -30,
                          "window_max_from_trig_usec": 30},
    "baseline": {"run": True, "window_max_from_trig_usec": -200},
    "integral": {"run": True, "window_min_from_trig_usec": -20,
                 "window_max_from_trig_usec": 800},
    "maximum": {"run": True},
    "minimum": {"run": True, "window_min_from_start_usec": 100},
}

CONFIG = {
    "feature": {
        "trace_length_samples": N,
        "pretrigger_length_samples": PRETRIG,
        "chan1": {
            **COMMON,
            "of1x1_interp": {"run": True,
                             "base_algorithm": "of1x1_unconstrained",
                             "interpolate": True},
            "of1x1_short": {"run": True,
                            "base_algorithm": "of1x1_constrained",
                            "template_tag": "short", "csd_tag": "short",
                            "trace_length_samples": N_CUT,
                            "pretrigger_length_samples": PRE_CUT,
                            "window_min_from_trig_usec": -40,
                            "window_max_from_trig_usec": 40},
            "energyabsorbed": {"run": True, "vb": 3e-6, "i0": 1e-7,
                               "rl": 5e-3,
                               "window_min_from_trig_usec": -100},
        },
        "chan2": {
            **COMMON,
            "of1x1_short_nd": {"run": True,
                               "base_algorithm": "of1x1_nodelay",
                               "template_tag": "short", "csd_tag": "short",
                               "trace_length_samples": N_CUT,
                               "pretrigger_length_samples": PRE_CUT},
        },
        "chan1+chan2": {
            "feature_channel": "sum12",
            "baseline": {"run": True},
            "of1x1_nodelay": {"run": True},
        },
    },
}


def write_inputs(root, seed=5):
    """(raw paths, filter path, yaml path) under ``root``."""
    rng = np.random.default_rng(seed)
    raw = write_raw(root, rng)
    fpath = os.path.join(root, "filter.h5")
    filter_data().save_hdf5(fpath)
    cpath = os.path.join(root, "features.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(CONFIG, f)
    return raw, fpath, cpath


def assert_tables_equal(got, want, what="", rtol=RTOL):
    """The port's table (dict of columns) against the JAX DataFrame:
    the same column set, the same rows; admin columns exactly, floats
    within ``rtol`` of the column's magnitude where the value is a
    difference of large terms (χ², lowchi2: an absolute floor of rtol ×
    the column's largest |value|) and of the value elsewhere."""
    assert set(got) == set(want.columns), (
        what, sorted(set(got) ^ set(want.columns)))
    for col in want.columns:
        w = want[col].to_numpy()
        g = np.asarray(got[col])
        assert len(g) == len(w), (what, col)
        if np.issubdtype(w.dtype, np.floating) and col.split("_")[0] not in (
                "event", "series", "trigger", "tes", "output"):
            floor = (rtol * np.max(np.abs(w)) if col.startswith(
                ("chi2", "lowchi2")) else 0.0)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=floor,
                                       err_msg=f"{what} {col}")
        else:
            assert g.dtype.kind == w.dtype.kind or (
                g.dtype.kind in "U" and w.dtype.kind in "OT"), (
                what, col, g.dtype, w.dtype)
            np.testing.assert_array_equal(g.astype(w.dtype) if
                                          w.dtype.kind not in "OT" else g,
                                          w, err_msg=f"{what} {col}")
