"""The port's FeatureProcessing equals the JAX package's, frame for frame.

``detprocess_tpu_torch.pipelines.features.FeatureProcessing`` on the CPU
(float64, the kernels' plain twins) against
``detprocess_tpu.pipelines.features.FeatureProcessing`` run with
``process(dtype=np.float64, batch_size=8)`` on the same raw HDF5 (int16
codes written by the JAX RawWriter), filter file and YAML
(tests/torch_feature_cases.py): the same columns and rows, admin columns
exactly, feature columns at rtol 1e-9 with an absolute floor of 1e-9 ×
the column's largest |value| for χ² and lowchi2 (differences of large
terms). Also: batch-size and reader-count invariance, the channel-subset
read, the float32 path's int16 upload, dumps and job summary against
the JAX ones, each of the seven algorithms beside the of1x1 fits and the
trace stats alone against the JAX shell, and the refusals.
"""

import json
import os

import jax  # noqa: F401  (conftest sets the platform and x64)
import numpy as np
import pytest
import torch
import yaml

from detprocess_tpu.io import tables as jtables
from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.pipelines import feature_plan
from detprocess_tpu_torch.pipelines.features import FeatureProcessing

import torch_feature_cases as cases

torch.set_num_threads(1)

SERIES_OUT = "I1_D20260901_T130000"
PER_DUMP = 10


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shell"))
    raw, fpath, cpath = cases.write_inputs(root)
    jdir = os.path.join(root, "jax_out")
    jdf = JaxFP(raw, cpath, filter_data=fpath, processing_id="p1",
                verbose=False).process(
        batch_size=8, dtype=np.float64, lgc_save=True, output_path=jdir,
        series_name=SERIES_OUT, nb_events_per_dump=PER_DUMP)
    return dict(root=root, raw=raw, fpath=fpath, cpath=cpath, jdf=jdf,
                jdir=jdir)


@pytest.fixture(scope="module")
def port(inputs):
    """The port's run with the JAX run's arguments, dumps included."""
    tdir = os.path.join(inputs["root"], "port_out")
    shell = FeatureProcessing(inputs["raw"], inputs["cpath"],
                              filter_data=inputs["fpath"], processing_id="p1",
                              verbose=False, device="cpu")
    table = shell.process(batch_size=8, dtype=np.float64, lgc_save=True,
                          output_path=tdir, series_name=SERIES_OUT,
                          nb_events_per_dump=PER_DUMP)
    return dict(shell=shell, table=table, tdir=tdir)


def test_full_table_matches_jax(inputs, port):
    assert len(inputs["jdf"]) == cases.NEVENTS
    cases.assert_tables_equal(port["table"], inputs["jdf"], "full")


@pytest.mark.parametrize("batch_size,nreaders", [(5, 1), (24, 1), (3, 3),
                                                 (8, 2)])
def test_batch_size_and_readers_leave_the_table(inputs, port, batch_size,
                                                nreaders):
    got = port["shell"].process(batch_size=batch_size, dtype=np.float64,
                                nreaders=nreaders)
    assert list(got) == list(port["table"])
    for k, v in port["table"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_nevents_takes_the_first_events(inputs, port):
    got = port["shell"].process(nevents=10, batch_size=4,
                                dtype=np.float64)
    cases.assert_tables_equal(got, inputs["jdf"].iloc[:10].reset_index(
        drop=True), "nevents")
    with pytest.raises(ValueError, match="nreaders > 1"):
        port["shell"].process(nevents=10, nreaders=2)


def test_plan_groups_and_template_pretrigger(port):
    plan = port["shell"].plan
    geoms = [(g.nb_samples, g.nb_pretrigger, g.of_pretrigger)
             for g in plan.groups]
    assert geoms == [(cases.N_CUT, cases.PRE_CUT, cases.PRE_CUT_TEMPLATE),
                     (cases.N, cases.PRETRIG, cases.PRETRIG)]
    cut, full = port["shell"].group_steps(torch.float64)
    assert cut.cut == cases.PRETRIG - cases.PRE_CUT and full.cut is None
    assert cut.of_pretrigger == cases.PRE_CUT_TEMPLATE != cut.pretrigger
    # the shift between the two constrained fits of chan1 is the 24
    # samples between the template's and the group's pretrigger
    t = port["table"]
    d = (t["t0_of1x1_short_chan1"] - t["t0_of1x1_constrained_chan1"])
    np.testing.assert_allclose(
        np.median(d) * cases.FS, cases.PRE_CUT - cases.PRE_CUT_TEMPLATE,
        atol=1.0)


def test_dataframe_adapter(inputs, port):
    df = tables.to_dataframe(port["table"])
    assert list(df.columns) == list(port["table"])
    for col in ("event_number", "series_number", "fridge_run_number"):
        assert df[col].dtype == inputs["jdf"][col].dtype


def test_dumps_match_jax(inputs, port):
    jnames = sorted(f for f in os.listdir(inputs["jdir"])
                    if f.endswith(".hdf5"))
    tnames = sorted(f for f in os.listdir(port["tdir"])
                    if f.endswith(".hdf5"))
    assert tnames == jnames and len(jnames) == 2
    for name in jnames:
        want = jtables.read_table(os.path.join(inputs["jdir"], name))
        got = jtables.read_table(os.path.join(port["tdir"], name))
        cases.assert_tables_equal({c: got[c].to_numpy() for c in got},
                                  want, name)
    # and the port's reader reads the JAX dump
    back = tables.read_table(os.path.join(inputs["jdir"], jnames[0]))
    np.testing.assert_array_equal(back["event_number"],
                                  inputs["jdf"]["event_number"][:16])


def test_job_summary_matches_jax(inputs, port):
    def load(d):
        (name,) = [f for f in os.listdir(d) if f.endswith("summary.json")]
        with open(os.path.join(d, name)) as f:
            return name, json.load(f)

    jname, jsum = load(inputs["jdir"])
    tname, tsum = load(port["tdir"])
    assert tname == jname == f"p1_feature_features_{SERIES_OUT}_summary.json"
    for key in ("wall_sec", "events_per_sec"):
        assert tsum.pop(key) > 0 and jsum.pop(key) > 0
    assert tsum == jsum


def test_float32_uploads_codes_and_agrees(inputs, port):
    shell = port["shell"]
    got = shell.process(batch_size=8, dtype=np.float32)
    stats = shell.stats
    assert stats["upload_samples"] == (cases.NEVENTS * len(cases.CHANNELS)
                                       * cases.N)
    assert stats["upload_bytes"] == 2 * stats["upload_samples"]
    ref = port["table"]
    for k in ref:
        if k.startswith(("amp_", "baseline_", "integral_")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                       atol=1e-4 * np.abs(ref[k]).max(),
                                       err_msg=k)
        if k.startswith("t0_"):
            assert np.abs(got[k] - ref[k]).max() <= 1.0 / cases.FS


def test_channel_subset_is_neither_read_nor_uploaded(inputs, tmp_path):
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       "chan2": dict(cases.COMMON)}}
    cpath = str(tmp_path / "chan2.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    jdf = JaxFP(inputs["raw"], cpath, filter_data=inputs["fpath"],
                verbose=False).process(batch_size=8, dtype=np.float64)
    shell = FeatureProcessing(inputs["raw"], cfg, inputs["fpath"],
                              verbose=False, device="cpu")
    assert shell.plan.read_channels == ["chan2"]
    got = shell.process(batch_size=8, dtype=np.float32)
    assert shell.stats["upload_samples"] == cases.NEVENTS * cases.N
    cases.assert_tables_equal(
        shell.process(batch_size=8, dtype=np.float64), jdf, "chan2")
    assert set(got) == set(jdf.columns)


def _shell(inputs, config=None, filter_data=None):
    return FeatureProcessing(
        RawIndex.from_pytesdaq(inputs["raw"]),
        config or cases.CONFIG,
        filter_data if filter_data is not None else inputs["fpath"],
        verbose=False, device="cpu")


def _algo_filter_file(root):
    """The shell's filter file plus what the seven algorithms read: the
    of1x2x2 templates on chan1, an NxM template of one shared and of two
    time-grouped templates on chan1|chan2, and its 2 × 2 CSD with a
    frequency-dependent cross term."""
    path = os.path.join(root, "filter_algos.h5")
    if os.path.exists(path):
        return path
    fd = cases.filter_data()
    n, pre = cases.N, cases.PRETRIG
    scint = jpulse.make_template(cases.FS, n, pre, A=1.0, tau_r=10e-6,
                                 tau_f1=60e-6)
    evap = jpulse.make_template(cases.FS, n, pre, A=1.0, tau_r=30e-6,
                                tau_f1=400e-6)
    fd.set_template("chan1", scint, cases.FS, pretrigger_length_samples=pre,
                    tag="Scintillation")
    fd.set_template("chan1", evap, cases.FS, pretrigger_length_samples=pre,
                    tag="Evaporation")
    tm = cases.templates(n, pre)
    shared = np.stack([tm["chan1"], 0.7 * tm["chan2"]])[:, None, :]
    two = np.stack([np.stack([tm["chan1"], scint]),
                    np.stack([tm["chan2"], 0.5 * scint])])
    fd.set_template("chan1|chan2", shared, cases.FS,
                    pretrigger_length_samples=pre, tag="shared")
    fd.set_template("chan1|chan2", two, cases.FS,
                    pretrigger_length_samples=pre, tag="two")
    psd = cases.psd(n)
    f = np.fft.fftfreq(n)
    csd = np.zeros((2, 2, n), complex)
    csd[0, 0], csd[1, 1] = psd, 1.3 * psd
    csd[1, 0] = 0.4 * psd * np.exp(-2j * np.pi * f * 3)
    csd[0, 1] = np.conj(csd[1, 0])
    fd.set_csd("chan1|chan2", csd, cases.FS)
    fd.save_hdf5(path)
    return path


ALGO_CASES = {
    "ofnxm": ("chan1|chan2", {
        "template_tag": "shared", "amplitude_names": ["shared"],
        "window_min_from_trig_usec": -30, "window_max_from_trig_usec": 30,
        "interpolate_t0": True}),
    "ofnxmx2": ("chan1|chan2", {
        "template_tag": "two", "template_group_ids": [0, 1],
        "fit_window": [[cases.PRETRIG - 50, cases.PRETRIG + 50],
                       [cases.PRETRIG - 20, cases.PRETRIG + 120]]}),
    "of1x2x2": ("chan1", {"delta_window_min_usec": -40.0,
                          "delta_window_max_usec": 160.0}),
    "psd_amp": ("chan2", {"f_lims": [[45, 65], [1000, 10000]]}),
    "psd_peaks": ("chan1", {"f_lims": [[10e3, 50e3], 30e3], "npeaks": 3,
                            "min_separation_hz": 100.0}),
    "phase": ("chan2", {"f_lims": [[10e3, 50e3]], "npeaks": 2,
                        "threshold_factor": 0.05}),
    "rftau": ("chan1", {"rtau": 30, "ftau": 100}),
}
# rftau's 40 LM steps accept or reject steps whose cost change is at the
# rounding level (tests/test_torch_pulsefit.py)
ALGO_RTOL = {"rftau": 1e-7}


@pytest.mark.parametrize("algo", list(ALGO_CASES))
def test_each_algorithm_matches_jax(inputs, algo):
    channel, kwargs = ALGO_CASES[algo]
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       channel: {algo: {"run": True, **kwargs}}}}
    cpath = os.path.join(inputs["root"], f"algo_{algo}.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump(cfg, f)
    fpath = _algo_filter_file(inputs["root"])
    jdf = JaxFP(inputs["raw"], cpath, filter_data=fpath,
                verbose=False).process(batch_size=8, dtype=np.float64)
    shell = FeatureProcessing(inputs["raw"], cfg, fpath, verbose=False,
                              device="cpu")
    got = shell.process(batch_size=8, dtype=np.float64)
    assert any(c.endswith(channel) and c not in ("event_number",)
               for c in got if channel in c), sorted(got)
    cases.assert_tables_equal(got, jdf, algo, rtol=ALGO_RTOL.get(algo,
                                                                 cases.RTOL))


def test_refuses_external_extractors(inputs):
    cfg = {"feature": {**cases.CONFIG["feature"],
                       "external_file": "/nonexistent/ext.py"}}
    with pytest.raises(ValueError, match="external extractors.*not ported"):
        _shell(inputs, cfg)


def _filter_data(fs_template=cases.FS, template_n=cases.N):
    fd = FilterData(verbose=False)
    for chan, tmpl in cases.templates(template_n, cases.PRETRIG).items():
        fd.set_template(chan, tmpl, fs_template,
                        pretrigger_length_samples=cases.PRETRIG)
        fd.set_psd(chan, cases.psd(cases.N), cases.FS)
    return fd


SIMPLE = {"feature": {"trace_length_samples": cases.N,
                      "pretrigger_length_samples": cases.PRETRIG,
                      "chan1": {"of1x1_nodelay": {"run": True}}}}


def test_refuses_a_stored_sample_rate_of_zero(inputs):
    # the JAX check tests the stored rate's truthiness and lets 0 through
    assert _shell(inputs, SIMPLE, _filter_data()).plan.groups
    with pytest.raises(ValueError, match="sample rate is not consistent"):
        _shell(inputs, SIMPLE, _filter_data(fs_template=0.0))
    with pytest.raises(ValueError, match="sample rate is not consistent"):
        _shell(inputs, SIMPLE, _filter_data(fs_template=1e6))


def test_refuses_a_template_of_another_length(inputs):
    with pytest.raises(ValueError, match="template length 2048 != trace "
                                         "length 4096"):
        _shell(inputs, SIMPLE, _filter_data(template_n=cases.N_CUT))


def test_refuses_an_empty_constrained_window(inputs):
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       "chan1": {"of1x1_constrained": {
                           "run": True, "window_min_index": 0,
                           "window_max_index": cases.N - 1,
                           "lgc_outside_window": True}}}}
    shell = _shell(inputs, cfg)
    with pytest.raises(ValueError, match="selects no delays"):
        shell.process(batch_size=8, dtype=np.float64)


def test_plan_refuses_unknown_algorithm(inputs):
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       "chan1": {"nosuch": {"run": True}}}}
    with pytest.raises(ValueError, match='Cannot find algorithm "nosuch"'):
        _shell(inputs, cfg)
    assert not hasattr(feature_plan, "NOT_PORTED")


def test_default_device_is_the_gpu(inputs):
    # no CUDA device here: the shell refuses rather than falling back
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureProcessing(inputs["raw"], cases.CONFIG, inputs["fpath"],
                          verbose=False)
