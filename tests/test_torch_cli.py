"""The port's command line equals the JAX package's, workload by workload.

``detprocess_tpu_torch.cli.main(..., "--device", "cpu")`` against
``detprocess_tpu.cli.main`` on the same pytesdaq HDF5 group (written with
the JAX ``RawWriter`` as tests/test_cli_filtergen.py writes it: three
continuous events of 100,000 samples with a 40 µA pulse each) and the
same setup file (JSON, which both read: the JAX package through PyYAML),
each into an output base of its own. Every case compares the return
codes, the ``ERROR:``/notice lines, the files written (names equal; a
filter file's name carries the clock, so its series part is masked) and
the tables:

- trigger columns: Δχ² and amplitudes within rtol 1e-4 (both CLIs run
  float32, and the JAX shell packs float32; tests/test_torch_triggers.py),
  everything else exact;
- feature columns: amplitudes, baselines and integrals within rtol 1e-4
  of the value and 1e-4 of the column's largest |value|, χ² within rtol
  1e-3 (float32 sums of the two shells; tests/test_torch_features.py's
  float32 check), t0 within a sample, everything else exact;
- randoms and salting tables exact; filter files and the IV-sweep table
  (float64 on the CPU in both) within 1e-9.

The sweep case runs the JAX CLI on an HDF5 sweep and the port on the
flat group of the same int16 codes (``write_flat_series``), which only
the port reads.
"""

import glob
import os
import re

import jax  # noqa: F401  (conftest sets the platform and x64)
import numpy as np
import pytest
import torch

from detprocess_tpu import cli as jcli
from detprocess_tpu.io.filterfile import FilterData as JaxFD
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu_torch import cli, entry
from detprocess_tpu_torch.config.yamlconfig import write_json_setup
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import write_flat_series

torch.set_num_threads(1)

FS = 1.25e6
NT = 2048
PRETRIG = 512
L = 100000
SERIES = "I1_D20260816_T230000"
OUT_SERIES = "I1_D20260901_T000000"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = tmp_path_factory.mktemp("cliparity")
    raw = str(root / "raw")
    rng = np.random.default_rng(31)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((3, 1, L)) * sigma
    for ev, pos in enumerate([30000, 60000, 45000]):
        traces[ev, 0, pos - PRETRIG:pos - PRETRIG + NT] += 40e-6 * tmpl
    RawWriter(raw, SERIES, FS, ["chan1"], prefix="cont").write_dump(
        traces, dump_num=1)
    fd = JaxFD(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", np.full(NT, sigma ** 2 / FS), FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)
    setup = write_json_setup({
        "filter_file": fpath,
        "trigger": {"chan1": {"run": True, "template_tag": "default",
                              "threshold_sigma": 8.0,
                              "pileup_window_msec": 0.5}},
        "feature": {
            "trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "chan1": {"of1x1_nodelay": {"run": True,
                                        "template_tag": "default"},
                      "baseline": {"run": True}}},
        "noise": {},
        "template": {"chan1": {"run": True, "trace_length_samples": NT,
                               "pretrigger_length_samples": PRETRIG,
                               "tau_r": 20e-6, "tau_f1": 200e-6}},
        "salting": {"energies": [30.0, 45.0], "nsalt": 2,
                    "energy_norm_ev_per_amp": 1e6,
                    "min_separation_msec": 5.0,
                    "edge_exclusion_msec": 5.0}},
        str(root / "process.json"))
    # the sweep: HDF5 for the JAX CLI, the same codes as a flat group
    points = entry.ivsweep_points(normal=(400e-6, 350e-6, 300e-6),
                                  transition_r0=(0.15, 0.08),
                                  sc=(4e-6, 2e-6, 1e-6))
    cal = entry.ivsweep_adc_cal(points)
    gen = torch.Generator().manual_seed(3)
    for k, kind, series, codes in entry.ivsweep_codes(
            gen, "cpu", points, 8, 2048, 4, 2):
        prefix = "iv" if kind == "noise" else "didv"
        det = {"chan1": {"tes_bias": points[k]["tes_bias"],
                         "close_loop_norm": 1.0}}
        write_flat_series(str(root / "sweep_flat"), prefix, series, [codes],
                          ["chan1"], FS, adc_conversion_factor=cal,
                          detector_config=det)
        RawWriter(str(root / "sweep_hdf5"), series, FS, ["chan1"],
                  prefix=prefix, detector_config=det,
                  adc_conversion_factor=cal).write_dump(
            codes.astype(np.float64) * cal, dump_num=1)
    sweep_setup = write_json_setup(
        {"didv": {"sgfreq": entry.IV_SGFREQ, "sgamp": entry.IV_SGAMP,
                  "rshunt": entry.IV_RSH}}, str(root / "sweep.json"))
    # a trigger dataframe and a salting dataframe written by the JAX CLI
    assert jcli.main(["--raw_path", raw, "--processing_setup", setup,
                      "--output_group_path", str(root / "made"),
                      "--output-series-name", OUT_SERIES, "--enable-trig",
                      "--enable-salting", "--seed", "9", "--quiet"]) == 0
    return {"root": root, "raw": raw, "setup": setup, "fpath": fpath,
            "sweep_setup": sweep_setup,
            "trigger_dir": str(root / "made" / "trigger"),
            "salting_dir": str(root / "made" / "salting")}


def files_of(out):
    """Every file written under ``out``, relative, a filter file's clock
    masked."""
    found = []
    for d, _, names in os.walk(out):
        for name in names:
            rel = os.path.relpath(os.path.join(d, name), out)
            found.append(re.sub(r"filter_I\d+_D\d{8}_T\d{6}",
                                "filter_<series>", rel))
    return sorted(found)


def lines_of(text, starts=("ERROR:", "INFO: prewarm skips")):
    return [ln for ln in text.splitlines() if ln.startswith(starts)]


def run_both(capsys, common_jax, common_port, base, port_extra=()):
    outs = {}
    for name, main, common, extra in (
            ("jax", jcli.main, common_jax, []),
            ("port", cli.main, common_port, ["--device", "cpu",
                                             *port_extra])):
        out = os.path.join(base, name)
        rc = main(common + ["--output_group_path", out, *extra])
        outs[name] = (rc, out, capsys.readouterr().out)
    return outs


def same_missing(a, b):
    def norm(v):
        return [None if x is None or (isinstance(x, float) and x != x)
                else x for x in v]
    return norm(a) == norm(b)


def compare_tables(got, ref, kind):
    assert sorted(got) == sorted(ref)
    n = tables.table_rows(ref)
    assert tables.table_rows(got) == n > 0
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        if r.dtype.kind not in "fc" and g.dtype.kind not in "fc":
            assert same_missing(list(g), list(r)), k
            continue
        g, r = g.astype(np.float64), r.astype(np.float64)
        if k.startswith(("trigger_delta_chi2", "trigger_amplitude")):
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=k)
        elif kind == "feature" and k.startswith(("amp_", "baseline_",
                                                 "integral_")):
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-4 * np.nanmax(np.abs(r)),
                                       err_msg=k)
        elif kind == "feature" and k.startswith(("chi2_", "lowchi2_")):
            np.testing.assert_allclose(g, r, rtol=1e-3, err_msg=k)
        elif kind == "feature" and k.startswith("t0_"):
            assert np.nanmax(np.abs(g - r)) <= 1.0 / FS, k
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


def compare_outputs(outs, subs, ext_port="hdf5"):
    (rcj, outj, _), (rcp, outp, _) = outs["jax"], outs["port"]
    assert rcj == rcp == 0
    assert files_of(outp) == [f.replace(".hdf5", f".{ext_port}")
                              for f in files_of(outj)]
    for sub, kind in subs:
        for fj in sorted(glob.glob(os.path.join(outj, sub, "*.hdf5"))):
            fp = os.path.join(outp, sub, os.path.basename(fj).replace(
                ".hdf5", f".{ext_port}"))
            compare_tables(tables.read_table(fp), tables.read_table(fj),
                           kind)


CHAINS = {
    "trigger_feature": ["--enable-trig", "--enable-feature"],
    "randoms": ["--enable-rand", "--nrandoms", "12", "--seed", "5"],
    "salting_host": ["--enable-salting", "--enable-trig", "--enable-feature",
                     "--seed", "3"],
    "salting_device": ["--enable-salting", "--device-salting",
                       "--enable-trig", "--enable-feature", "--seed", "3"],
}
SUBS = {"trigger_feature": [("trigger", "trigger"), ("feature", "feature")],
        "randoms": [("randoms", "exact")],
        "salting_host": [("salting", "exact"), ("trigger", "trigger"),
                         ("feature", "feature")]}
SUBS["salting_device"] = SUBS["salting_host"]


@pytest.mark.parametrize("case", sorted(CHAINS) + ["trigger_feature_npz"])
def test_workload_chains(group, tmp_path, capsys, case):
    flags = CHAINS[case.replace("_npz", "")]
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--output-series-name", OUT_SERIES, "--quiet",
              *flags]
    npz = case.endswith("_npz")
    outs = run_both(capsys, common, common, str(tmp_path),
                    ["--output-format", "npz"] if npz else [])
    compare_outputs(outs, SUBS[case.replace("_npz", "")],
                    "npz" if npz else "hdf5")


def test_calc_filter(group, tmp_path, capsys):
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--calc-filter", "--nrandoms", "30",
              "--seed", "7", "--quiet"]
    outs = run_both(capsys, common, common, str(tmp_path))
    compare_outputs(outs, [])
    ref = FilterData(verbose=False).load(
        glob.glob(os.path.join(outs["jax"][1], "filterdata", "*"))[0])
    got = FilterData(verbose=False).load(
        glob.glob(os.path.join(outs["port"][1], "filterdata", "*"))[0])
    assert sorted(got.data["chan1"]) == sorted(ref.data["chan1"])
    for name, (value, _, _) in ref.data["chan1"].items():
        np.testing.assert_allclose(got.data["chan1"][name][0], value,
                                   rtol=1e-9, atol=0, err_msg=name)


def test_trigger_dataframe_path(group, tmp_path, capsys):
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--enable-feature", "--trigger_dataframe_path",
              group["trigger_dir"], "--trigger_series", OUT_SERIES,
              "--ntriggers", "2", "--output-series-name", OUT_SERIES,
              "--quiet"]
    outs = run_both(capsys, common, common, str(tmp_path))
    compare_outputs(outs, [("feature", "feature")])
    feats = tables.read_table(glob.glob(os.path.join(
        outs["port"][1], "feature", "*.hdf5"))[0])
    assert tables.table_rows(feats) == 2


def test_salting_dataframe_path(group, tmp_path, capsys):
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--salting_dataframe_path",
              group["salting_dir"], "--enable-trig",
              "--output-series-name", OUT_SERIES]
    outs = run_both(capsys, common, common, str(tmp_path))
    compare_outputs(outs, [("trigger", "trigger")])
    loaded = [ln for ln in outs["port"][2].splitlines()
              if ln.startswith("INFO: loaded")]
    assert loaded == [ln for ln in outs["jax"][2].splitlines()
                      if ln.startswith("INFO: loaded")]
    assert loaded == [f"INFO: loaded 4 salts from {group['salting_dir']}"]


def test_ivsweep(group, tmp_path, capsys):
    common = ["--processing_setup", group["sweep_setup"], "--enable-ivsweep",
              "--output-series-name", OUT_SERIES, "--quiet"]
    root = group["root"]
    outs = run_both(capsys, ["--raw_path", str(root / "sweep_hdf5")] + common,
                    ["--raw_path", str(root / "sweep_flat")] + common,
                    str(tmp_path))
    compare_outputs(outs, [])
    path = os.path.join("ivsweep", f"ivsweep_{OUT_SERIES}.hdf5")
    ref = FilterData(verbose=False).load(os.path.join(
        outs["jax"][1], path)).get_ivsweep_data("chan1")
    got = FilterData(verbose=False).load(os.path.join(
        outs["port"][1], path)).get_ivsweep_data("chan1")
    assert list(got["state"]) == list(ref["state"]) == (
        ["normal"] * 3 + ["transition"] * 2 + ["sc"] * 3)
    for key in ("tes_bias", "offset_noise", "offset_didv", "psd", "didv",
                "avgtrace_noise", "didv_weights"):
        for g, r in zip(got[key], ref[key]):
            np.testing.assert_allclose(g, r, rtol=1e-9,
                                       atol=1e-9 * np.max(np.abs(r)),
                                       err_msg=key)


def test_no_triggers(group, tmp_path, capsys):
    """A trigger run that finds nothing: both chains end with rc 0 and
    write the job summaries only, the feature shell given an empty
    trigger table."""
    from detprocess_tpu_torch.config.yamlconfig import load_yaml

    setup = load_yaml(group["setup"])
    setup["trigger"]["chan1"]["threshold_sigma"] = 1e6
    path = write_json_setup(setup, str(tmp_path / "silent.json"))
    common = ["--raw_path", group["raw"], "--processing_setup", path,
              "--enable-trig", "--enable-feature", "--output-series-name",
              OUT_SERIES, "--quiet"]
    outs = run_both(capsys, common, common, str(tmp_path / "out"))
    assert outs["jax"][0] == outs["port"][0] == 0
    assert files_of(outs["port"][1]) == files_of(outs["jax"][1]) == [
        f"feature/feature_features_{OUT_SERIES}_summary.json",
        f"trigger/threshtrig_trigger_{OUT_SERIES}_summary.json"]
    for name in ("jax", "port"):
        assert "INFO: 0 triggers written to" in outs[name][2]


@pytest.mark.parametrize("case", ["missing_raw", "no_trigger_dataframes",
                                  "no_salting_dataframe"])
def test_refusals_match(group, tmp_path, capsys, case):
    if case == "missing_raw":
        common = ["--raw_path", str(tmp_path / "nothing"), "--enable-trig"]
    elif case == "no_trigger_dataframes":
        common = ["--raw_path", group["raw"], "--processing_setup",
                  group["setup"], "--enable-feature",
                  "--trigger_dataframe_path", group["trigger_dir"],
                  "--trigger_series", "I9_D20990101_T000000"]
    else:
        common = ["--raw_path", group["raw"], "--processing_setup",
                  group["setup"], "--enable-trig",
                  "--salting_dataframe_path", str(tmp_path / "none")]
    outs = run_both(capsys, common, common, str(tmp_path / "out"))
    assert outs["jax"][0] == outs["port"][0] == 1
    errors = lines_of(outs["port"][2])
    assert errors == lines_of(outs["jax"][2]) and len(errors) == 1
    assert glob.glob(str(tmp_path / "out" / "*" / "*" / "*")) == []


def test_mesh_devices_refused_naming_item_7(group, tmp_path, capsys):
    rc = cli.main(["--raw_path", group["raw"], "--processing_setup",
                   group["setup"], "--enable-trig", "--mesh-devices", "2",
                   "--device", "cpu", "--output_group_path",
                   str(tmp_path / "o")])
    assert rc == 1
    assert "ROADMAP.md §1 item 7" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o")
    # one device is no mesh: the run goes on
    assert cli.main(["--raw_path", group["raw"], "--processing_setup",
                     group["setup"], "--enable-trig", "--mesh-devices", "1",
                     "--device", "cpu", "--quiet", "--output_group_path",
                     str(tmp_path / "o")]) == 0


def test_prewarm_saves_nothing(group, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DETPROC_TPU_COMPILE_CACHE", "0")
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--enable-rand", "--calc-filter",
              "--enable-trig", "--enable-feature", "--prewarm",
              "--random_rate", "10"]
    outs = run_both(capsys, common, common, str(tmp_path))
    assert outs["jax"][0] == outs["port"][0] == 0
    assert files_of(outs["jax"][1]) == files_of(outs["port"][1]) == []
    notice = lines_of(outs["port"][2])
    assert notice == lines_of(outs["jax"][2]) == [
        "INFO: prewarm skips --enable-rand, --calc-filter (host-side "
        "workloads with nothing to compile; they would write real "
        "outputs)"]
    assert "kernel build directory:" in outs["port"][2]
    for name in ("jax", "port"):
        assert "triggers computed (prewarm: not saved)" in outs[name][2]
