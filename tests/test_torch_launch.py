"""The multi-node launcher of the port (``python -m
detprocess_tpu_torch.launch``) against the JAX package's.

- The series split and the node's output series number equal
  ``detprocess_tpu.parallel.multihost``'s.
- Two nodes (two ``launch.main`` calls on the CPU, as
  tests/test_distributed_e2e.py runs two processes of
  scripts/process_distributed.py) write node-unique series whose trigger
  and feature rows are the single run's rows.
- The two faults of scripts/process_distributed.py are not copied: the
  node arguments are taken out by their exact flags only, and a
  malformed ``DETPROC_TPU_BASE_SERIES`` is refused by name.
"""

import os

import numpy as np
import pytest
import torch

from detprocess_tpu.parallel import multihost as jmultihost
from detprocess_tpu_torch import cli, launch
from detprocess_tpu_torch.config.yamlconfig import write_json_setup
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import write_flat_series
from detprocess_tpu_torch.models.pulse import make_template
from detprocess_tpu_torch.parallel import multihost

torch.set_num_threads(1)

FS = 1.25e6
NT, PRE, L = 1024, 256, 60000
SERIES = ["I1_D20260820_T100000", "I1_D20260820_T110000",
          "I1_D20260820_T120000"]


@pytest.mark.parametrize("nodes", [1, 2, 3, 4, 7])
def test_series_split_equals_jax(nodes):
    series = [f"I1_D20260101_T{k:06d}" for k in range(5)]
    for node in range(nodes):
        assert (multihost.split_series_for_host(series, node, nodes)
                == jmultihost.split_series_for_host(series, node, nodes))
        assert (multihost.output_series_num_for_host(100, node)
                == jmultihost.output_series_num_for_host(100, node))


def test_split_defaults_come_from_slurm(monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "1")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    series = ["a", "b", "c"]
    assert (multihost.split_series_for_host(series)
            == jmultihost.split_series_for_host(series) == ["c"])
    assert multihost.output_series_num_for_host(10) == 11


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = tmp_path_factory.mktemp("launch")
    rng = np.random.default_rng(12)
    tmpl = make_template(FS, NT, PRE, A=1.0, tau_r=20e-6, tau_f1=200e-6)
    sigma, cal = 2e-6, 1e-8
    for k, series in enumerate(SERIES):
        traces = rng.standard_normal((2, 1, L)) * sigma
        for ev in range(2):
            pos = 15000 + 20000 * ev + 3000 * k
            traces[ev, 0, pos - PRE:pos - PRE + NT] += 40e-6 * tmpl
        write_flat_series(str(root / "raw"), "cont", series,
                          [np.round(traces / cal).astype(np.int16)],
                          ["chan1"], FS, adc_conversion_factor=cal)
    fd = FilterData(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRE)
    fd.set_psd("chan1", np.full(NT, sigma ** 2 / FS), FS)
    fpath = str(root / "filter.npz")
    fd.save_npz(fpath)
    setup = write_json_setup({
        "filter_file": fpath,
        "trigger": {"chan1": {"run": True, "threshold_sigma": 8.0,
                              "pileup_window_msec": 0.5}},
        "feature": {"trace_length_samples": NT,
                    "pretrigger_length_samples": PRE,
                    "chan1": {"of1x1_nodelay": {"run": True},
                              "baseline": {"run": True}}}},
        str(root / "process.json"))
    return {"root": root, "raw": str(root / "raw"), "setup": setup}


def rows(out, sub):
    """The union of a workload's dumps, sorted by series, event, index."""
    d = os.path.join(out, sub)
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    t = tables.concat_tables([tables.read_table(os.path.join(d, f))
                              for f in files])
    t.pop("trigger_prod_id", None)
    order = np.lexsort((t["trigger_index"], t["event_number"],
                        t["series_number"]))
    return files, {k: np.asarray(v)[order] for k, v in t.items()}


def test_two_nodes_give_the_single_run(group, tmp_path, monkeypatch):
    common = ["--raw_path", group["raw"], "--processing_setup",
              group["setup"], "--enable-trig", "--enable-feature",
              "--output-format", "npz", "--device", "cpu", "--quiet"]
    monkeypatch.setenv("DETPROC_TPU_BASE_SERIES", "I1_D20260820_T270000")
    dist = str(tmp_path / "dist")
    for node in (1, 0):
        assert launch.main(common + ["--output_group_path", dist,
                                     "--node_num", str(node),
                                     "--nb_nodes", "2"]) == 0
    single = str(tmp_path / "single")
    assert cli.main(common + ["--output_group_path", single]) == 0
    for sub in ("trigger", "feature"):
        files, got = rows(dist, sub)
        _, ref = rows(single, sub)
        # node-unique output series: the job's base plus the node number
        assert [f.split("_I")[1].split("_F")[0] for f in files] == [
            "1_D20260820_T270000", "1_D20260820_T270001"], files
        assert sorted(got) == sorted(ref)
        assert len(ref["event_number"]) == 6
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_node_arguments_are_stripped_by_exact_flag():
    argv = ["--node_num", "1", "--raw_path", "/r", "--nb_nodes=2",
            "--node_numbers", "7", "--processing_id", "--nb_nodes_x"]
    assert launch.strip_node_args(argv) == [
        "--raw_path", "/r", "--node_numbers", "7", "--processing_id",
        "--nb_nodes_x"]
    assert launch.strip_node_args(["--nb_nodes", "-1", "-s", "a"]) == [
        "-s", "a"]


def test_abbreviated_node_flag_is_not_taken(group, tmp_path):
    """The launcher takes no abbreviation: ``--node 1`` is not
    ``--node_num 1``, and the command line refuses it by name."""
    with pytest.raises(SystemExit):
        launch.main(["--raw_path", group["raw"], "--node", "1",
                     "--nb_nodes", "2", "--enable-trig", "--device", "cpu",
                     "--output_group_path", str(tmp_path / "o")])


@pytest.mark.parametrize("base", ["20260820_270000", "I1_D2026_T1",
                                  "garbage", "I1_D20260820_T270000_extra"])
def test_malformed_base_series_is_refused_by_name(group, tmp_path,
                                                  monkeypatch, capsys, base):
    monkeypatch.setenv("DETPROC_TPU_BASE_SERIES", base)
    rc = launch.main(["--raw_path", group["raw"], "--processing_setup",
                      group["setup"], "--enable-trig", "--device", "cpu",
                      "--output_group_path", str(tmp_path / "o"),
                      "--node_num", "0", "--nb_nodes", "2"])
    assert rc == 1
    out = capsys.readouterr().out
    assert (f"ERROR: DETPROC_TPU_BASE_SERIES={base!r} is not a series name "
            "I{fac}_D{yyyymmdd}_T{hhmmss}") in out
    assert not os.path.exists(tmp_path / "o")


def test_base_series_takes_this_runs_facility(group, tmp_path, monkeypatch):
    monkeypatch.setenv("DETPROC_TPU_BASE_SERIES", "I1_D20260820_T270000")
    out = str(tmp_path / "o")
    assert launch.main(["--raw_path", group["raw"], "--processing_setup",
                        group["setup"], "--enable-trig", "--device", "cpu",
                        "--output-format", "npz", "--facility", "3",
                        "--output_group_path", out, "--node_num", "1",
                        "--nb_nodes", "3", "--quiet"]) == 0
    assert [f for f in os.listdir(os.path.join(out, "trigger"))
            if f.endswith(".npz")] == [
        "threshtrig_trigger_I3_D20260820_T270001_F0001.npz"]
