"""A cell that a later change adds as files alone: a configuration, a
traffic mix and limits in a directory of their own, named in the
benchmark's JSON, found and run by name with no code changed."""

import json
import shutil
import time

import cell as cellmod
from conftest import BENCH_DIR, load_bench


def test_new_cell_from_files_alone(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    # the example's detector at N = 16384, its own traffic and limits
    config = json.loads((root / "configs" / "example_feature.json")
                        .read_text())
    config.update(nb_samples=16384, nb_pretrigger_samples=8192)
    config["pulse"]["tau_f_s"] = [2e-4, 2.5e-4]
    (root / "configs" / "two_n16384.json").write_text(json.dumps(config))
    traffic = {
        "shell": "features", "events": 24, "files": 2, "chunk": 12,
        "batch": 12, "readers": 2, "check_rows": 24,
        "pulses": [{"channels": ["Mv2301", "Mv2302"],
                    "amplitude_a": [1e-6, 3e-6], "shift_samples": 20}],
        "processing": {"feature": {"Mv2301,Mv2302": {
            "of1x1_nodelay": {"run": True},
            "of1x1_constrained": {"run": True,
                                  "window_min_from_trig_usec": -50.0,
                                  "window_max_from_trig_usec": 50.0},
            "maximum": {"run": True}}}},
        "transforms": {"rfft": [[2, 12, 16384]],
                       "fused_nodelay_of": [[2, 12, 16384, 1]]}}
    (root / "traffic" / "two_of1x1.json").write_text(json.dumps(traffic))
    limits = json.loads((root / "limits" / "events.example.json").read_text())
    (root / "limits" / "two.of1x1.json").write_text(json.dumps(limits))

    bench = load_bench()
    bench["configs"].append({"name": "two_n16384",
                             "source": "https://example.org/two-channel",
                             "file": "portbench/configs/two_n16384.json",
                             "reduced": ["nb_samples", "nb_pretrigger_samples", "pulse"],
                             "why": "a configuration made of files"})
    bench["workloads"].append({"name": "two.of1x1", "config": "two_n16384",
                               "traffic": "two_of1x1", "chips": 1,
                               "why": "a cell made of files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "events.example" in m.get("workloads", []):
            m["workloads"].append("two.of1x1")
    cell = cellmod.Cell(bench, "two.of1x1", root=str(root))
    assert cell.config["nb_samples"] == 16384
    assert [m["name"] for m in cell.end_to_end] == ["events_per_s",
                                                    "setup_s"]
    result = cellmod.run(cell, 7, 0.01, False, "cpu", time.perf_counter(),
                         log=lambda m: None)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"events_per_s", "setup_s"}
    traced = cellmod.run(cell, 8, 0.02, True, "cpu", time.perf_counter(),
                         log=lambda m: None)
    assert traced["correct"]
    assert "read_wait_pct.events" in traced["metrics"]
    assert traced["device"]["window_s"] > 0
