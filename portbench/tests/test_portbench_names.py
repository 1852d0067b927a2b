"""BENCHMARK.json keeps to its contract's forms: names, units, keys."""

import json
import os
import re

from conftest import BENCH_DIR, ROOT, load_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_names_and_units():
    bench = load_bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_finds_its_files():
    bench = load_bench()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        for sub in (("traffic", w["traffic"] + ".json"),
                    ("limits", w["name"] + ".json")):
            assert os.path.isfile(os.path.join(BENCH_DIR, *sub))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
