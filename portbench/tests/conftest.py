"""Shared fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``). They run on the CPU: the port with its plain twins at
small sizes. Tests marked ``card`` need an NVIDIA GPU and skip without
one."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# sizes a CPU test run holds: the traffic's counts cut, every width and
# the configurations as they are
SMALL = {
    "features": dict(events=32, files=2, chunk=16, batch=16, check_rows=32),
    "triggers": dict(events=4, files=2, chunk=2, event_batch=2,
                     check_events=4),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")
    # several test workers share the cores: a worker's own thread pool
    # of one thread a core each would oversubscribe them many times over
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 4))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def copy_bench(tmp_path):
    """The benchmark's files, without its tests, under ``tmp_path``."""
    root = tmp_path / "portbench"
    if not root.exists():
        shutil.copytree(BENCH_DIR, root, ignore=shutil.ignore_patterns(
            "__pycache__", "tests"))
    return root


@pytest.fixture
def small_cell(tmp_path):
    """make(name) → the cell ``name`` from a copy of the benchmark's files
    under ``tmp_path`` whose traffic is cut to :data:`SMALL`."""
    import cell as cellmod

    def make(name):
        root = copy_bench(tmp_path)
        bench = load_bench()
        work = next(w for w in bench["workloads"] if w["name"] == name)
        path = root / "traffic" / (work["traffic"] + ".json")
        traffic = json.loads(path.read_text())
        traffic.update(SMALL[traffic["shell"]])
        path.write_text(json.dumps(traffic))
        return cellmod.Cell(bench, name, root=str(root))
    return make


@pytest.fixture
def coverage_cell(tmp_path):
    """A cell of every feature algorithm that the reference knows, at
    :data:`SMALL` sizes, from ``tests/data``: four channels at N = 32768,
    of1x2x2, ofnxm with a cross-spectrum, ofnxmx2, psd_amp, psd_peaks,
    phase and rftau. No workload runs these algorithms yet; this keeps
    their reference held to the port."""
    import cell as cellmod
    root = copy_bench(tmp_path)
    data = os.path.join(HERE, "data")
    shutil.copy(os.path.join(data, "coverage_config.json"),
                root / "configs" / "coverage.json")
    traffic = json.loads(open(os.path.join(data, "coverage_traffic.json"))
                         .read())
    traffic.update(SMALL["features"])
    (root / "traffic" / "coverage.json").write_text(json.dumps(traffic))
    (root / "limits" / "coverage.json").write_text("{}")
    bench = load_bench()
    bench["configs"].append({"name": "coverage",
                             "file": "portbench/configs/coverage.json"})
    bench["workloads"].append({"name": "coverage", "config": "coverage",
                               "traffic": "coverage", "chips": 1})
    return cellmod.Cell(bench, "coverage", root=str(root))
