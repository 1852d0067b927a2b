"""One short run of each cell on the card, through the benchmark's
command: its last line keeps to the result format and ``correct`` is
true."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load_bench


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in load_bench()
                                  ["workloads"]])
def test_cell_runs_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), "--workload",
         name, "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
