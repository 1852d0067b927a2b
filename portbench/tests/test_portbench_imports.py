"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: ``detprocess_tpu_torch`` is not ``detprocess_tpu``)."""

import ast
import os

from conftest import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "detprocess_tpu"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: imported(p) & FORBIDDEN for p in sources(BENCH_DIR)}
    assert not {p: s for p, s in found.items() if s}


def test_reference_stands_alone():
    ref = os.path.join(BENCH_DIR, "reference")
    allowed = {"__future__", "math", "numpy", "torch", "reference"}
    for p in sources(ref):
        assert imported(p) <= allowed, p


def test_run_refuses_a_process_holding_jax(small_cell, monkeypatch):
    """A run whose process holds JAX once the window has closed prints
    no result: it exits, naming what it found."""
    import sys
    import time
    import types

    import pytest

    import cell as cellmod
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        cellmod.run(small_cell("events.example"), 3, 0.01, False, "cpu",
                    time.perf_counter(), log=lambda m: None)
