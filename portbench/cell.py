"""One run of one cell: make the data from the seed, build the shell,
warm it up, time passes over the data for the window, check what they
returned against the reference, and say so in one JSON line.

The cell, its configuration, its traffic mix, its limits and its
per-layer metrics are found by name: ``BENCHMARK.json``'s ``workloads``
entry, ``configs/<file>``, ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import checks
import gen
from profile_trace import PASS_SPAN, Trace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "detprocess_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, bench: dict, name: str, root: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        repo = os.path.dirname(root)
        entry = next(c for c in bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config = load_json(os.path.join(repo, entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(root, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.root = root


def reader(root: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    mdir = os.path.join(root, "metrics")
    if mdir not in sys.path:
        sys.path.insert(0, mdir)
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"),
        os.path.join(mdir, metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def file_positions(paths: list, config: dict):
    """(dump number, event number) of each event position, in file
    order."""
    block = len(config["channels"]) * config["nb_samples"] * 2
    out = []
    for k, p in enumerate(paths):
        for e in range(os.path.getsize(p) // block):
            out.append((k + 1, e + 1))
    return np.asarray(out, np.int64)


def row_positions(table: dict, per_dump: np.ndarray) -> np.ndarray:
    """Each returned row's event position (dump, then event)."""
    starts = np.concatenate([[0], np.cumsum(per_dump)])
    dump = np.asarray(table["dump_number"], np.int64)
    return starts[dump - 1] + np.asarray(table["event_number"], np.int64) - 1


def sample(rng, passes: int, count: int, size: int):
    """``size`` (pass, position) pairs drawn from the window's answers."""
    flat = rng.choice(passes * count, size=min(size, passes * count),
                      replace=False)
    return sorted((int(f // count), int(f % count)) for f in flat)


def check_features(cell, tables, paths, seed, device):
    """The numbers of a sample of the window's feature rows."""
    config, traffic = cell.config, cell.traffic
    where = file_positions(paths, config)
    pairs = sample(np.random.default_rng(seed), len(tables), len(where),
                   traffic["check_rows"])
    got = {}
    for p, pos in pairs:
        table = tables[p]
        rows = np.flatnonzero((np.asarray(table["dump_number"]) ==
                               where[pos, 0])
                              & (np.asarray(table["event_number"]) ==
                                 where[pos, 1]))
        for col, v in table.items():
            if np.asarray(v).dtype.kind != "f":
                continue
            got.setdefault(col, []).append(
                float(v[rows[0]]) if len(rows) == 1 else math.nan)
    got = {k: np.asarray(v) for k, v in got.items()}
    positions = [pos for _, pos in pairs]
    return feature_numbers(cell, got, gen.read_events(paths, config,
                                                      positions), device)


def feature_numbers(cell, got, codes, device):
    from reference import features
    ref = features.features(codes, cell.config, cell.traffic, device,
                            given=got)
    return checks.feature_numbers(got, ref)


def check_triggers(cell, tables, paths, seed, device):
    """The numbers of a sample of the window's events' trigger rows."""
    from reference import triggers
    config, traffic = cell.config, cell.traffic
    where = file_positions(paths, config)
    per_dump = np.bincount(where[:, 0] - 1)
    pairs = sample(np.random.default_rng(seed), len(tables), len(where),
                   traffic["check_events"])
    chans = [c for c, _, _ in triggers.trigger_channels(config)]
    parts = []
    for p, pos in pairs:
        table = tables[p]
        sel = (row_positions(table, per_dump) == pos
               if len(table.get("trigger_index", ())) else np.zeros(0, bool))
        found, rows = checks.table_event(table, sel, chans)
        codes = gen.read_events(paths, config, [pos])[0]
        parts.append(event_numbers(config, found, rows, codes, device))
    return checks.combine(parts)


def event_numbers(config, found, rows, codes, device):
    from reference import triggers
    ref_found, ref_rows, series = triggers.event_triggers(codes, config,
                                                          device)
    thr = {name: float(kw.get("threshold_sigma", 5.0)) ** 2
           for name, _, kw in triggers.trigger_channels(config)}
    return checks.trigger_numbers(found, rows, ref_found, ref_rows, series,
                                  thr)


def check(cell, tables, paths, seed, device):
    if cell.traffic["shell"] == "features":
        return check_features(cell, tables, paths, seed, device)
    return check_triggers(cell, tables, paths, seed, device)


def span_timer():
    """The shells' StageTimer, each stage also a profiler span
    ``stage.<name>``, so that the trace says what the host was doing."""
    from detprocess_tpu_torch.utils.logging import StageTimer

    class SpanTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name):
            with torch.profiler.record_function(f"stage.{name}"), \
                    super().stage(name):
                yield

    return SpanTimer()


def window(program, seconds, trace_path=None):
    """Passes back to back until ``seconds`` have passed: (units, tables,
    seconds, events attempted, events done, StageTimer report, batches),
    under torch.profiler when ``trace_path`` is given (its Chrome trace
    written there)."""
    timer = span_timer()
    tables, units, attempted, done = [], 0, 0, 0
    batches0 = program.batches
    events = program.traffic["events"]
    prof = None
    if trace_path is not None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    ends = []
    try:
        while True:
            with torch.profiler.record_function(PASS_SPAN):
                table, n = program.run_pass(timer)
            ends.append(time.perf_counter())
            units += n
            attempted += events
            done += (len(table["event_number"])
                     if program.kind == "features"
                     else int(program.shell.stats["events"]))
            tables.append(table)
            if time.perf_counter() - t0 >= seconds:
                break
    finally:
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace_path)
    stages = {k: v["seconds"] for k, v in timer.report(log=False).items()}
    return dict(units=units, tables=tables, seconds=elapsed,
                attempted=attempted, done=done, stages=stages,
                batches=program.batches - batches0,
                pass_s=np.diff([t0] + ends))


def end_to_end(name: str, win: dict, setup_s: float) -> float:
    if name == "setup_s":
        return setup_s
    if name == "events_per_s":
        return win["units"] / win["seconds"]
    if name == "msamples_per_s":
        return win["units"] / 1e6 / win["seconds"]
    raise KeyError(f"no end-to-end metric {name!r}")


def device_info(device) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        return _run(cell, seed, seconds, traced, device, t_start, tmp, log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, traced, device, t_start, tmp, log):
    from shells import Program
    marks = [time.perf_counter()]
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    marks.append(time.perf_counter())
    paths = gen.write_dumps(tmp, cell.config, cell.traffic, seed, device)
    marks.append(time.perf_counter())
    program = Program(cell.config, cell.traffic, paths, device)
    marks.append(time.perf_counter())
    program.run_pass()                                   # warm-up
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_start
    parts = np.diff([t_start] + marks)
    log(f"set-up {setup_s:.3f} s: imports {parts[0]:.3f}, device "
        f"{parts[1]:.3f}, data {parts[2]:.3f}, shell {parts[3]:.3f}, "
        f"warm-up pass {parts[4]:.3f}")
    card = device_info(device)["kind"]
    ctx = None
    if traced:
        # the stage metrics from an untraced first half, the trace's from
        # a second half under the profiler
        first = window(program, seconds / 2)
        path = os.path.join(tmp, "trace.json")
        second = window(program, seconds / 2, path)
        tr = Trace(path)
        os.remove(path)
        win = {"tables": first["tables"] + second["tables"]}
        ctx = dict(stages=first["stages"], stage_window_s=first["seconds"],
                   stage_batches=first["batches"], trace=tr,
                   trace_batches=second["batches"], traffic=cell.traffic,
                   config=cell.config, card=card)
        attempted = first["attempted"] + second["attempted"]
        done = first["done"] + second["done"]
    else:
        win = window(program, seconds)
        attempted, done = win["attempted"], win["done"]
        ps = win["pass_s"]
        log(f"window {win['seconds']:.3f} s, {len(ps)} passes of "
            f"{ps.min():.4f}-{np.median(ps):.4f}-{ps.max():.4f} s")
    info = device_info(device)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the process holds {', '.join(bad)} once the "
                         "window has closed")
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(cell, win["tables"], paths, seed, device)
    correct, lines = checks.judge(numbers, cell.limits)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = reader(cell.root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], win,
                                                      setup_s),
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(attempted - done), "metrics": metrics,
              "device": info}
    if traced:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {name: {"value": value, "limit": lim}
                        for name, value, lim in lines}
    return result
