"""The port's spans and read counters (``utils/logging.StageTimer``, the
shells' ``stats``) on the CPU.

- ``StageTimer`` loses no update when several threads add to it;
- a ``FeatureProcessing`` run with two reader threads and a
  ``TriggerProcessing`` run report every span the shells place, and leave
  their tables bit-equal to a run without a timer;
- ``stats["read_bytes"]`` and ``stats["read_calls"]``, which the shells'
  reader (``io/batchread.BatchReader``) counts at each read, are the
  bytes of the channels read and the ``os.preadv`` calls that read them,
  as counted at the call
  (in both shells one a run of back-to-back events: ``read_runs``,
  ``run_events``);
- in residual mode the trigger shell times the residual pass's host read
  (``residual.index_read``) and the drain's combine (``drain.combine``),
  and counts in ``stats`` the residual-pass triggers its table holds and
  the first-pass triggers the saturation veto kept out of the
  subtraction; in base mode neither span is placed and both counts
  stay 0;
- with the profiler off no ``record_function`` is entered;
- under ``device_trace(dir, timer=...)`` the exported trace holds the
  reader threads' ``read.fill`` spans on their own threads, each chunk's
  fill ending before its batch's ``stage.dispatch`` begins.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from detprocess_tpu_torch import entry as E
from detprocess_tpu_torch.pipelines import trigger_step
from detprocess_tpu_torch.pipelines.feature_group import layer_name
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
from detprocess_tpu_torch.utils import logging as tlogging
from detprocess_tpu_torch.utils.logging import StageTimer, device_trace

torch.set_num_threads(1)

N, PRETRIG = 4096, 2048            # feature traces
NEVENTS, BATCH = 24, 4             # 6 batches, 3 a reader thread
LENGTH, TEVENTS, TBATCH = 400000, 6, 2     # continuous events

FEATURE_SPANS = {"read", "dispatch", "drain", "read.fill", "read.ring_wait",
                 "upload.pin", "dispatch.upload", "dispatch.pack",
                 "drain.wait", "drain.host"}
TRIGGER_SPANS = {"read", "dispatch", "drain", "read.fill", "read.ring_wait",
                 "upload.pin", "dispatch.fill", "dispatch.enqueue",
                 "drain.wait", "drain.host"}
# what chan1's residual pass and edge exclusion add
RESIDUAL_SPANS = {"residual.index_read", "drain.combine"}
RESIDUAL_LAYERS = {"step." + name for name in trigger_step.LAYERS[5:]}
RESIDUAL_OPTIONS = ("run_residual", "saturation_amplitudes",
                    "edge_exclusion_msec")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    fdir = str(tmp_path_factory.mktemp("features"))
    paths, _, _ = E.write_shell_dumps(fdir, torch.Generator().manual_seed(3),
                                      NEVENTS, 2, "cpu", n=N, pretrig=PRETRIG)
    tdir = str(tmp_path_factory.mktemp("triggers"))
    tpaths, _ = E.write_trigger_dumps(tdir, torch.Generator().manual_seed(4),
                                      TEVENTS, 2, "cpu", LENGTH,
                                      ncoincident=8, nsingles=1)
    return dict(features=paths, triggers=tpaths)


def feature_shell(dumps):
    return FeatureProcessing(E.shell_index(dumps["features"], N, PRETRIG),
                             E.shell_config(N, PRETRIG),
                             E.shell_filter_data(N, PRETRIG), verbose=False,
                             device="cpu")


def trigger_shell(dumps):
    return TriggerProcessing(
        E.trigger_shell_index(dumps["triggers"], LENGTH),
        E.trigger_shell_config(),
        E.shell_filter_data(E.TRIGGER_NT, E.TRIGGER_PRETRIG), verbose=False,
        device="cpu")


def chan1_shell(dumps, drop):
    """The trigger shell with the options ``drop`` taken off chan1."""
    config = E.trigger_shell_config()
    for key in drop:
        del config["trigger"]["chan1"][key]
    return TriggerProcessing(
        E.trigger_shell_index(dumps["triggers"], LENGTH), config,
        E.shell_filter_data(E.TRIGGER_NT, E.TRIGGER_PRETRIG), verbose=False,
        device="cpu")


def chan1_triggers(table) -> dict:
    """{(dump, event): chan1's trigger indices} of a trigger table."""
    idx = np.asarray(table["trigger_index_chan1"], np.float64)
    out: dict = {}
    for d, e, i in zip(table["dump_number"], table["event_number"], idx):
        if np.isfinite(i):
            out.setdefault((int(d), int(e)), set()).add(int(i))
    return out


def run(shell, timer=None, nreaders=None):
    if isinstance(shell, FeatureProcessing):
        return shell.process(batch_size=BATCH, dtype=np.float32,
                             nreaders=nreaders or 2, timer=timer)
    # one batch read ahead: the third batch's read takes back the first's
    # buffer (``read.ring_wait``)
    return shell.process(event_batch=TBATCH, prefetch_depth=TBATCH,
                         nreaders=nreaders or 1, timer=timer)


def assert_bit_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
        elif a.dtype.kind == "O":          # strings, nan where none
            assert all(x == y or (x != x and y != y)
                       for x, y in zip(a, b)), k
        else:
            assert np.array_equal(a, b), k


def test_timer_loses_no_update_across_threads():
    timer = StageTimer()
    records = timer.start_records()
    go = threading.Barrier(8)

    def work():
        go.wait()
        for _ in range(1000):
            with timer.span("x"):
                pass
            timer.add_seconds("y", 1.0)
            timer.add_items("y", 1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    timer.stop_records()
    rep = timer.report(log=False)
    assert len(records) == 8000
    assert len({r[1] for r in records}) == 8
    assert rep["y"]["seconds"] == 8000.0 and rep["y"]["items"] == 8000
    spans = sum((r[3] - r[2]) * 1e-9 for r in records)
    assert rep["x"]["seconds"] == pytest.approx(spans, rel=1e-9)


def test_spans_nest_and_keep_their_parent_and_batch():
    timer = StageTimer()
    records = timer.start_records()
    with timer.stage("dispatch"):
        with timer.span("dispatch.fill", batch=3):
            pass
    timer.stop_records()
    with timer.stage("dispatch"):               # no record kept
        pass
    assert [(r[0], r[4], r[5]) for r in records] == [
        ("dispatch.fill", "stage.dispatch", 3), ("stage.dispatch", None, None)]
    rep = timer.report(log=False)
    assert set(rep) == {"dispatch", "dispatch.fill"}
    assert rep["dispatch"]["seconds"] >= rep["dispatch.fill"]["seconds"]


def test_feature_shell_reports_every_span_and_leaves_the_table(dumps):
    shell = feature_shell(dumps)
    want = run(shell)
    timer = StageTimer()
    got = run(shell, timer)
    assert_bit_equal(got, want)
    rep = {k: v["seconds"] for k, v in timer.report(log=False).items()}
    specs = {"spec.mix", "spec.rfft"} | {
        "spec." + layer_name(s) for g in shell.plan.groups for s in g.specs}
    assert FEATURE_SPANS | specs == set(rep)
    inside = sum(v for k, v in rep.items()
                 if k.startswith(("dispatch.", "spec.")))
    assert inside <= rep["dispatch"]
    assert rep["drain.wait"] + rep["drain.host"] <= rep["drain"]


def test_trigger_shell_reports_every_span_and_leaves_the_table(dumps):
    shell = trigger_shell(dumps)
    want = run(shell)
    timer = StageTimer()
    got = run(shell, timer)
    assert_bit_equal(got, want)
    rep = {k: v["seconds"] for k, v in timer.report(log=False).items()}
    steps = {k for k in rep if k.startswith("step.")}
    assert TRIGGER_SPANS | RESIDUAL_SPANS == set(rep) - steps
    # the entry's chan1 runs the residual pass: every layer of the step,
    # each named in ASCII for the profiler
    assert steps == {"step." + name.replace("Δχ²", "delta chi2")
                     for name in trigger_step.LAYERS}
    assert all(k.isascii() for k in rep)
    assert (rep["dispatch.fill"] + rep["dispatch.enqueue"]
            <= rep["dispatch"])
    assert sum(rep[k] for k in steps) <= rep["dispatch.enqueue"]
    assert rep["drain.wait"] + rep["drain.host"] <= rep["drain"]


def test_trigger_shell_counts_residual_and_vetoed_triggers(dumps):
    """chan1's residual-pass triggers in the table are those a run
    without the residual pass lacks, event by event; each event's
    saturating pulse is kept out of the subtraction."""
    shell, timer = trigger_shell(dumps), StageTimer()
    got = chan1_triggers(run(shell, timer))
    rep = timer.report(log=False)
    assert RESIDUAL_SPANS | RESIDUAL_LAYERS <= set(rep)
    first = chan1_shell(dumps, ["run_residual"])
    want = chan1_triggers(run(first))
    assert first.stats["residual_triggers"] == 0
    assert first.stats["vetoed_triggers"] == 0
    assert set(want) <= set(got)
    added = 0
    for key, idx in got.items():
        assert want.get(key, set()) <= idx, key
        added += len(idx) - len(want.get(key, ()))
    assert shell.stats["residual_triggers"] == added > 0
    assert shell.stats["vetoed_triggers"] >= TEVENTS


def test_base_mode_places_no_residual_span_and_counts_nothing(dumps):
    shell, timer = chan1_shell(dumps, RESIDUAL_OPTIONS), StageTimer()
    run(shell, timer)
    rep = timer.report(log=False)
    assert not (RESIDUAL_SPANS | RESIDUAL_LAYERS) & set(rep)
    assert TRIGGER_SPANS <= set(rep)
    assert shell.stats["residual_triggers"] == 0
    assert shell.stats["vetoed_triggers"] == 0


@pytest.fixture
def preadv_calls(monkeypatch):
    """[calls, bytes] of every ``os.preadv``, from any thread."""
    counts, lock = [0, 0], threading.Lock()
    real = os.preadv

    def counting(*args):
        n = real(*args)
        with lock:
            counts[0] += 1
            counts[1] += n
        return n

    monkeypatch.setattr(os, "preadv", counting)
    return counts


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_feature_shell_counts_its_reads(dumps, nreaders, preadv_calls):
    shell = feature_shell(dumps)
    run(shell, nreaders=nreaders)
    nchan = len(E.SHELL_CHANNELS)
    # every channel is read, and each batch's events lie back to back in
    # one of the 2 dumps of 12: one preadv a batch
    assert shell.stats["read_calls"] == NEVENTS // BATCH
    assert shell.stats["read_runs"] == NEVENTS // BATCH
    assert shell.stats["run_events"] == NEVENTS
    assert shell.stats["read_bytes"] == NEVENTS * nchan * N * 2
    assert [shell.stats["read_calls"],
            shell.stats["read_bytes"]] == preadv_calls
    assert shell.stats["read_bytes"] == shell.stats["upload_bytes"]
    assert shell.stats["pinned_bytes"] == 0          # nothing pinned here


@pytest.mark.parametrize("nreaders", [1, 2])
def test_trigger_shell_counts_its_reads(dumps, nreaders, preadv_calls):
    shell = trigger_shell(dumps)
    run(shell, nreaders=nreaders)
    nchan = len(E.SHELL_CHANNELS)
    # every channel is read: batches (0-1), (2 | 3), (4-5) of 2 dumps of 3,
    # one preadv a run of back-to-back events and one for each other event
    assert shell.stats["read_calls"] == 4
    assert shell.stats["read_runs"] == 2
    assert shell.stats["run_events"] == 4
    assert shell.stats["read_bytes"] == TEVENTS * nchan * LENGTH * 2
    assert [shell.stats["read_calls"],
            shell.stats["read_bytes"]] == preadv_calls
    assert shell.stats["read_bytes"] == shell.stats["upload_bytes"]
    assert shell.stats["pinned_bytes"] == 0


@pytest.fixture
def counted_record_function(monkeypatch):
    """torch.profiler.record_function, counting the names it is given."""
    names = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return names


def test_no_record_function_while_the_profiler_is_off(
        dumps, counted_record_function):
    run(feature_shell(dumps), StageTimer())
    run(trigger_shell(dumps), StageTimer())
    with tlogging.trace_span("fft.rfft.kernel"):
        pass
    assert counted_record_function == []
    timer = StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.stage("read"), timer.span("read.fill"):
            with tlogging.trace_span("fft.rfft.kernel"):
                pass
    assert [n for n in counted_record_function if "." in n] == [
        "stage.read", "read.fill", "fft.rfft.kernel"]


def test_device_trace_merges_the_reader_threads(dumps, tmp_path):
    shell = feature_shell(dumps)
    timer = StageTimer()
    with device_trace(str(tmp_path), timer=timer):
        run(shell, timer)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    main = threading.get_native_id()
    fills = sorted((e["args"]["batch"], e["ts"], e["ts"] + e["dur"],
                    e["tid"]) for e in events
                   if e.get("name") == "read.fill" and e.get("ph") == "X")
    dispatch = sorted(e["ts"] for e in events
                      if e.get("name") == "stage.dispatch"
                      and e.get("tid") == main and e.get("ph") == "X")
    nbatch = NEVENTS // BATCH
    assert [b for b, _, _, _ in fills] == list(range(nbatch))
    assert len(dispatch) == nbatch
    tids = {tid for _, _, _, tid in fills}
    assert len(tids) == 2 and main not in tids
    named = {e["tid"] for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name"}
    assert tids <= named
    for (_, _, end, _), start in zip(fills, dispatch):
        assert end < start
    assert sum(e.get("name") == tlogging.ANCHOR for e in events) == 1
