"""The feature shell's reads of back-to-back events (``RawIndex.runs``,
through ``io/batchread.BatchReader``): in a full-trace batch read in the
stored dtype, every run of two or more whole events that lie back to back
in one file is one ``os.preadv`` straight into its rows of the batch
buffer.

Each case runs the shell twice, as it is and with every row read on its
own (``RawIndex.runs`` returning no run: the reader's per-event branch),
and checks:

- every filled batch buffer, byte for byte, against the stored codes
  (``np.fromfile`` at each event's offset, h5py for an ``H5Dataset``)
  and against the per-event path's buffer;
- the tables, bit for bit, against the per-event path's;
- the ``os.preadv`` calls: one a run plus those of the rows read one by
  one, with the runs found here by a plain loop over the batch's rows;
  ``stats["read_calls"]``, ``read_runs`` and ``run_events`` agree.

The fallbacks (a channel subset, float64, a host injector, trigger-table
windows, ``H5Dataset`` entries) take no run and issue the per-event
path's calls. h5py's contiguous datasets are ``FastDataset`` entries and
read in runs wherever they lie back to back.
"""

import os
import threading

import numpy as np
import pytest
import torch

from detprocess_tpu_torch import entry as E
from detprocess_tpu_torch.io.batchread import BatchReader
from detprocess_tpu_torch.io.fastio import FastDataset, H5Dataset
from detprocess_tpu_torch.io.rawdata import RawIndex, series_to_number
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from test_torch_tracing import assert_bit_equal

torch.set_num_threads(1)

N, PRETRIG = 1024, 512             # raw traces
WN, WPRE = 256, 128                # trigger-table windows
NEVENTS, NFILES, BATCH = 10, 2, 4  # dumps of 5: batch 1 spans both


def config(channels=E.SHELL_CHANNELS, n=N, pretrig=PRETRIG):
    return {"feature": {
        "trace_length_samples": n, "pretrigger_length_samples": pretrig,
        ",".join(channels): {"of1x1_nodelay": {"run": True},
                             "baseline": {"run": True}}}}


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    paths, _, _ = E.write_shell_dumps(
        str(tmp_path_factory.mktemp("runs")),
        torch.Generator().manual_seed(11), NEVENTS, NFILES, "cpu", n=N,
        pretrig=PRETRIG)
    return paths


def _twin(src, dst, chunked):
    """A copy of the pytesdaq file ``src``, its ``event_*`` datasets
    chunked (``H5Dataset`` entries) or contiguous."""
    import h5py

    def copy(gi, go):
        go.attrs.update(dict(gi.attrs))
        for name, obj in gi.items():
            if isinstance(obj, h5py.Group):
                copy(obj, go.create_group(name))
            elif name.startswith("event_"):
                ds = go.create_dataset(
                    name, data=obj[...],
                    chunks=(1, 256) if chunked else None)
                ds.attrs.update(dict(obj.attrs))
            else:
                gi.copy(obj, go, name)

    with h5py.File(src, "r") as fi, h5py.File(dst, "w") as fo:
        copy(fi, fo)


@pytest.fixture(scope="module")
def hdf5(flat, tmp_path_factory):
    """Two pytesdaq dumps of the flat dumps' events: the first
    contiguous, the second chunked."""
    pytest.importorskip("h5py")
    from detprocess_tpu_torch.io.rawdata import RawWriter

    root = tmp_path_factory.mktemp("runs_h5")
    codes = np.stack([read_stored(ds) for ds in
                      E.shell_index(flat, N, PRETRIG).datasets])
    conv = E.shell_conv()
    w = RawWriter(str(root / "plain"), E.SHELL_SERIES, E.FS,
                  E.SHELL_CHANNELS, nb_pretrigger_samples=PRETRIG,
                  detector_config={c: {"close_loop_norm": cln} for c, cln
                                   in zip(E.SHELL_CHANNELS, E.SHELL_CLN)},
                  adc_conversion_factor=E.SHELL_CAL)
    per = NEVENTS // NFILES
    paths = []
    for d in range(NFILES):
        src = w.write_dump(codes[d * per:(d + 1) * per]
                           * conv[None, :, None], dump_num=d + 1)
        dst = str(root / os.path.basename(src))
        _twin(src, dst, chunked=d == 1)
        paths.append(dst)
    return paths


def read_stored(ds):
    """The stored codes of one event, from its file."""
    if isinstance(ds, H5Dataset):
        import h5py

        with h5py.File(ds.path, "r") as f:
            return f[ds.name][...]
    count = int(np.prod(ds.shape))
    return np.fromfile(ds.path, ds.dtype, count=count,
                       offset=ds.offset).reshape(ds.shape)


def plain_runs(index, rows, whole):
    """The runs of a batch by a loop over its rows: stretches of two or
    more whole-event ``FastDataset`` rows, each starting where the one
    before it ends in the same file."""
    if not whole:
        return []
    runs, a = [], 0
    for i in range(1, len(rows) + 1):
        if i < len(rows):
            p, q = index.datasets[rows[i - 1]], index.datasets[rows[i]]
            if (isinstance(p, FastDataset) and isinstance(q, FastDataset)
                    and (p.path, p.shape, p.dtype)
                    == (q.path, q.shape, q.dtype)
                    and q.offset == p.offset + int(np.prod(p.shape))
                    * p.dtype.itemsize):
                continue
        if i - a >= 2:
            runs.append((a, i))
        a = i
    return runs


@pytest.fixture
def recorded(monkeypatch):
    """Every batch buffer as filled (batch, rows, starts, copy) and the
    [calls, bytes] of every ``os.preadv``, from any thread."""
    rec = {"buffers": [], "preadv": [0, 0]}
    lock = threading.Lock()
    real_fill, real_preadv = BatchReader.fill, os.preadv

    def fill(self, ring, rows, starts=None, batch=None):
        out = real_fill(self, ring, rows, starts, batch)
        with lock:
            rec["buffers"].append((batch, np.array(rows),
                                   None if starts is None
                                   else np.array(starts),
                                   out[1][1][:len(rows)].copy()))
        return out

    def preadv(*args):
        n = real_preadv(*args)
        with lock:
            rec["preadv"][0] += 1
            rec["preadv"][1] += n
        return n

    monkeypatch.setattr(BatchReader, "fill", fill)
    monkeypatch.setattr(os, "preadv", preadv)
    return rec


def run(recorded, monkeypatch, make_shell, runs=True, **kw):
    """(table, stats, buffers by batch, preadv [calls, bytes]) of one
    ``process`` call; ``runs=False`` reads every row on its own."""
    recorded["buffers"].clear()
    recorded["preadv"][:] = [0, 0]
    with monkeypatch.context() as m:
        if not runs:
            m.setattr(RawIndex, "runs", lambda self, rows, whole, arr: [])
        shell = make_shell()
        table = shell.process(batch_size=BATCH, **kw)
    buffers = {b[0]: b[1:] for b in recorded["buffers"]}
    assert len(buffers) == len(recorded["buffers"])
    return table, dict(shell.stats), buffers, list(recorded["preadv"])


def expected_row(index, row, sel, start, dtype, raw, inject=None):
    """A batch row as the shell fills it: the stored codes of the
    channels read (a window of them), converted on the host unless
    ``raw``."""
    stored = read_stored(index.datasets[row])
    stored = stored if sel is None else stored[sel]
    if start is not None:
        stored = stored[:, start:start + WN]
    if raw:
        return stored
    f = index.files[int(index.file[row])]
    conv = f.conv if sel is None else f.conv[sel]
    if inject is not None:
        return inject(stored.astype(np.float64) * conv[:, None],
                      {"event_number": int(index.event_number[row])})
    return stored.astype(dtype) * conv[:, None].astype(dtype)


def check(recorded, monkeypatch, index_fn, cfg, *, sel=None, dtype=np.float32,
          nevents=-1, nreaders=1, trigger_table=None, injector=None,
          want_runs=True, window_fd=False):
    """Run the case both ways and hold it to the stored codes, the
    per-event path and the plain count of runs."""
    geom = (WN, WPRE) if window_fd else (N, PRETRIG)

    def make_shell():
        shell = FeatureProcessing(index_fn(), cfg,
                                  E.shell_filter_data(*geom),
                                  trigger_table=trigger_table,
                                  verbose=False, device="cpu")
        if injector is not None:
            shell.set_salting(injector)
        return shell

    kw = dict(dtype=dtype, nevents=nevents, nreaders=nreaders)
    table, stats, bufs, preadv = run(recorded, monkeypatch, make_shell, **kw)
    table0, stats0, bufs0, preadv0 = run(recorded, monkeypatch, make_shell,
                                         runs=False, **kw)
    index = index_fn()
    raw = dtype == np.float32 and injector is None
    assert_bit_equal(table, table0)
    assert sorted(bufs) == sorted(bufs0) and bufs
    nruns = nrun_events = calls = h5_calls = h5_bytes = 0
    per_row = 1 if sel is None else len(sel)
    for b, (rows, starts, arr) in bufs.items():
        rows0, starts0, arr0 = bufs0[b]
        assert np.array_equal(rows, rows0)
        assert arr.dtype == arr0.dtype
        assert np.array_equal(arr.view(np.uint8), arr0.view(np.uint8)), b
        for i, row in enumerate(rows):
            want = expected_row(index, int(row), sel,
                                None if starts is None else int(starts[i]),
                                dtype, raw, inject=injector)
            assert np.array_equal(arr[i].view(np.uint8),
                                  np.ascontiguousarray(want, arr.dtype)
                                  .view(np.uint8)), (b, i)
        runs = plain_runs(index, rows.tolist(),
                          sel is None and raw and starts is None)
        nruns += len(runs)
        nrun_events += sum(j - i for i, j in runs)
        for k, r in enumerate(rows.tolist()):
            if any(i <= k < j for i, j in runs):
                continue
            if isinstance(index.datasets[r], H5Dataset):
                h5_calls += per_row
                h5_bytes += arr[k].nbytes
            else:
                calls += per_row
    calls += nruns
    assert (nruns > 0) == want_runs
    assert [stats["read_runs"], stats["run_events"]] == [nruns, nrun_events]
    assert stats0["read_runs"] == stats0["run_events"] == 0
    if trigger_table is None:
        assert preadv[0] == calls
    # the per-event path's calls, less those the runs replace
    assert preadv[0] == preadv0[0] - nrun_events + nruns
    assert preadv[1] == preadv0[1]
    # h5py reads are counted as if each were one preadv
    for st, pr in ((stats, preadv), (stats0, preadv0)):
        assert [st["read_calls"], st["read_bytes"]] == [pr[0] + h5_calls,
                                                        pr[1] + h5_bytes]
    return stats


def flat_index(paths, order=None):
    def make():
        index = E.shell_index(paths, N, PRETRIG)
        if order is not None:
            index.order = np.asarray(order, np.int64)
        return index
    return make


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_batch_across_two_dumps_breaks_its_run(flat, recorded, monkeypatch,
                                               nreaders):
    stats = check(recorded, monkeypatch, flat_index(flat), config(),
                  nreaders=nreaders)
    # batches (0-3), (4 | 5-7), (8-9): row 4 ends dump 1, row 5 starts 2
    assert [stats["read_runs"], stats["run_events"]] == [3, 9]
    assert stats["read_calls"] == 4


def test_permuted_order(flat, recorded, monkeypatch):
    order = [0, 6, 7, 8, 1, 2, 3, 9, 5, 4]
    stats = check(recorded, monkeypatch, flat_index(flat, order), config())
    # 0 (6-8) | (1-3) 9 | 5 4; rows 0, 6 and 3, 9 sit at offsets that
    # follow on, in two files
    assert [stats["read_runs"], stats["run_events"]] == [2, 6]


def test_nevents_prefix(flat, recorded, monkeypatch):
    stats = check(recorded, monkeypatch, flat_index(flat), config(),
                  nevents=7)
    assert stats["events"] == 7
    # (0-3), 4 | (5-6)
    assert [stats["read_runs"], stats["run_events"]] == [2, 6]


def test_channel_subset_reads_each_row(flat, recorded, monkeypatch):
    check(recorded, monkeypatch, flat_index(flat),
          config(E.SHELL_CHANNELS[1:3]), sel=[1, 2], want_runs=False)


def test_float64_reads_each_event(flat, recorded, monkeypatch):
    check(recorded, monkeypatch, flat_index(flat), config(),
          dtype=np.float64, want_runs=False)


def test_host_injector_reads_each_event(flat, recorded, monkeypatch):
    def inject(traces, admin, window_start=0, channels=None):
        return traces + 1e-9 * admin["event_number"]

    check(recorded, monkeypatch, flat_index(flat), config(),
          injector=inject, want_runs=False)


def test_trigger_windows_read_as_before(flat, recorded, monkeypatch):
    # events 1-3 of each dump: one window, two (coalesced: 2 · 256 is
    # half the trace), one; a window each of event 5
    events = [1, 2, 2, 3, 5] * NFILES
    dumps = [1] * 5 + [2] * 5
    index = [200, 300, 700, 500, 850] * NFILES
    table = {"series_number": np.full(len(events),
                                      series_to_number(E.SHELL_SERIES)),
             "dump_number": np.asarray(dumps, np.int64),
             "event_number": np.asarray(events, np.int64),
             "trigger_index": np.asarray(index, np.int64)}
    for dtype in (np.float32, np.float64):
        check(recorded, monkeypatch, flat_index(flat), config(n=WN,
                                                              pretrig=WPRE),
              dtype=dtype, trigger_table=table, want_runs=False,
              window_fd=True, nreaders=2)


def test_hdf5_entries(hdf5, recorded, monkeypatch):
    def make():
        return RawIndex.from_pytesdaq(hdf5)

    index = make()
    per = NEVENTS // NFILES
    assert all(isinstance(d, FastDataset) for d in index.datasets[:per])
    assert all(isinstance(d, H5Dataset) for d in index.datasets[per:])
    # h5py lays the contiguous datasets of a dump mostly back to back, an
    # object header between some: those read in runs, the chunked ones
    # through h5py one by one
    check(recorded, monkeypatch, make, config())


def test_extents_of_an_index(flat):
    flat_index = E.shell_index(flat, N, PRETRIG)
    events = {k: getattr(flat_index, k) for k in RawIndex.EVENT_KEYS}
    last = flat_index.datasets[-1]
    events["datasets"] = flat_index.datasets[:-1] + [
        H5Dataset(last.path, "adc1/event_5", last.shape, last.dtype)]
    index = RawIndex(flat_index.files, events)
    key, offset, nbytes = index.extents()
    assert index.extents()[0] is key                   # built once
    block = len(E.SHELL_CHANNELS) * N * 2
    per = NEVENTS // NFILES
    assert np.array_equal(offset[:-1],
                          np.tile(np.arange(per) * block, NFILES)[:-1])
    assert offset[-1] == -1                             # H5Dataset
    assert (nbytes == block).all()
    assert np.array_equal(key, np.repeat(np.arange(NFILES), per))
