"""The trigger shell's reads (``io/batchread.BatchReader``, the feature
shell's reader): reader threads read each batch of ``event_batch``
events straight into a buffer of their own ring, in batch order: one
``os.preadv`` a run of back-to-back whole events in the buffer's dtype
(``RawIndex.runs``), one for each other event, one a channel row where
only some channels are read, h5py for an ``H5Dataset``.

Each case runs the shell on the CPU in float64 as it is and with every
event read on its own (``RawIndex.runs`` returning no run: the reader's
per-event branch), and checks:

- every filled buffer, byte for byte, against the stored values (read
  with ``np.fromfile`` or h5py; with a host injector, their salted
  float64 amps) and against the per-event branch's, and each row's
  conversion factors;
- the trigger table, row for row after sorting by (series, event,
  channel, index), bit for bit against the per-event branch's;
- the ``os.preadv`` calls and bytes against ``stats["read_calls"]`` and
  ``read_bytes`` (an h5py read counted as one call a channel row), and
  ``read_runs``, ``run_events`` against the runs a plain loop over each
  batch's rows finds.

Data: 7 continuous events of the shell's 4 channels in 2 dumps of 4 and
3, batches of 3: (0-2), (3 | 4-5) across the dumps, and a tail batch
(6); the same events stored as float32, which a float64 run casts into
its buffers one event at a time. A host injector reads each event on its
own into float64 buffers. In the stream traffic's layout (4 dumps of 64
events, batches of 8) every event is read in a run.
"""

import glob
import os
import threading

import numpy as np
import pytest
import torch

from detprocess_tpu_torch import entry as E
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.io.batchread import BatchReader
from detprocess_tpu_torch.io.fastio import FastDataset, H5Dataset
from detprocess_tpu_torch.io.rawdata import RawIndex, write_flat_dump
from detprocess_tpu_torch.ops.saltinject import split_injector
from detprocess_tpu_torch.pipelines.salting import Salting
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing
from test_torch_feature_runs import _twin, plain_runs, read_stored
from test_torch_tracing import assert_bit_equal

torch.set_num_threads(1)

LENGTH = 400000
NEVENTS, NFILES, BATCH = 7, 2, 3
SORT_KEYS = ("series_number", "event_number", "trigger_channel",
             "trigger_index")


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    paths, _ = E.write_trigger_dumps(
        str(tmp_path_factory.mktemp("treads")),
        torch.Generator().manual_seed(5), NEVENTS, NFILES, "cpu", LENGTH,
        ncoincident=4, nsingles=1)
    return paths


@pytest.fixture(scope="module")
def float_flat(flat, tmp_path_factory):
    """The flat dumps' events stored as float32: each code divided by 4
    (exact), so that four times the conversion factor gives the int16
    dumps' amps."""
    root = tmp_path_factory.mktemp("treads_f32")
    paths = []
    for src in flat:
        codes = np.fromfile(src, np.int16).reshape(
            -1, len(E.SHELL_CHANNELS), LENGTH)
        paths.append(str(root / os.path.basename(src)))
        write_flat_dump(paths[-1], codes.astype(np.float32) / 4)
    return paths


def float_index(paths):
    return lambda: RawIndex.from_flat(
        paths, E.SHELL_CHANNELS, LENGTH, E.FS, E.TSHELL_SERIES,
        dtype=np.float32, adc_conversion_factor=4 * E.SHELL_CAL,
        detector_config={c: {"close_loop_norm": cln}
                         for c, cln in zip(E.SHELL_CHANNELS, E.SHELL_CLN)},
        data_type="continuous")


@pytest.fixture(scope="module")
def hdf5(flat, tmp_path_factory):
    """Two pytesdaq dumps of the flat dumps' events: the first
    contiguous, the second chunked (``H5Dataset`` entries)."""
    pytest.importorskip("h5py")
    from detprocess_tpu_torch.io.rawdata import RawWriter

    root = tmp_path_factory.mktemp("treads_h5")
    index = E.trigger_shell_index(flat, LENGTH)
    w = RawWriter(str(root / "plain"), E.TSHELL_SERIES, E.FS,
                  E.SHELL_CHANNELS,
                  detector_config={c: {"close_loop_norm": cln} for c, cln
                                   in zip(E.SHELL_CHANNELS, E.SHELL_CLN)},
                  adc_conversion_factor=E.SHELL_CAL)
    paths = []
    for d in range(NFILES):
        rows = np.flatnonzero(index.file == d)
        codes = np.stack([read_stored(index.datasets[r]) for r in rows])
        src = w.write_dump(codes * E.shell_conv()[None, :, None],
                           dump_num=d + 1)
        dst = str(root / os.path.basename(src))
        _twin(src, dst, chunked=d == 1)
        paths.append(dst)
    return paths


@pytest.fixture(scope="module")
def salting(flat):
    """A salting table of the flat dumps: 2 salts at each of 5σ and 9σ a
    channel's resolution."""
    share = 1.0 / len(E.SHELL_CHANNELS)
    s = Salting(E.shell_filter_data(E.TRIGGER_NT, E.TRIGGER_PRETRIG),
                verbose=False)
    s.generate_salt(
        E.trigger_shell_index(flat, LENGTH), E.SHELL_CHANNELS,
        energies=[5.0, 9.0], nsalt=2,
        energy_norm_ev_per_amp={c: share / r for c, r in zip(
            E.SHELL_CHANNELS, E.trigger_shell_resolutions())},
        min_separation_msec=E.SALT_SEPARATION_MSEC,
        edge_exclusion_msec=E.SALT_EDGE_MSEC, seed=2)
    return s


def subset_config():
    """The shell's trigger config on chan2 and chan3 alone: only those
    two of the 4 stored channels are read."""
    config = E.trigger_shell_config()
    for chan in ("chan1", "chan4"):
        del config["trigger"][chan]
    return config


@pytest.fixture
def recorded(monkeypatch):
    """Every filled buffer (rows, the rows' values, their factors or
    None) by batch and the [calls, bytes] of every ``os.preadv``, from
    any thread."""
    rec = {"buffers": {}, "preadv": [0, 0]}
    lock = threading.Lock()
    real_fill, real_preadv = BatchReader.fill, os.preadv

    def fill(self, ring, rows, starts=None, batch=None):
        out = real_fill(self, ring, rows, starts, batch)
        with lock:
            rec["buffers"][batch] = (np.array(rows),
                                     out[1][1][:len(rows)].copy(),
                                     None if out[3] is None
                                     else out[3].copy())
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


def run(recorded, monkeypatch, make_shell, per_event=False, **kw):
    """(table, stats, buffers by batch, preadv [calls, bytes]) of one
    float64 ``process`` call; ``per_event`` reads every event on its
    own."""
    recorded["buffers"].clear()
    recorded["preadv"][:] = [0, 0]
    with monkeypatch.context() as m:
        if per_event:
            m.setattr(RawIndex, "runs", lambda self, rows, whole, arr: [])
        shell = make_shell()
        table = shell.process(event_batch=BATCH, dtype=np.float64, **kw)
    return (table, dict(shell.stats), dict(recorded["buffers"]),
            list(recorded["preadv"]))


def sorted_table(table):
    """The table's rows sorted by (series, event, channel, index)."""
    keys = [np.asarray(table[k]).astype(str if k == "trigger_channel"
                                        else np.int64)
            for k in SORT_KEYS]
    order = np.lexsort(keys[::-1])
    return {k: np.asarray(v)[order] for k, v in table.items()}


def shell_maker(index_fn, config=None, injector=None):
    def make():
        shell = TriggerProcessing(
            index_fn(), config or E.trigger_shell_config(),
            E.shell_filter_data(E.TRIGGER_NT, E.TRIGGER_PRETRIG),
            verbose=False, device="cpu")
        if injector is not None:
            shell.set_salting(injector)
        return shell
    return make


def check(recorded, monkeypatch, index_fn, *, config=None, sel=None,
          nreaders=1, nevents=-1, injector=None):
    """Run the case both ways and hold it to the stored values, the
    per-event branch and the plain count of runs; returns the table and
    the stats."""
    make = shell_maker(index_fn, config, injector)
    table, stats, bufs, preadv = run(recorded, monkeypatch, make,
                                     nreaders=nreaders, nevents=nevents)
    table0, stats0, bufs0, preadv0 = run(recorded, monkeypatch, make,
                                         per_event=True, nevents=nevents)
    assert stats0["read_runs"] == stats0["run_events"] == 0
    assert_bit_equal(sorted_table(table), sorted_table(table0))
    assert len(table["trigger_index"]) > 0
    index = index_fn()
    host = split_injector(injector)[0]
    names = E.SHELL_CHANNELS if sel is None else [E.SHELL_CHANNELS[i]
                                                  for i in sel]
    want_rows = index.order if nevents < 0 else index.order[:nevents]
    assert sorted(bufs) == sorted(bufs0) == list(range(len(bufs)))
    assert np.array_equal(np.concatenate([bufs[b][0] for b in sorted(bufs)]),
                          want_rows)
    assert stats["events"] == stats0["events"] == len(want_rows)
    assert stats["batches"] == len(bufs)
    nruns = nrun_events = calls = h5_calls = h5_bytes = 0
    per_row = 1 if sel is None else len(sel)
    for b, (rows, arr, conv) in bufs.items():
        rows0, arr0, conv0 = bufs0[b]
        assert np.array_equal(rows, rows0)
        assert arr.dtype == arr0.dtype == (np.float64 if host else arr.dtype)
        assert np.array_equal(arr.view(np.uint8), arr0.view(np.uint8)), b
        assert len(rows) == (BATCH if b < len(bufs) - 1
                             else len(want_rows) - BATCH * b)
        assert (conv is None) == (conv0 is None) == (host is not None)
        stored = None
        for i, row in enumerate(rows.tolist()):
            stored = read_stored(index.datasets[row])
            stored = stored if sel is None else stored[sel]
            f = index.files[int(index.file[row])]
            fconv = f.conv if sel is None else f.conv[sel]
            want = (stored.astype(arr.dtype) if host is None else
                    host(stored.astype(np.float64) * fconv[:, None],
                         index.admin(row), channels=names))
            assert np.array_equal(arr[i].view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))
            if host is None:
                assert np.array_equal(conv[i], fconv.astype(np.float32))
                assert np.array_equal(conv0[i], conv[i])
            if isinstance(index.datasets[row], H5Dataset):
                h5_bytes += stored.nbytes
        runs = plain_runs(index, rows.tolist(),
                          sel is None and arr.dtype == stored.dtype)
        nruns += len(runs)
        nrun_events += sum(j - i for i, j in runs)
        for k, r in enumerate(rows.tolist()):
            if any(i <= k < j for i, j in runs):
                continue
            if isinstance(index.datasets[r], H5Dataset):
                h5_calls += per_row
            else:
                calls += per_row
    calls += nruns
    assert [stats["read_runs"], stats["run_events"]] == [nruns, nrun_events]
    assert preadv[0] == calls
    # the per-event branch's calls, less those the runs replace
    assert preadv[0] == preadv0[0] - nrun_events + nruns
    assert preadv[1] == preadv0[1]
    for st, pr in ((stats, preadv), (stats0, preadv0)):
        assert [st["read_calls"], st["read_bytes"]] == [pr[0] + h5_calls,
                                                        pr[1] + h5_bytes]
    assert stats["read_bytes"] == stats["upload_samples"] * stored.itemsize
    return table, stats


def flat_index(paths):
    return lambda: E.trigger_shell_index(paths, LENGTH)


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_batches_across_two_dumps_and_a_tail(flat, float_flat, recorded,
                                             monkeypatch, nreaders):
    table, stats = check(recorded, monkeypatch, flat_index(flat),
                         nreaders=nreaders)
    # (0-2), (3 | 4-5), (6): row 3 ends dump 1, row 4 starts dump 2
    assert [stats["read_runs"], stats["run_events"]] == [2, 5]
    assert stats["read_calls"] == 4
    assert stats["read_bytes"] == NEVENTS * 4 * LENGTH * 2
    # float32 storage: cast into the float64 buffers one event at a time,
    # converted on the card to the int16 dumps' amps
    ftable, stats = check(recorded, monkeypatch, float_index(float_flat),
                          nreaders=nreaders)
    assert [stats["read_runs"], stats["run_events"]] == [0, 0]
    assert stats["read_calls"] == NEVENTS
    assert stats["read_bytes"] == NEVENTS * 4 * LENGTH * 4
    assert_bit_equal(ftable, table)


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_channel_subset_reads_each_row(flat, recorded, monkeypatch,
                                       nreaders):
    _, stats = check(recorded, monkeypatch, flat_index(flat),
                     config=subset_config(), sel=[1, 2], nreaders=nreaders)
    assert [stats["read_runs"], stats["run_events"]] == [0, 0]
    assert stats["read_calls"] == NEVENTS * 2


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_hdf5_entries(hdf5, recorded, monkeypatch, nreaders):
    index = RawIndex.from_pytesdaq(hdf5)
    per = int((index.file == 0).sum())
    assert all(isinstance(d, FastDataset) for d in index.datasets[:per])
    assert all(isinstance(d, H5Dataset) for d in index.datasets[per:])
    check(recorded, monkeypatch, lambda: RawIndex.from_pytesdaq(hdf5),
          nreaders=nreaders)


def test_nevents_prefix(flat, recorded, monkeypatch):
    _, stats = check(recorded, monkeypatch, flat_index(flat), nevents=5)
    # (0-2), (3 | 4)
    assert [stats["read_runs"], stats["run_events"]] == [1, 3]
    with pytest.raises(ValueError, match="nreaders > 1"):
        shell_maker(flat_index(flat))().process(nevents=5, nreaders=2)


def _dump_table(path):
    files = sorted(glob.glob(os.path.join(path, "*_F*.npz")))
    assert files
    return tables.concat_tables([tables.read_table(f) for f in files])


def test_resume_continues_as_the_per_event_path(flat, recorded, monkeypatch,
                                                tmp_path):
    """A run of the first dump (4 events; a flat dump numbers its events
    from 1, and ``resume`` goes by (series, event)) cut after 2 events,
    then resumed: the resumed batches are (2), (3), with runs and without;
    the dumps are the per-event branch's, bit for bit, and hold the uncut
    run's triggers."""
    make = shell_maker(flat_index(flat[:1]))
    kw = dict(lgc_save=True, output_format="npz", nb_events_per_dump=3,
              series_name="I1_D20261018_T120000")
    dumps = {}
    for per_event in (False, True):
        cut = str(tmp_path / f"cut{int(per_event)}")
        run(recorded, monkeypatch, make, per_event, output_path=cut,
            nevents=2, **kw)
        _, stats, bufs, _ = run(recorded, monkeypatch, make, per_event,
                                output_path=cut, resume=True, **kw)
        assert stats["events"] == 2
        assert [bufs[b][0].tolist() for b in sorted(bufs)] == [[2], [3]]
        dumps[per_event] = _dump_table(cut)
    assert_bit_equal(dumps[False], dumps[True])
    whole = str(tmp_path / "whole")
    run(recorded, monkeypatch, make, output_path=whole, **kw)
    want = _dump_table(whole)
    for key in SORT_KEYS:
        assert np.array_equal(dumps[False][key], want[key]), key
    with pytest.raises(ValueError, match="without resume"):
        make().process(resume=True, nreaders=2, lgc_save=True,
                       output_path=whole)


@pytest.mark.parametrize("nreaders", [1, 2, 3])
def test_device_injector(flat, recorded, monkeypatch, salting, nreaders):
    check(recorded, monkeypatch, flat_index(flat), nreaders=nreaders,
          injector=salting.make_device_injector(E.SHELL_CHANNELS))


def test_host_injector_takes_the_per_event_path(flat, recorded, monkeypatch,
                                                salting):
    """A host injector needs float64 amps on the host: the reader threads
    read each event on its own, one ``preadv`` a whole event, and salt it
    into float64 buffers; two reader threads give one's tables, and the
    salts give the device injector's triggers."""
    table, stats = check(recorded, monkeypatch, flat_index(flat),
                         nreaders=2,
                         injector=salting.make_injector(E.SHELL_CHANNELS))
    assert [stats["read_runs"], stats["run_events"]] == [0, 0]
    assert stats["read_calls"] == NEVENTS
    assert stats["upload_bytes"] == 8 * stats["upload_samples"]
    device = shell_maker(flat_index(flat),
                         injector=salting.make_device_injector(
                             E.SHELL_CHANNELS))
    want = sorted_table(run(recorded, monkeypatch, device)[0])
    got = sorted_table(table)
    for key in SORT_KEYS:
        assert np.array_equal(got[key], want[key]), key
    np.testing.assert_allclose(got["trigger_amplitude"],
                               want["trigger_amplitude"], rtol=1e-6)


def test_stream_layout_reads_every_event_in_runs(tmp_path, preadv_count):
    """4 dumps of 64 events, batches of 8 (the ``stream`` traffic's
    layout): no batch spans two dumps, so every event is read in a run,
    one ``preadv`` a batch."""
    length = 16384
    rng = np.random.default_rng(6)
    paths = []
    for d in range(4):
        paths.append(str(tmp_path / f"flat_{E.TSHELL_SERIES}_F{d + 1:04d}"
                                    ".bin"))
        write_flat_dump(paths[-1], rng.integers(
            -50, 50, (64, len(E.SHELL_CHANNELS), length), np.int16))
    config = E.trigger_shell_config()
    for key in ("run_residual", "saturation_amplitudes",
                "edge_exclusion_msec"):
        del config["trigger"]["chan1"][key]
    shell = TriggerProcessing(
        E.trigger_shell_index(paths, length), config,
        E.shell_filter_data(E.TRIGGER_NT, E.TRIGGER_PRETRIG), verbose=False,
        device="cpu")
    shell.process(event_batch=8, nreaders=4, capacity=64)
    stats = shell.stats
    assert stats["events"] == 256
    assert stats["run_events"] / stats["events"] == 1.0
    assert stats["read_runs"] == stats["read_calls"] == preadv_count[0] == 32


@pytest.fixture
def preadv_count(monkeypatch):
    counts, lock = [0], threading.Lock()
    real = os.preadv

    def counting(*args):
        with lock:
            counts[0] += 1
        return real(*args)

    monkeypatch.setattr(os, "preadv", counting)
    return counts
