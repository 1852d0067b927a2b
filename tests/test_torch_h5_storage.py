"""Raw datasets the pread reader cannot serve: chunked, gzip+shuffle,
compact and big-endian storage of pytesdaq event datasets, read through
h5py hyperslabs (``io/fastio.H5Dataset``).

Each storage form is written as the twin of a contiguous file (the same
events, attributes and groups; only each ``event_*`` dataset's layout
differs). Through the port's ``RawIndex``: the reader's events (amps,
stored codes, windows, channel subsets) equal the contiguous twin's and
the JAX ``RawReader``'s on the same file exactly; both shells' tables,
``Randoms`` windows and ``io/upload.read_channel`` equal the contiguous
twin's exactly. The one-event gzip-chunked file that the port used to
refuse is one case.
"""

import numpy as np
import pytest
import torch

import h5py
import torch_feature_cases as cases
from detprocess_tpu.io.rawdata import RawReader as JaxRawReader
from detprocess_tpu.io.rawdata import RawWriter
from detprocess_tpu.models import pulse
from detprocess_tpu_torch.io.fastio import FastDataset, H5Dataset
from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex, RawReader
from detprocess_tpu_torch.io.upload import read_channel
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.randoms import Randoms
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing

torch.set_num_threads(1)

LAYOUTS = ("chunked", "gzip+shuffle", "compact", "big-endian")
FS = 1.25e6
# continuous data small enough for compact storage (< 64 KiB a dataset)
TRIG_CHANNELS = ["chan1", "chan2"]
TRIG_L, TRIG_NT, TRIG_PRE = 12000, 512, 128
TRIG_SERIES = "I1_D20260820_T260000"


def _write(group, name, data, layout):
    """``data`` as dataset ``name`` of ``group`` in ``layout``."""
    if layout == "contiguous":
        return group.create_dataset(name, data=data)
    if layout == "chunked":
        return group.create_dataset(name, data=data,
                                    chunks=(1, min(256, data.shape[-1])))
    if layout == "gzip+shuffle":
        return group.create_dataset(name, data=data,
                                    chunks=(1, min(512, data.shape[-1])),
                                    compression="gzip", shuffle=True)
    if layout == "big-endian":
        return group.create_dataset(
            name, data=data.astype(data.dtype.newbyteorder(">")))
    assert layout == "compact"
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    dsid = h5py.h5d.create(group.id, name.encode(),
                           h5py.h5t.py_create(data.dtype),
                           h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds = h5py.Dataset(dsid)
    ds[...] = data
    return ds


def _twin(src, dst, layout):
    """A copy of the pytesdaq file ``src`` with every ``event_*`` dataset
    rewritten in ``layout``."""
    def copy(gi, go):
        go.attrs.update(dict(gi.attrs))
        for name, obj in gi.items():
            if isinstance(obj, h5py.Group):
                copy(obj, go.create_group(name))
            elif name.startswith("event_"):
                ds = _write(go, name, obj[...], layout)
                ds.attrs.update(dict(obj.attrs))
            else:
                gi.copy(obj, go, name)

    with h5py.File(src, "r") as fi, h5py.File(dst, "w") as fo:
        copy(fi, fo)
    return dst


def _trigger_raw(root, rng):
    """Two continuous int16 events of 2 × 12000 samples with pulses, and
    their filter data."""
    tmpl = pulse.make_template(FS, TRIG_NT, TRIG_PRE, A=1.0, tau_r=20e-6,
                               tau_f1=60e-6)
    traces = rng.standard_normal((2, 2, TRIG_L)) * 1e-9
    for ev in range(2):
        for ch, p, a in ((0, 3000, 1.6e-9), (1, 3020, 1.4e-9),
                         (0, 8000, 1.5e-9), (1, 10000, 1.8e-9)):
            traces[ev, ch, p - TRIG_PRE:p - TRIG_PRE + TRIG_NT] += a * tmpl
    w = RawWriter(str(root / "raw"), TRIG_SERIES, FS, TRIG_CHANNELS,
                  data_type="continuous", nb_pretrigger_samples=TRIG_PRE,
                  detector_config={c: {"close_loop_norm": 1.0}
                                   for c in TRIG_CHANNELS},
                  adc_conversion_factor=1e-11)     # noise ~100 codes
    w.write_dump(traces, dump_num=1)
    fd = FilterData(verbose=False)
    for c in TRIG_CHANNELS:
        fd.set_template(c, tmpl, FS, pretrigger_length_samples=TRIG_PRE)
        fd.set_psd(c, np.full(TRIG_NT, 1e-9 ** 2 / FS), FS)
    return sorted(str(p) for p in (root / "raw").glob("*.hdf5")), fd


TRIG_CONFIG = {"trigger": {c: {"run": True, "template_tag": "default",
                               "threshold_sigma": 7.0,
                               "pileup_window_msec": 0.04}
                           for c in TRIG_CHANNELS}}


def _refused_file(path):
    """The one-event gzip-chunked file that the port refused before it
    read such storage through h5py."""
    with h5py.File(path, "w") as f:
        f.attrs["series_num"] = 1
        g = f.create_group("adc1")
        g.attrs.update({"nb_events": 1, "nb_samples": 64, "sample_rate": 1e6,
                        "channel_list": ["c"]})
        g.create_dataset("event_1", data=(np.arange(64, dtype=np.int16)
                                          - 32)[None],
                         chunks=(1, 16), compression="gzip")
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """{"feature" | "trigger" | "refused": {layout: [paths]}} with the
    contiguous twin under "contiguous", and the filter data."""
    root = tmp_path_factory.mktemp("h5_storage")
    feat = cases.write_raw(root / "feature", np.random.default_rng(8),
                           nevents=6, dumps=1)
    trig, trig_fd = _trigger_raw(root / "trigger",
                                 np.random.default_rng(9))
    (root / "refused").mkdir()
    refused = [_refused_file(str(root / "refused" /
                                 "cont_I1_D20260101_T000000_F0001.hdf5"))]
    out = {"feature": {}, "trigger": {}, "refused": {}}
    for kind, paths, layouts in (("feature", feat, LAYOUTS),
                                 ("trigger", trig, LAYOUTS),
                                 ("refused", refused, ("contiguous",))):
        out[kind]["contiguous" if kind != "refused" else "gzip-chunked"] \
            = paths
        for layout in layouts:
            d = root / f"{kind}_{layout.replace('+', '_')}"
            d.mkdir()
            out[kind][layout] = [_twin(p, str(d / p.rsplit("/", 1)[1]),
                                       layout) for p in paths]
    fpath = str(root / "filter.h5")
    cases.filter_data().save_hdf5(fpath)
    return out, fpath, trig_fd


CASES = [(kind, layout) for kind in ("feature", "trigger")
         for layout in LAYOUTS] + [("refused", "gzip-chunked")]


def _events(reader, nev, **kw):
    return [reader.read_next_event(**kw)[0] for _ in range(nev)]


@pytest.mark.parametrize("kind,layout", CASES)
def test_events_equal_contiguous_twin_and_jax(data, kind, layout):
    files, _, _ = data
    paths, twin = files[kind][layout], files[kind]["contiguous"]
    index = RawIndex.from_pytesdaq(paths)
    assert all(isinstance(d, H5Dataset) for d in index.datasets)
    ref_index = RawIndex.from_pytesdaq(twin)
    assert all(isinstance(d, FastDataset) for d in ref_index.datasets)
    nev = len(index)
    assert nev == len(ref_index) > 0
    got, ref = RawReader(index), RawReader(ref_index)
    jax_reader = JaxRawReader(paths)
    chans = index.channels
    try:
        for kw in ({}, {"dtype": None, "adctoamp": False},
                   {"channels": chans[::-1]}):
            a, b = _events(got, nev, **kw), _events(ref, nev, **kw)
            got.rewind()
            ref.rewind()
            j = [jax_reader.read_next_event(**kw)[0] for _ in range(nev)]
            jax_reader.rewind()
            for x, y, z in zip(a, b, j):
                assert x.dtype == y.dtype and x.dtype.isnative
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)
        n = index.files[0].nb_samples
        for window in ((n // 4, n // 3), (-5, 40), (n - 10, 50)):
            for row in range(nev):
                num = int(index.event_number[row])
                x, _ = got.read_single_event(num, trace_window=window,
                                             channels=chans[:1])
                y, _ = ref.read_single_event(num, trace_window=window,
                                             channels=chans[:1])
                j, _ = jax_reader.read_single_event(
                    num, trace_window=window, channels=chans[:1])
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, j)
        host, conv = read_channel(index, chans[-1])
        host_ref, conv_ref = read_channel(ref_index, chans[-1])
        np.testing.assert_array_equal(host.numpy(), host_ref.numpy())
        np.testing.assert_array_equal(conv, conv_ref)
    finally:
        got.close()
        ref.close()


def _assert_tables_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, key
        if g.dtype == object:           # NaN marks a missing string
            g, w = ([None if x != x else x for x in a] for a in (g, w))
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_feature_shell_equals_contiguous_twin(data, layout, dtype):
    files, fd, _ = data

    def run(paths):
        shell = FeatureProcessing(paths, cases.CONFIG, fd, verbose=False,
                                  device="cpu")
        return shell.process(batch_size=4, dtype=dtype, nreaders=2)

    _assert_tables_equal(run(files["feature"][layout]),
                         run(files["feature"]["contiguous"]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_trigger_shell_and_randoms_equal_contiguous_twin(data, layout):
    files, _, fd = data
    paths, twin = files["trigger"][layout], files["trigger"]["contiguous"]

    def triggers(p):
        shell = TriggerProcessing(p, TRIG_CONFIG, fd, verbose=False,
                                  device="cpu")
        return shell.process(capacity=64, event_batch=2, nreaders=2,
                             dtype=np.float64)

    got = triggers(paths)
    assert len(got["trigger_index"]) > 0
    _assert_tables_equal(got, triggers(twin))

    def randoms(p):
        r = Randoms(p, verbose=False, device="cpu")
        table = r.process(nrandoms=8, min_separation_msec=0.5,
                          edge_exclusion_msec=0.5, seed=4)
        return table, r.read_random_traces(table, 1024, 512)

    (t_got, w_got), (t_ref, w_ref) = randoms(paths), randoms(twin)
    _assert_tables_equal(t_got, t_ref)
    assert w_got.shape[0] > 0
    np.testing.assert_array_equal(w_got.numpy(), w_ref.numpy())
