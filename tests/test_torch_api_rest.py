"""The rest of the JAX API in the port, each against its JAX twin on the
same numpy inputs from a seed, in float64 at 1e-9:

- ``lgc_output`` of both shells' ``process``, and the empty run;
- ``YamlConfig`` on ``examples/processing/process_example.yaml``, and the
  shells given a ``YamlConfig`` in place of the path;
- ``RawWriter``: its files hold what the JAX writer's hold and read the
  same through either package's ``RawReader``, for int16 and float
  storage; ``RawReader.nb_events``/``raw_path``, ``RawData.verbose``;
- the full-spectrum optimal-filter functions of ``ops/of1x1`` and
  ``ops/ofnxm`` and the PSD features of ``ops/psdfeatures``, on the
  spectrum of real traces and on a complex spectrum of no symmetry;
- the helpers of ``utils/freq``, ``utils/channels``, ``utils/logging``,
  ``io/tables``, ``io/fastio`` and ``ops/lm``.
"""

import logging
import os
import time

import jax  # noqa: F401  (conftest sets the platform and x64)
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.config.yamlconfig import YamlConfig as JaxYamlConfig
from detprocess_tpu.io import fastio as jfastio
from detprocess_tpu.io import rawdata as jraw
from detprocess_tpu.io import tables as jtables
from detprocess_tpu.models import pulse as jpulse
from detprocess_tpu.ops import filterbank as jfb
from detprocess_tpu.ops import lm as jlm
from detprocess_tpu.ops import of1x1 as jof
from detprocess_tpu.ops import ofnxm as jnxm
from detprocess_tpu.ops import psdfeatures as jpsd
from detprocess_tpu.pipelines import triggers as jtp
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.utils import channels as jchannels
from detprocess_tpu.utils import freq as jfreq
from detprocess_tpu.utils import logging as jlogging
import detprocess_tpu_torch
from detprocess_tpu_torch.config.yamlconfig import YamlConfig
from detprocess_tpu_torch.io import fastio, rawdata, tables
from detprocess_tpu_torch.ops import lm, of1x1, ofnxm, psdfeatures
from detprocess_tpu_torch.pipelines import triggers as ttp
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.utils import channels, freq
from detprocess_tpu_torch.utils import logging as tlogging

import torch_feature_cases as cases

torch.set_num_threads(1)

RTOL = 1e-9
EXAMPLE_YAML = os.path.join(os.path.dirname(__file__), os.pardir,
                            "examples", "processing", "process_example.yaml")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# lgc_output, YamlConfig in the feature shell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rest_features"))
    raw, fpath, cpath = cases.write_inputs(root)
    return dict(root=root, raw=raw, fpath=fpath, cpath=cpath)


def _feature_shell(inputs, config=None):
    return FeatureProcessing(inputs["raw"], config or inputs["cpath"],
                             inputs["fpath"], verbose=False, device="cpu")


def test_feature_lgc_output(feature_inputs):
    """``lgc_output=False`` returns None, and its dumps hold the table
    that ``lgc_output=True`` returns; an empty run gives an empty table
    (None without output), as JAX's."""
    shell = _feature_shell(feature_inputs)
    table = shell.process(batch_size=8, dtype=np.float64)
    out = os.path.join(feature_inputs["root"], "no_output")
    got = shell.process(batch_size=8, dtype=np.float64, lgc_save=True,
                        output_path=out, output_format="npz",
                        series_name="I1_D20260901_T130000",
                        nb_events_per_dump=10, lgc_output=False)
    assert got is None
    dumps = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith(".npz"))
    assert len(dumps) == 2              # 16 rows, then the last 8
    written = tables.concat_tables([tables.read_table(p) for p in dumps])
    assert list(written) == list(table)
    for col in table:
        np.testing.assert_array_equal(written[col], table[col], err_msg=col)

    jshell = JaxFP(feature_inputs["raw"], feature_inputs["cpath"],
                   filter_data=feature_inputs["fpath"], verbose=False)
    assert jshell.process(nevents=8, dtype=np.float64,
                          lgc_output=False) is None
    empty = jshell.process(nevents=0, dtype=np.float64)
    assert isinstance(empty, pd.DataFrame) and len(empty) == 0
    assert shell.process(nevents=0, dtype=np.float64) == {}
    assert shell.process(nevents=0, dtype=np.float64,
                         lgc_output=False) is None


def test_feature_shell_takes_a_yaml_config(feature_inputs):
    """A ``YamlConfig`` gives the table that the setup path gives, on
    the port as on JAX."""
    chans, fs = cases.CHANNELS, cases.FS
    by_path = _feature_shell(feature_inputs).process(batch_size=8,
                                                     dtype=np.float64)
    by_config = _feature_shell(
        feature_inputs, YamlConfig(feature_inputs["cpath"], chans,
                                   sample_rate=fs)).process(
        batch_size=8, dtype=np.float64)
    assert list(by_config) == list(by_path)
    for col in by_path:
        np.testing.assert_array_equal(by_config[col], by_path[col])
    jdf = JaxFP(feature_inputs["raw"],
                JaxYamlConfig(feature_inputs["cpath"], chans,
                              sample_rate=fs),
                filter_data=feature_inputs["fpath"],
                verbose=False).process(batch_size=8, dtype=np.float64)
    cases.assert_tables_equal(by_config, jdf, "YamlConfig")


# ---------------------------------------------------------------------------
# YamlConfig
# ---------------------------------------------------------------------------

EXAMPLE_CHANNELS = ["Mv2301", "Mv2302"]


@pytest.mark.parametrize("ptype", [None, "salting", "feature", "didv",
                                   "noise", "template", "trigger"])
def test_yaml_config_matches_jax(ptype):
    got = YamlConfig(EXAMPLE_YAML, EXAMPLE_CHANNELS, sample_rate=1.25e6)
    want = JaxYamlConfig(EXAMPLE_YAML, EXAMPLE_CHANNELS, sample_rate=1.25e6)
    assert got.get_config(ptype) == want.get_config(ptype)
    assert got.available_channels == want.available_channels
    first = got.get_config(ptype)
    first.clear()                     # a deep copy: the next is whole
    assert got.get_config(ptype) == want.get_config(ptype)


def test_yaml_config_refusals_and_forms(tmp_path):
    one = str(tmp_path / "one.yaml")
    with open(one, "w") as f:
        yaml.safe_dump({"feature": {"chan1": {"baseline": {"run": True}}}},
                       f)
    got = YamlConfig(one, "chan1")
    want = JaxYamlConfig(one, "chan1")
    assert got.available_channels == want.available_channels == ["chan1"]
    assert got.get_config() == want.get_config()
    for ptype in ("global", "nonsense"):
        with pytest.raises(ValueError) as a:
            got.get_config(ptype)
        with pytest.raises(ValueError) as b:
            want.get_config(ptype)
        assert str(a.value) == str(b.value)
    # a JSON setup needs no PyYAML and normalizes the same
    with open(EXAMPLE_YAML) as f:
        setup = yaml.safe_load(f)
    jpath = str(tmp_path / "setup.json")
    from detprocess_tpu_torch.config.yamlconfig import write_json_setup
    write_json_setup(setup, jpath)
    assert (YamlConfig(jpath, EXAMPLE_CHANNELS).get_config()
            == YamlConfig(EXAMPLE_YAML, EXAMPLE_CHANNELS).get_config())
    assert detprocess_tpu_torch.YamlConfig is YamlConfig
    assert detprocess_tpu_torch.cli.main is not None


# ---------------------------------------------------------------------------
# lgc_output and YamlConfig in the trigger shell
# ---------------------------------------------------------------------------

TRIG_NT, TRIG_PRE, TRIG_L = 1024, 256, 100_000


@pytest.fixture(scope="module")
def trigger_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("rest_trigger")
    rng = np.random.default_rng(11)
    fs = cases.FS
    tmpl = jpulse.make_template(fs, TRIG_NT, TRIG_PRE, A=1.0, tau_r=20e-6,
                                tau_f1=200e-6)
    sigma = 2e-6
    traces = rng.standard_normal((2, 1, TRIG_L)) * sigma
    for e, pos in ((0, 30_000), (0, 70_000), (1, 50_000)):
        traces[e, 0, pos - TRIG_PRE:pos - TRIG_PRE + TRIG_NT] += 40e-6 * tmpl
    jraw.RawWriter(str(root / "raw"), "I1_D20260816_T300000", fs,
                   ["chan1"]).write_dump(traces, dump_num=1)
    fpath = str(root / "filter.npz")
    fd = detprocess_tpu_torch.FilterData(verbose=False)
    fd.set_psd("chan1", np.full(TRIG_NT, sigma ** 2 / fs), fs)
    fd.set_template("chan1", tmpl, fs, pretrigger_length_samples=TRIG_PRE)
    fd.save(fpath)
    hpath = str(root / "filter.h5")
    fd.save(hpath)
    cpath = str(root / "cfg.yaml")
    with open(cpath, "w") as f:
        yaml.safe_dump({"trigger": {"chan1": {
            "run": True, "template_tag": "default", "threshold_sigma": 8.0,
            "pileup_window_msec": 0.5}}}, f)
    files = sorted(str(p) for p in (root / "raw").glob("*.hdf5"))
    return dict(root=root, files=files, fpath=fpath, hpath=hpath,
                cpath=cpath)


def test_trigger_lgc_output_and_yaml_config(trigger_inputs):
    d = trigger_inputs
    shell = ttp.TriggerProcessing(d["files"], d["cpath"],
                                  filter_data=d["fpath"], verbose=False,
                                  device="cpu")
    table = shell.process(dtype=np.float64)
    assert tables.table_rows(table) == 3
    out = str(d["root"] / "out")
    assert shell.process(dtype=np.float64, lgc_save=True, output_path=out,
                         output_format="npz", lgc_output=False,
                         prefetch_depth=0) is None
    dumps = sorted(os.path.join(out, f) for f in os.listdir(out)
                   if f.endswith(".npz"))
    written = tables.concat_tables([tables.read_table(p) for p in dumps])
    assert list(written) == list(table)
    for col in table:
        np.testing.assert_array_equal(written[col], table[col], err_msg=col)
    by_config = ttp.TriggerProcessing(
        d["files"], YamlConfig(d["cpath"], ["chan1"], sample_rate=cases.FS),
        filter_data=d["fpath"], verbose=False,
        device="cpu").process(dtype=np.float64)
    for col in table:
        np.testing.assert_array_equal(by_config[col], table[col],
                                      err_msg=col)
    jshell = jtp.TriggerProcessing(d["files"], d["cpath"],
                                   filter_data=d["hpath"], verbose=False)
    assert jshell.process(lgc_output=False) is None


def test_filter_generation_takes_a_yaml_config(trigger_inputs):
    from detprocess_tpu_torch.pipelines.filtergen import FilterDataProcessing
    d = trigger_inputs
    cfg = YamlConfig(d["cpath"], ["chan1"], sample_rate=cases.FS)
    a = FilterDataProcessing(noise_files=d["files"], config=cfg,
                             verbose=False, device="cpu")
    b = FilterDataProcessing(noise_files=d["files"], config=d["cpath"],
                             verbose=False, device="cpu")
    assert a._config == b._config


# ---------------------------------------------------------------------------
# RawWriter
# ---------------------------------------------------------------------------

def _h5_contents(path):
    """Every group's and dataset's attributes, and each dataset's values,
    of an HDF5 file, keyed by name."""
    import h5py

    out = {}

    def norm(v):
        v = np.asarray(v)
        return v.astype(str).tolist() if v.dtype.kind in "OSU" else v.tolist()

    with h5py.File(path, "r") as f:
        out["/"] = {k: norm(v) for k, v in f.attrs.items()}

        def visit(name, obj):
            attrs = {k: norm(v) for k, v in obj.attrs.items()}
            data = (np.asarray(obj[()]) if isinstance(obj, h5py.Dataset)
                    else None)
            out[name] = (attrs, data)
        f.visititems(visit)
    return out


WRITER_KW = dict(
    nb_pretrigger_samples=100, fridge_run=7, series_start_time=1000,
    group_start_time=900, fridge_run_start_time=800,
    detector_config={"chanA": {"close_loop_norm": 2.0, "tes_bias": 1e-7},
                     "chanB": {"close_loop_norm": 4.0, "output_gain": 10.0}})


@pytest.mark.parametrize("cal", [None, 2.0 ** -20])
def test_raw_writer_writes_what_jax_writes(tmp_path, cal):
    rng = np.random.default_rng(3)
    traces = rng.standard_normal((5, 2, 300)) * 1e-6
    times = np.arange(5) * 0.25
    args = ("I2_D20260101_T010203", 1.25e6, ["chanA", "chanB"])
    kw = dict(WRITER_KW, adc_conversion_factor=cal, prefix="rand",
              group_name="g1", data_type="rand")
    mine = rawdata.RawWriter(str(tmp_path / "port"), *args, **kw)
    theirs = jraw.RawWriter(str(tmp_path / "jax"), *args, **kw)
    paths = []
    for dump in (1, 2):
        got = mine.write_dump(traces * dump, dump_num=dump,
                              event_times=times,
                              trigger_types=np.full(5, 3),
                              start_time=10.0 * dump)
        want = theirs.write_dump(traces * dump, dump_num=dump,
                                 event_times=times,
                                 trigger_types=np.full(5, 3),
                                 start_time=10.0 * dump)
        assert os.path.basename(got) == os.path.basename(want)
        assert got == mine.file_name(dump)
        a, b = _h5_contents(got), _h5_contents(want)
        assert set(a) == set(b)
        for key in b:
            if key == "/":
                assert a[key] == b[key]
                continue
            assert a[key][0] == b[key][0], key
            if b[key][1] is not None:
                assert a[key][1].dtype == b[key][1].dtype, key
                np.testing.assert_array_equal(a[key][1], b[key][1])
        paths.append((got, want))

    # read back through both readers: the same traces and admin
    for reader in (jraw.RawReader, rawdata.RawReader):
        ta, aa = reader([p for p, _ in paths]).read_many_events()
        tb, ab = reader([q for _, q in paths]).read_many_events()
        np.testing.assert_array_equal(ta, tb)
        assert ([{k: v for k, v in x.items() if k != "file_name"}
                 for x in aa]
                == [{k: v for k, v in x.items() if k != "file_name"}
                    for x in ab])
    if cal is None:
        back, _ = rawdata.RawReader([p for p, _ in paths]).read_many_events()
        _close(back[:5], traces, rtol=1e-6)


def test_raw_reader_and_raw_data_accessors(tmp_path):
    rng = np.random.default_rng(4)
    w = rawdata.RawWriter(str(tmp_path / "grp"), "I1_D20260101_T000000",
                          1e6, ["c1"])
    files = [w.write_dump(rng.standard_normal((n, 1, 64)), dump_num=k)
             for k, n in ((1, 3), (2, 5))]
    mine, theirs = rawdata.RawReader(files), jraw.RawReader(files)
    for f in (None, files[1]):
        assert mine.nb_events(f) == theirs.nb_events(f)
    assert mine.nb_events(files[1]) == 5
    assert mine.raw_path == theirs.raw_path == str(tmp_path / "grp")
    assert (rawdata.RawData(str(tmp_path / "grp")).verbose
            == jraw.RawData(str(tmp_path / "grp")).verbose)


def test_fastio_resolves_as_jax_does(tmp_path):
    import h5py

    w = jraw.RawWriter(str(tmp_path), "I1_D20260101_T000000", 1e6, ["c1"],
                       adc_conversion_factor=1e-3)
    path = w.write_dump(np.ones((2, 1, 16)), dump_num=1)
    reader = fastio.FastReader()
    with h5py.File(path, "r") as f:
        ds = f["adc1/event_1"]
        assert fastio.dataset_storage(ds) == jfastio.dataset_storage(ds)
        entry = reader.resolve(path, ds)
        assert entry == jfastio.FastReader().resolve(path, ds)
        assert reader.resolve(path, ds) is entry
    with h5py.File(str(tmp_path / "chunked.h5"), "w") as f:
        ds = f.create_dataset("x", data=np.ones((4, 4)), chunks=(2, 2))
        assert fastio.dataset_storage(ds) is None
        assert reader.resolve(str(tmp_path / "chunked.h5"), ds) is None
    np.testing.assert_array_equal(reader.read(entry), np.ones((1, 16)) * 1000)
    reader.close()


# ---------------------------------------------------------------------------
# full-spectrum optimal filters
# ---------------------------------------------------------------------------

FS, N, PRE = 1.25e6, 512, 200


def _of1x1_bank():
    t1 = jpulse.make_template(FS, N, PRE, A=1.0, tau_r=10e-6, tau_f1=60e-6)
    t2 = jpulse.make_template(FS, N, PRE, A=1.0, tau_r=4e-6, tau_f1=25e-6)
    psd = cases.psd(N) * np.linspace(1.0, 2.0, N)
    return jfb.make_of1x1_bank(np.stack([t1, t2]), np.stack([psd, psd]),
                               FS, PRE)


def _spectra(kind, rng, bank, b=6):
    """[b, S, N]: the FFT of noisy pulses, or a complex spectrum with no
    symmetry of the same scale."""
    s = bank.s_fft.shape[0]
    if kind == "real":
        tm = np.fft.ifft(bank.s_fft).real
        traces = (rng.uniform(1, 3, (b, s, 1)) * np.roll(tm, 7, axis=-1)
                  + rng.standard_normal((b, s, N)) * 1e-2)
        return np.fft.fft(traces, axis=-1), traces
    scale = np.abs(bank.s_fft).max()
    return (scale * (rng.standard_normal((b, s, N))
                     + 1j * rng.standard_normal((b, s, N))), None)


def _bank_args(bank):
    return bank.phi, bank.norm, bank.denom_inv, bank.s_fft


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_of1x1_full_spectrum_matches_jax(kind):
    rng = np.random.default_rng(21)
    bank = _of1x1_bank()
    vfft, traces = _spectra(kind, rng, bank)
    if traces is not None:
        _close(of1x1.signal_fft(_t(traces)), jof.signal_fft(traces), 1e-12,
               1e-12 * np.abs(vfft).max())
        _close(of1x1.signal_rfft(_t(traces)), jof.signal_rfft(traces), 1e-12,
               1e-12 * np.abs(vfft).max())
    low = of1x1.lowfreq_mask(N, FS, 50000.0)
    np.testing.assert_array_equal(low, jof.lowfreq_mask(N, FS, 50000.0))
    args = _bank_args(bank)
    targs = [_t(a) for a in args]
    _close(of1x1.chi2_base(_t(vfft), targs[2]),
           jof.chi2_base(vfft, bank.denom_inv))
    for mask in (None, low):
        got = of1x1.of1x1_nodelay(_t(vfft), *targs, low_mask=mask)
        want = jof.of1x1_nodelay(vfft, *args, low_mask=mask)
        for g, w, name in zip(got, want, want._fields):
            _close(g, w, what=f"nodelay {name}",
                   atol=RTOL * np.abs(np.asarray(w)).max())
    window = np.zeros(N, bool)
    window[PRE - 20:PRE + 30] = True
    for wmask, interp in ((None, False), (window, False), (None, True),
                          (window, True)):
        got = of1x1.of1x1_withdelay(_t(vfft), *targs, PRE, FS,
                                    window_mask=wmask, low_mask=low,
                                    interpolate_t0=interp)
        want = jof.of1x1_withdelay(vfft, *args, PRE, FS, window_mask=wmask,
                                   low_mask=low, interpolate_t0=interp)
        for g, w, name in zip(got, want, want._fields):
            _close(g, w, what=f"withdelay {name} {interp}",
                   atol=RTOL * np.abs(np.asarray(w)).max())
    amp = np.abs(np.asarray(want.amp)) + 0.5
    _close(of1x1.time_resolution(_t(amp), _t(bank.s_fft), _t(bank.denom_inv),
                                 FS),
           jof.time_resolution(amp, bank.s_fft, bank.denom_inv, FS))


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("delta_window", [None, np.arange(-40, 60)])
def test_of1x2_full_spectrum_matches_jax(kind, delta_window):
    rng = np.random.default_rng(22)
    bank = _of1x1_bank()
    vfft, _ = _spectra(kind, rng, bank)
    vfft = vfft[:, :1] + 0.5 * vfft[:, 1:]
    one, two = slice(0, 1), slice(1, 2)
    args = (bank.phi[one], bank.norm[one], bank.s_fft[one], bank.phi[two],
            bank.norm[two], bank.s_fft[two], bank.denom_inv[one])
    got = of1x1.of1x2(_t(vfft), *[_t(a) for a in args], PRE, FS,
                      delta_window=delta_window)
    want = jof.of1x2(vfft, *args, PRE, FS, delta_window=delta_window)
    for g, w, name in zip(got, want, want._fields):
        _close(g, w, what=name, atol=RTOL * np.abs(np.asarray(w)).max())


def _nxm_bank():
    from trigger_cases import csd, templates
    return jfb.make_ofnxm_bank(templates(N, PRE, "2x2"), csd(N, "2x2"), FS,
                               PRE)


def _nxm_spectra(kind, rng, bank, b=5):
    if kind == "real":
        tm = bank.templates                                 # [C, M, N]
        amps = rng.uniform(1, 3, (b, 1, tm.shape[1], 1))
        traces = (np.sum(amps * np.roll(tm, 5, axis=-1)[None], axis=2)
                  + rng.standard_normal((b, tm.shape[0], N)) * 2e-3)
        return np.fft.fft(traces, axis=-1)
    scale = np.abs(bank.s_fft).max()
    c = bank.s_fft.shape[0]
    return scale * (rng.standard_normal((b, c, N))
                    + 1j * rng.standard_normal((b, c, N)))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_ofnxm_full_spectrum_matches_jax(kind):
    rng = np.random.default_rng(23)
    bank = _nxm_bank()
    vfft = _nxm_spectra(kind, rng, bank)
    tv = _t(vfft)
    _close(ofnxm.chi2_base_nxm(tv, _t(bank.icsd), FS),
           jnxm.chi2_base_nxm(vfft, bank.icsd, FS))
    got = ofnxm.ofnxm_nodelay(tv, _t(bank.phi), _t(bank.iw_matrix),
                              _t(bank.icsd), FS)
    want = jnxm.ofnxm_nodelay(vfft, bank.phi, bank.iw_matrix, bank.icsd, FS)
    for g, w, name in zip(got, want, want._fields):
        _close(g, w, what=f"nodelay {name}",
               atol=RTOL * np.abs(np.asarray(w)).max())
    window = np.zeros(N, bool)
    window[PRE - 15:PRE + 25] = True
    for wmask, interp in ((None, False), (window, True)):
        got = ofnxm.ofnxm_withdelay(
            tv, _t(bank.phi), _t(bank.w_matrix), _t(bank.iw_matrix),
            _t(bank.icsd), PRE, FS, window_mask=wmask, interpolate_t0=interp)
        want = jnxm.ofnxm_withdelay(
            vfft, bank.phi, bank.w_matrix, bank.iw_matrix, bank.icsd, PRE,
            FS, window_mask=wmask, interpolate_t0=interp)
        for g, w, name in zip(got, want, want._fields):
            _close(g, w, what=f"withdelay {name}",
                   atol=RTOL * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_ofnxmx2_full_spectrum_matches_jax(kind):
    rng = np.random.default_rng(24)
    bank = _nxm_bank()
    vfft = _nxm_spectra(kind, rng, bank)
    w1 = np.zeros(N, bool)
    w1[PRE - 6:PRE + 6] = True
    w2 = np.zeros(N, bool)
    w2[PRE + 2:PRE + 20] = True
    got, (d1, d2) = ofnxm.ofnxmx2(_t(vfft), _t(bank.s_fft), _t(bank.icsd),
                                  [0, 1], w1, w2, PRE, FS)
    want, (jd1, jd2) = jnxm.ofnxmx2(vfft, bank.s_fft, bank.icsd,
                                    np.array([0, 1]), w1, w2, PRE, FS)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    for g, w, name in zip(got, want, want._fields):
        _close(g, w, what=name, atol=RTOL * np.abs(np.asarray(w)).max())


# ---------------------------------------------------------------------------
# full-spectrum PSD features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["real", "complex"])
def test_psd_features_full_spectrum_match_jax(kind):
    rng = np.random.default_rng(25)
    n = 600
    if kind == "real":
        t = np.arange(n) / FS
        traces = (np.sin(2 * np.pi * 41e3 * t)[None]
                  * rng.uniform(1, 2, (4, 1))
                  + 0.3 * rng.standard_normal((4, n)))
        vfft = np.fft.fft(traces, axis=-1)
    else:
        vfft = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
    tv = _t(vfft)
    for g, w in zip(psdfeatures.event_psd_folded(tv, FS),
                    jpsd.event_psd_folded(vfft, FS)):
        _close(g, w)
    folded = freq.folded_freqs(n, FS)
    ranges, _ = freq.cleanup_freq_ranges([[10e3, 100e3], 200e3])
    ind = freq.get_ind_freq_ranges(ranges, folded)
    _close(psdfeatures.psd_amp(tv, FS, ind), jpsd.psd_amp(vfft, FS, ind))
    band = psdfeatures.band_mask(folded, [10e3, 300e3])
    for g, w in zip(psdfeatures.psd_peaks(tv, FS, band, 3, 2),
                    jpsd.psd_peaks(vfft, FS, band, 3, 2)):
        _close(g, w)
    for thr in (0.0, 0.5):
        got = psdfeatures.phase_at_peaks(tv, FS, band, 3, 2, pretrigger=150,
                                         threshold_factor=thr)
        want = jpsd.phase_at_peaks(vfft, FS, band, 3, 2, pretrigger=150,
                                   threshold_factor=thr)
        for g, w in zip(got, want):
            _close(g, w, atol=1e-9)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 9, 1000])
def test_freq_helpers_match_jax(n):
    rng = np.random.default_rng(n)
    np.testing.assert_array_equal(freq.fftfreq(n, FS), jfreq.fftfreq(n, FS))
    np.testing.assert_array_equal(freq.rfftfreq(n, FS),
                                  jfreq.rfftfreq(n, FS))
    psd = rng.uniform(1, 2, (3, n))
    for g, w in zip(freq.fold_spectrum(psd, FS),
                    jfreq.fold_spectrum(psd, FS)):
        np.testing.assert_array_equal(g, w)
    csd = psd + 1j * rng.standard_normal((3, n))
    for g, w in zip(freq.fold_spectrum(csd, FS),
                    jfreq.fold_spectrum(csd, FS)):
        np.testing.assert_array_equal(g, w)
    folded = jfreq.fold_spectrum(psd, FS)[1]
    np.testing.assert_array_equal(freq.unfold_spectrum(folded, n),
                                  jfreq.unfold_spectrum(folded, n))
    with pytest.raises(ValueError, match="inconsistent"):
        freq.unfold_spectrum(folded, n + 2)
    for axis in (jfreq.fftfreq(n, FS), jfreq.rfftfreq(n, FS)):
        assert (freq.estimate_sampling_rate(axis)
                == jfreq.estimate_sampling_rate(axis))
    with pytest.raises(ValueError, match="no positive"):
        freq.estimate_sampling_rate(np.zeros(4))
    from detprocess_tpu_torch.ops import spectral
    np.testing.assert_array_equal(
        spectral.fold_spectrum(torch.as_tensor(psd)).numpy(),
        jfreq.fold_spectrum(psd, FS)[1])
    from detprocess_tpu_torch.io import filterdata
    assert filterdata.fold_spectrum is freq.fold_spectrum
    assert filterdata.estimate_sampling_rate is freq.estimate_sampling_rate


def test_series_name_to_number_matches_jax():
    for name in ("I2_D20260101_T010203", "cont_I17_D20251231_T235959_F0003"):
        assert (channels.series_name_to_number(name)
                == jchannels.series_name_to_number(name))
    assert rawdata.series_to_number("I2_D20260101_T010203") == (
        jraw.series_to_number("I2_D20260101_T010203"))
    with pytest.raises(ValueError, match="unrecognized series name"):
        channels.series_name_to_number("no_series_here")


def test_progress_logs_as_jax(caplog):
    t0 = time.perf_counter() - 2.0
    with caplog.at_level(logging.INFO):
        tlogging.progress(300, 100, t0, what="rows")
        tlogging.progress(301, 100, t0, what="rows")
        jlogging.progress(300, 100, t0, what="rows")
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2
    assert msgs[0].split(" (")[0] == msgs[1].split(" (")[0] == (
        "processed 300 rows")


def test_device_trace(tmp_path):
    with tlogging.device_trace(None) as prof:
        assert prof is None
    with tlogging.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    written = os.listdir(tmp_path / "trace")
    assert len(written) == 1 and written[0].endswith(".json")


@pytest.mark.parametrize("fmt", ["hdf5", "parquet", "npz"])
def test_tables_count_and_parquet_match_jax(tmp_path, fmt):
    table = {"a": np.arange(7.0), "b": np.array(list("abcdefg")),
             "c": np.arange(7)}
    path = str(tmp_path / f"t.{tables.table_ext(fmt)}")
    tables.write_table(table, path, fmt)
    assert tables.count_rows(path) == 7
    if fmt != "npz":
        assert jtables.count_rows(path) == 7
    if fmt == "parquet":
        jpath = str(tmp_path / "j.parquet")
        jtables.write_parquet(pd.DataFrame(table), jpath)
        back = tables.read_parquet(jpath)
        want = jtables.read_parquet(path)
        for col in table:
            np.testing.assert_array_equal(back[col], want[col].to_numpy())
        tables.write_parquet(pd.DataFrame(table), jpath)
        assert tables.count_rows(jpath) == 7
    tables.write_table({}, str(tmp_path / "empty.npz"), "npz")
    assert tables.count_rows(str(tmp_path / "empty.npz")) == 0


def test_complex_residuals_match_jax():
    rng = np.random.default_rng(26)
    x = np.linspace(1e3, 1e5, 50)
    data = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    weights = rng.uniform(0.5, 1.5, 50)
    params = np.array([2.0, 3e-5])

    def model_t(p, f):
        return p[0] / (1 + 2j * np.pi * f * p[1])

    def model_j(p, f):
        return p[0] / (1 + 2j * jnp.pi * f * p[1])

    got = lm.complex_residuals(model_t)(_t(params), _t(x), _t(data),
                                        _t(weights))
    want = jlm.complex_residuals(model_j)(jnp.asarray(params), x, data,
                                          weights)
    _close(got, want, rtol=1e-12)


def test_aliases_under_the_jax_paths():
    from detprocess_tpu_torch.io import filterdata, filterfile
    from detprocess_tpu_torch.ops import adc, fft, saltinject
    assert filterfile.FilterData is filterdata.FilterData
    assert filterfile.check_fs_consistent is filterdata.check_fs_consistent
    assert saltinject.adc_convert is adc.adc_convert
    np.testing.assert_array_equal(fft.fftfreq(16, FS),
                                  np.fft.fftfreq(16, 1 / FS))
    from detprocess_tpu_torch.pipelines import feature_plan, features
    assert features.AlgoSpec is feature_plan.AlgoSpec
    assert features.TraceGroup is feature_plan.TraceGroup
