"""The port's shells, ``Noise`` and the command line with a mesh against
the JAX package's with its mesh: the counterpart of
tests/test_pipeline_mesh.py.

Data: its 6 continuous events (deliberately not a multiple of the shard
count) of 60,000 samples, one channel with three pulses an event, in a
pytesdaq HDF5 file that both read. The JAX shells run on their 8-device
virtual CPU mesh, the port's on 4 virtual CPU shards (an event batch of 4
or 7 then splits unevenly, and a batch of 2 leaves shards empty).

Tolerances: the trigger table at tests/test_torch_triggers.py's (Δχ² and
amplitudes rtol 1e-4 against JAX's float32 shell, everything else exact);
features at tests/test_torch_features.py's; the spectra at 1e-9. The
port's mesh runs against its own runs without a mesh: floats within
1e-12 relative (a shard sums its FFTs over fewer events), the rest
exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from detprocess_tpu.io.filterfile import FilterData as JaxFD
from detprocess_tpu.io.rawdata import RawWriter, series_to_number
from detprocess_tpu.models import pulse
from detprocess_tpu.parallel import mesh as jmesh
from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu.pipelines.noise import Noise as JaxNoise
from detprocess_tpu.pipelines.salting import Salting as JaxSalting
from detprocess_tpu.pipelines.triggers import TriggerProcessing as JaxTP
from detprocess_tpu_torch import cli
from detprocess_tpu_torch.io import tables
from detprocess_tpu_torch.parallel import mesh as pmesh
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.noise import Noise
from detprocess_tpu_torch.pipelines.salting import Salting
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing

import torch_feature_cases as cases
from test_torch_triggers import assert_shell_equal

torch.set_num_threads(1)

FS = 1.25e6
NT = 1024
PRETRIG = 256
L = 60000
NEV = 6
SERIES = "I1_D20260818_T090000"
SHARDS = 4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshpipe")
    rng = np.random.default_rng(11)
    tmpl = pulse.make_template(FS, NT, PRETRIG, A=1.0, tau_r=20e-6,
                               tau_f1=200e-6)
    psd = np.full(NT, 4e-18)
    sigma = np.sqrt(psd[0] * FS)
    traces = rng.standard_normal((NEV, 1, L)) * sigma
    for ev in range(NEV):
        for pos in (15000, 30000, 45000):
            start = pos + 37 * ev - PRETRIG
            traces[ev, 0, start:start + NT] += (18e-6 + 2e-6 * ev) * tmpl
    RawWriter(str(root / "raw"), SERIES, FS, ["chan1"],
              data_type="continuous").write_dump(traces, dump_num=1)
    fd = JaxFD(verbose=False)
    fd.set_template("chan1", tmpl, FS, pretrigger_length_samples=PRETRIG)
    fd.set_psd("chan1", psd, FS)
    fpath = str(root / "filter.h5")
    fd.save_hdf5(fpath)

    def write(name, cfg):
        path = str(root / name)
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    trig = {"chan1": {"run": True, "template_tag": "default",
                      "threshold_sigma": 8.0, "pileup_window_msec": 0.2}}
    feat = {"trace_length_samples": NT,
            "pretrigger_length_samples": PRETRIG,
            "chan1": {"of1x1_nodelay": {"run": True,
                                        "template_tag": "default"},
                      "of1x1_unconstrained": {"run": True,
                                              "template_tag": "default"},
                      "baseline": {"run": True}}}
    full = {"trace_length_samples": L, "pretrigger_length_samples": L // 2,
            "chan1": {"baseline": {"run": True}, "integral": {"run": True},
                      "maximum": {"run": True}}}
    residual = {"chan1": dict(trig["chan1"], run_residual=True)}
    salts = pd.DataFrame({
        "series_number": [series_to_number(SERIES)] * NEV,
        "event_number": list(range(1, NEV + 1)),
        "salt_channel": ["chan1"] * NEV,
        "salt_amplitude": [2e-5] * NEV,
        "salt_template_tag": ["default"] * NEV,
        "trigger_index": [52000 - 100 * e for e in range(NEV)],
        "salt_energy_ev": [50.0] * NEV})
    return dict(
        root=root, raw=sorted(str(p) for p in (root / "raw").glob("*.hdf5")),
        fd=fd, fpath=fpath, salts=salts,
        tpath=write("trig.yaml", {"trigger": trig}),
        rpath=write("resid.yaml", {"trigger": residual}),
        fcfg=write("feat.yaml", {"feature": feat}),
        full=write("full.yaml", {"feature": full}),
        setup=write("setup.yaml", {"filter_file": fpath, "trigger": trig,
                                   "feature": feat}),
        jax={})


def _mesh():
    return pmesh.make_mesh(SHARDS, device="cpu")


def _same(got, want, what=""):
    """The port's mesh run against its run without one."""
    assert list(got) == list(want), what
    assert tables.table_rows(got) == tables.table_rows(want) > 0, what
    for col in want:
        g, w = np.asarray(got[col]), np.asarray(want[col])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12,
                                       err_msg=f"{what} {col}")
        else:
            assert list(g) == list(w), (what, col)


def _jax_trigger(d, mode):
    key = ("trigger", mode)
    if key not in d["jax"]:
        proc = JaxTP(d["raw"], d["rpath" if mode == "residual" else "tpath"],
                     filter_data=d["fd"], verbose=False)
        if mode == "dynamic":
            proc.set_dynamic_threshold(
                "chan1", lambda m: jnp.where(m > 1e4, 400.0, 250.0))
        if mode == "salted":
            js = JaxSalting(d["fd"], verbose=False)
            js.set_dataframe(d["salts"])
            proc.set_salting(js.make_device_injector(["chan1"]))
        # the JAX shell's dynamic merge fails under shard_map (a scan
        # carry without the mesh axis, ops/trigger.py:1274): its events
        # are independent, so its run without a mesh is the reference
        d["jax"][key] = proc.process(
            capacity=64, event_batch=4,
            mesh=None if mode == "dynamic" else jmesh.make_mesh(8))
    return d["jax"][key]


def _port_trigger(d, mode):
    proc = TriggerProcessing(
        d["raw"], d["rpath" if mode == "residual" else "tpath"],
        filter_data=d["fpath"], verbose=False, device="cpu")
    if mode == "dynamic":
        proc.set_dynamic_threshold(
            "chan1", lambda m: torch.where(m > 1e4, 400.0, 250.0))
    if mode == "salted":
        s = Salting(d["fpath"], verbose=False)
        s.set_dataframe(d["salts"])
        proc.set_salting(s.make_device_injector(["chan1"]))
    return proc


@pytest.mark.parametrize("mode", ["plain", "residual", "dynamic", "salted"])
@pytest.mark.parametrize("event_batch", [4, 2])
def test_trigger_shell_mesh_matches_jax(dataset, mode, event_batch):
    proc = _port_trigger(dataset, mode)
    got = proc.process(capacity=64, event_batch=event_batch,
                       dtype=np.float64, mesh=_mesh())
    assert_shell_equal(got, _jax_trigger(dataset, mode), mode)
    assert proc.stats["events"] == NEV
    single = _port_trigger(dataset, mode).process(
        capacity=64, event_batch=event_batch, dtype=np.float64)
    _same(got, single, mode)
    if mode == "salted":
        ti, ev = got["trigger_index"], got["event_number"]
        for e in range(1, NEV + 1):
            assert np.any(np.abs(ti[ev == e] - (52100 - 100 * e)) <= 5)


def test_trigger_shell_mesh_float32_uploads_each_shard(dataset):
    """In float32 the mesh run uploads every event once, as stored, and
    gives the run without a mesh's table."""
    proc = _port_trigger(dataset, "plain")
    got = proc.process(capacity=64, event_batch=7, mesh=_mesh())
    want = _port_trigger(dataset, "plain").process(capacity=64,
                                                   event_batch=7)
    assert proc.stats["upload_samples"] == NEV * L
    _same(got, want, "float32")


def _jax_features(d, mode):
    key = ("feature", mode)
    if key not in d["jax"]:
        fp = JaxFP(d["raw"], d["fcfg" if mode == "trigger" else "full"],
                   filter_data=d["fd"],
                   trigger_dataframe=(_jax_trigger(d, "plain")
                                      if mode == "trigger" else None),
                   verbose=False)
        d["jax"][key] = fp.process(batch_size=7, dtype=np.float64,
                                   mesh=jmesh.make_mesh(8))
    return d["jax"][key]


def _port_features(d, mode):
    return FeatureProcessing(
        d["raw"], d["fcfg" if mode == "trigger" else "full"],
        filter_data=d["fpath"],
        trigger_table=(_jax_trigger(d, "plain") if mode == "trigger"
                       else None), verbose=False, device="cpu")


@pytest.mark.parametrize("mode", ["trigger", "full"])
@pytest.mark.parametrize("batch_size", [7, 3])
def test_feature_shell_mesh_matches_jax(dataset, mode, batch_size):
    got = _port_features(dataset, mode).process(
        batch_size=batch_size, dtype=np.float64, mesh=_mesh())
    want = _jax_features(dataset, mode)
    assert len(want) == (3 * NEV if mode == "trigger" else NEV)
    cases.assert_tables_equal(got, want, mode)
    _same(got, _port_features(dataset, mode).process(
        batch_size=batch_size, dtype=np.float64), mode)


def test_feature_shell_mesh_with_the_device_injector(dataset):
    """The salt plan goes with each shard's rows: the salted mesh run
    equals the salted run without a mesh, and finds the salts."""
    def run(mesh):
        fp = _port_features(dataset, "full")
        s = Salting(dataset["fpath"], verbose=False)
        s.set_dataframe(dataset["salts"])
        fp.set_salting(s.make_device_injector(["chan1"]))
        return fp.process(batch_size=5, dtype=np.float64, mesh=mesh)
    got = run(_mesh())
    _same(got, run(None), "salted")
    plain = _port_features(dataset, "full").process(batch_size=5,
                                                    dtype=np.float64)
    assert np.all(got["integral_chan1"] > plain["integral_chan1"])


def test_feature_shell_mesh_resume(dataset, tmp_path):
    """A mesh run cut after 2 rows, then resumed with the mesh: its dumps
    hold the uncut run's table."""
    kw = dict(batch_size=3, dtype=np.float64, lgc_save=True,
              nb_events_per_dump=2, series_name="I1_D20260903_T110000",
              mesh=_mesh())
    whole = _port_features(dataset, "trigger").process(
        output_path=str(tmp_path / "whole"), **kw)
    cut = str(tmp_path / "cut")
    _port_features(dataset, "trigger").process(nevents=2, output_path=cut,
                                               **kw)
    rest = _port_features(dataset, "trigger").process(output_path=cut,
                                                      resume=True, **kw)
    nrow = len(whole["event_number"])
    assert len(rest["event_number"]) == nrow - 2
    _same(rest, {k: v[2:] for k, v in whole.items()}, "resume")

    def dumps(path):
        return tables.concat_tables([
            tables.read_table(os.path.join(path, f))
            for f in sorted(os.listdir(path)) if "_F" in f])
    _same(dumps(cut), dumps(str(tmp_path / "whole")), "dumps")


@pytest.mark.parametrize("window", [None, "hann"])
def test_noise_mesh_matches_jax(dataset, window):
    """calc_psd/calc_csd with mesh= (kept randoms split over the shards,
    one psum) equal JAX's with its mesh (zero-padded batch) and the
    port's without a mesh."""
    def randoms(noise):
        noise.generate_randoms(random_rate=300.0, seed=4,
                               min_separation_msec=1.0,
                               edge_exclusion_msec=1.0)
        return noise

    kw = dict(trace_length_samples=NT, pretrigger_length_samples=NT // 2,
              dtype=np.float64, window=window)
    jn = randoms(JaxNoise(dataset["raw"], verbose=False))
    jn.calc_psd("chan1", mesh=jmesh.make_mesh(8), **kw)
    jn.calc_csd(["chan1"], mesh=jmesh.make_mesh(8), **kw)
    out = {}
    for name, mesh in (("mesh", _mesh()), ("single", None)):
        tn = Noise(dataset["raw"], verbose=False, device="cpu")
        randoms(tn).calc_psd("chan1", mesh=mesh, **kw)
        tn.calc_csd(["chan1"], mesh=mesh, **kw)
        out[name] = (tn.get_psd("chan1")[0], tn.get_csd("chan1")[0])
    assert out["mesh"][0].shape == (NT,)
    np.testing.assert_allclose(out["mesh"][0], jn.get_psd("chan1")[0],
                               rtol=1e-9)
    np.testing.assert_allclose(out["mesh"][1], jn.get_csd("chan1")[0],
                               rtol=1e-9)
    for a, b in zip(out["mesh"], out["single"]):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_cli_mesh_devices_chain(dataset, tmp_path, capsys):
    """--mesh-devices 4 --device cpu routes the command line's trigger and
    feature chain through the mesh: the tables of the run without a mesh,
    and the JAX test's physics."""
    raw_dir = os.path.dirname(dataset["raw"][0])
    outs = {}
    for name, extra in (("mesh", ["--mesh-devices", "4"]), ("single", [])):
        out = str(tmp_path / name)
        assert cli.main(["--raw_path", raw_dir, "--processing_setup",
                         dataset["setup"], "--output_group_path", out,
                         "--output-series-name", "I1_D20260901_T000000",
                         "--enable-trig", "--enable-feature", "--quiet",
                         "--device", "cpu", *extra]) == 0
        outs[name] = {sub: tables.concat_tables([
            tables.read_table(os.path.join(out, sub, f))
            for f in sorted(os.listdir(os.path.join(out, sub)))
            if f.endswith(".hdf5")]) for sub in ("trigger", "feature")}
    capsys.readouterr()
    for sub in ("trigger", "feature"):
        assert sorted(outs["mesh"][sub]) == sorted(outs["single"][sub])
        for col in outs["single"][sub]:
            g = np.asarray(outs["mesh"][sub][col])
            w = np.asarray(outs["single"][sub][col])
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=col)
            else:
                assert list(g) == list(w), col
    feat = outs["mesh"]["feature"]
    assert tables.table_rows(feat) == 3 * NEV
    amps = np.asarray(feat["amp_of1x1_nodelay_chan1"])
    assert np.all((amps > 15e-6) & (amps < 32e-6))
