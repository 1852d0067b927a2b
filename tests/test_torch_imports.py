"""detprocess_tpu_torch runs where JAX, h5py, pandas and yaml are missing.

The machine with the GPU has none of them, so the port and
``chip_smoke.py`` must import and run the feature and trigger steps
without them. A subprocess blocks each (``sys.modules[name] = None`` makes
any import of it raise) and then imports every module of the port and
runs the CPU feature step, the CPU trigger step (on the first 200000
samples of one event of ``trigger_entry``'s batch), the feature shell
of ``feature_processing_entry`` on flat int16 dumps it writes into the
test's directory, the trigger shell of ``trigger_processing_entry``
(two continuous events of 400,000 samples, the pulses scaled down to
fit), the shell of ``feature_coverage_entry`` (every feature
algorithm, two events) and the filter generation of
``filter_generation_entry`` (two continuous events of 200,000 samples,
16 randoms of 4096 samples) chained into the feature shell, and the
salting chain of ``salting_chain_entry`` (two continuous events of
400,000 samples, one salt at each amplitude) through both shells with the
device injector, and the trigger modes (the trigger shell with a dynamic
window on one channel, a step at pileup window 0, template alignment and
the host loop of the dynamic mode); another runs the IV/dIdV sweep
(``ivsweep_entry`` and ``run_ivsweep`` at a cut size), the dIdV branch
of filter generation and ``FilterBuilder`` with the same modules blocked
(and checks that scipy is not imported); a third runs ``chip_smoke.py``,
which must fail without a GPU and print no result; a fourth, with
matplotlib blocked too, runs the three command lines of
``cli_chain_entry`` (filter generation and randoms; salting with the
device injector, trigger and features; the IV sweep) on a flat raw group
with JSON setups and npz outputs, through ``cli.main`` and once through
``python -m detprocess_tpu_torch.cli``. The filter-generation,
salting, dIdV and sweep entry points and classes refuse to run without a
GPU when no device is given, and so does the command line without
``--device cpu``, before it writes anything.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "detprocess_tpu", "h5py", "pandas", "yaml")

PRELUDE = "import sys\n" + "".join(
    f"sys.modules[{name!r}] = None\n" for name in BLOCKED)

RUN_STEP = textwrap.dedent("""
    import importlib, json, os, pkgutil
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import detprocess_tpu_torch
    names = []
    for info in pkgutil.walk_packages(detprocess_tpu_torch.__path__,
                                      "detprocess_tpu_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    from detprocess_tpu_torch.entry import entry, trigger_entry
    step, (x,) = entry("cpu", torch.float64)
    out = step(x)
    tstep, (tx,) = trigger_entry("cpu", torch.float64)
    ts, ts2 = tstep(tx[:1, :, :200000])
    from detprocess_tpu_torch.entry import feature_processing_entry
    shell, index = feature_processing_entry("cpu", SHELL_DIR, nevents=6)
    table = shell.process(batch_size=4, dtype=np.float32, nreaders=2)
    from detprocess_tpu_torch.entry import trigger_processing_entry
    tshell, tindex = trigger_processing_entry(
        "cpu", TRIG_DIR, nevents=2, length=400000, ncoincident=8,
        nsingles=1)
    ttable = tshell.process(event_batch=2, nreaders=2)
    from detprocess_tpu_torch.entry import feature_coverage_entry
    cshell, cindex, _ = feature_coverage_entry("cpu", COV_DIR, nevents=2)
    ctable = cshell.process(batch_size=2, dtype=np.float32)
    from detprocess_tpu_torch import entry as E
    from detprocess_tpu_torch.pipelines.features import FeatureProcessing
    proc, findex, art = E.filter_generation_entry(
        "cpu", FG_DIR, nevents=2, length=200000, nrandoms=16, n=4096,
        pretrig=2048, nfiles=2)
    fdata = proc.process(seed=0)
    paths, _, _ = E.write_shell_dumps(CHAIN_DIR, torch.Generator(), 4, 1,
                                      "cpu", n=4096, pretrig=2048)
    fcfg = E.shell_config(4096, 2048)
    del fcfg["feature"][E.SHELL_COMPOUND]
    chain = FeatureProcessing(E.shell_index(paths, 4096, 2048), fcfg, fdata,
                              verbose=False, device="cpu").process(
        batch_size=4, dtype=np.float32)
    sal, sshell, sfshell, sindex = E.salting_chain_entry(
        "cpu", SALT_DIR, nevents=2, length=400000, nsalt=1)
    stable = sshell.process(event_batch=2)
    sfeats = sfshell.process(batch_size=8, dtype=np.float32)
    from detprocess_tpu_torch.ops import trigger as T
    from detprocess_tpu_torch.models.pulse import make_template
    from detprocess_tpu_torch.pipelines.trigger_step import TriggerStep
    tshell.set_dynamic_threshold("chan3", E.trigger_shell_window_fn)
    dtable = tshell.process(event_batch=2)
    sts, _ = TriggerStep(tstep.kernel, None, 5.0, 0, device="cpu",
                         dtype=torch.float64)(tx[:1, :, :200000])
    tm = make_template(E.FS, 1024, 256, A=1.0, tau_r=20e-6, tau_f1=200e-6)
    _, shifts = T.shift_templates_to_match_chi2(
        E.FS, tm, [np.roll(tm, 11)], np.full(1024, 1e-20, complex),
        block=4096, device="cpu")
    hidx, _, _ = T.find_triggers_dynamic(
        np.array([0.0, 30.0, 0.0, 0.0, 40.0]), np.ones((1, 5)), 10.0,
        lambda m: 3 if m > 35 else 1)
    print(json.dumps({
        "modes": [len(dtable["trigger_index"]) >= 2 * 13,
                  list(sts.indices.shape),
                  shifts.tolist(), hidx.tolist()],
        "salting": [len(sindex), sorted(os.listdir(SALT_DIR)),
                    len(sal.get_dataframe()["salt_id"]),
                    len(stable["trigger_index"]) >= 4,
                    sshell.stats["upload_bytes"]
                    == 2 * sshell.stats["upload_samples"]
                    == 2 * 2 * 4 * 400000,
                    len(sfeats["event_number"]),
                    sfshell.stats["upload_bytes"]
                    == 2 * sfshell.stats["upload_samples"],
                    bool(all(np.isfinite(v).all() for k, v in sfeats.items()
                             if k.startswith("amp_")))],
        "filtergen": [len(findex), sorted(os.listdir(FG_DIR)),
                      fdata.channels(), proc.stats["windows"],
                      len(chain["event_number"]),
                      bool(all(np.isfinite(v).all() for k, v in chain.items()
                               if k.startswith(("amp_", "chi2_"))))],
        "coverage": [len(cindex), sorted(os.listdir(COV_DIR)),
                     sum(k.endswith(("_chan1", "_chan2", "_chan3", "_chan4",
                                     "|chan2")) for k in ctable),
                     bool(all(np.isfinite(v).all() for k, v in ctable.items()
                              if v.dtype.kind == "f"))],
        "trigger_shell": [len(tindex), sorted(os.listdir(TRIG_DIR)),
                          sorted(set(ttable["trigger_channel"].tolist())),
                          len(ttable["trigger_index"]) >= 2 * 13,
                          tshell.stats["upload_bytes"]
                          == 2 * tshell.stats["upload_samples"]
                          == 2 * 2 * 4 * 400000],
        "shell": [len(index), sorted(os.listdir(SHELL_DIR)),
                  {k: len(v) for k, v in table.items()
                   if k.startswith(("event_number", "amp_of1x1_nodelay"))},
                  bool(all(np.isfinite(v).all() for k, v in table.items()
                           if k.startswith(("amp_", "chi2_", "t0_")))),
                  shell.stats["upload_bytes"]
                  == 2 * shell.stats["upload_samples"]],
        "trigger": [list(ts.indices.shape), list(ts2.indices.shape),
                    str(tx.device), list(tx.shape),
                    bool(torch.isfinite(ts.dchi2).all())],
        "modules": sorted(names),
        "columns": sorted(out),
        "finite": all(bool(torch.isfinite(v).all()) for v in out.values()),
        "shapes": sorted({tuple(v.shape) for v in out.values()}),
        "leaked": sorted(m for m in sys.modules
                         if m.split(".")[0] in {"jax", "h5py", "pandas",
                                                "yaml", "triton"}
                         and sys.modules[m] is not None),
    }))
""")


def _run(code, cwd=REPO, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_runs_without_jax_h5py_pandas_yaml(tmp_path):
    for sub in ("shell", "trig", "cov", "fg", "chain", "salt"):
        (tmp_path / sub).mkdir()
    proc = _run(PRELUDE + f"SHELL_DIR = {str(tmp_path / 'shell')!r}\n"
                + f"TRIG_DIR = {str(tmp_path / 'trig')!r}\n"
                + f"COV_DIR = {str(tmp_path / 'cov')!r}\n"
                + f"FG_DIR = {str(tmp_path / 'fg')!r}\n"
                + f"CHAIN_DIR = {str(tmp_path / 'chain')!r}\n"
                + f"SALT_DIR = {str(tmp_path / 'salt')!r}\n" + RUN_STEP)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("utils.windows", "utils.channels", "utils.misc",
                 "utils.logging", "config.yamlconfig", "io.filterdata",
                 "io.fastio", "io.rawdata", "io.prefetch", "io.tables",
                 "ops.adc", "ops.autocuts", "pipelines.randoms",
                 "pipelines.noise", "pipelines.template",
                 "pipelines.filtergen", "models.didv",
                 "pipelines.feature_plan",
                 "pipelines.feature_group", "pipelines.features",
                 "io.upload", "pipelines.triggers", "pipelines.oftrigger",
                 "utils.freq", "ops.psdfeatures", "ops.ofnxm", "ops.lm",
                 "ops.pulsefit", "ops.saltinject", "pipelines.salting",
                 "models.tesnoise", "models.ivbias", "ops.lockin",
                 "pipelines.didv", "pipelines.noisemodel",
                 "pipelines.ivsweep"):
        assert f"detprocess_tpu_torch.{name}" in res["modules"], name
    chans = ["chan1", "chan2", "chan3", "chan4"]
    # 7 salts (one at each amplitude) on the 4 channels, one window each
    assert res["salting"] == [
        2, ["flat_I1_D20260101_T120000_F0001.bin"], 28, True, True, 7, True,
        True]
    assert res["filtergen"] == [
        2, [f"flat_I1_D20260101_T180000_F000{i}.bin" for i in (1, 2)],
        chans + ["|".join(chans)], 16, 4, True]
    assert res["coverage"] == [
        2, ["flat_I1_D20260101_T060000_F0001.bin",
            "flat_I1_D20260101_T060000_F0002.bin"], 34, True]
    compound = "chan1+chan2+chan3+chan4"
    assert res["trigger_shell"] == [
        2, ["flat_I1_D20260101_T120000_F0001.bin",
            "flat_I1_D20260101_T120000_F0002.bin"],
        ["chan1", "chan2", "chan3", "chan4"], True, True]
    assert res["shell"] == [
        6, ["flat_I1_D20260101_T000000_F0001.bin",
            "flat_I1_D20260101_T000000_F0002.bin"],
        {"event_number": 6, **{f"amp_of1x1_nodelay_{c}": 6 for c in (
            "chan1", "chan2", "chan3", "chan4", compound)}},
        True, True]
    assert "detprocess_tpu_torch.pipelines.feature_step" in res["modules"]
    assert "detprocess_tpu_torch.ops.cuda_of" in res["modules"]
    for name in ("ops.trigger", "ops.spectral", "pipelines.trigger_step"):
        assert f"detprocess_tpu_torch.{name}" in res["modules"]
    # 17 segments of 12288 samples in tiles of 64: 3264 slots (< 4096)
    assert res["trigger"] == [[1, 3264], [1, 3264], "cpu",
                              [8, 1, 1250000], True]
    # dynamic windows in the shell, a sub-tile step, template alignment
    # and the host loop of the dynamic mode
    assert res["modes"] == [True, [1, 4096], [-12], [4]]
    assert res["leaked"] == []
    assert res["finite"] and res["shapes"] == [[16]]
    assert res["columns"] == sorted(
        [f"{f}_of1x1_nodelay_chan1" for f in ("amp", "chi2", "lowchi2")]
        + [f"{f}_of1x1_unconstrained_chan1"
           for f in ("amp", "t0", "chi2", "lowchi2")]
        + ["baseline_chan1", "integral_chan1"])


RUN_FITS = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import detprocess_tpu_torch as D
    from detprocess_tpu_torch import entry as E
    from detprocess_tpu_torch.pipelines.template import FilterBuilder
    pts = E.ivsweep_points(normal=(400e-6, 350e-6, 300e-6),
                           transition_r0=(0.15, 0.08),
                           sc=(4e-6, 2e-6, 1e-6))
    proc, bps = E.ivsweep_entry("cpu", SWEEP_DIR, points=pts, ntraces=8,
                                n=2048, ndidv=4, nper=2)
    table, ana, noise = E.run_ivsweep(proc, bps)
    sigma = ana._sweep_df["chan1"]["energy_resolution"]
    fg, series, point = E.didv_filtergen_entry(
        "cpu", DIDV_DIR, nseries=2, ndidv=4, nper=2, poles=(2,))
    fd = fg.proces_didv()
    fb = FilterBuilder(verbose=False, device="cpu")
    fb.didv.process_raw_data("chan1", series[sorted(series)[0]],
                             E.IV_SGFREQ, E.IV_SGAMP, E.IV_RSH)
    fb.didv.dofit("chan1", poles=2)
    print(json.dumps({
        "exports": sorted(n for n in ("DIDVAnalysis", "IVSweepProcessing",
                                      "IVSweepAnalysis", "NoiseModel",
                                      "FilterBuilder")
                          if getattr(D, n).__name__ == n),
        "states": list(table["state"]),
        "files": len(os.listdir(SWEEP_DIR)),
        "sigma": int(np.isfinite(sigma).sum()),
        "tload": bool(np.isfinite(noise["tload"])),
        "didv": sorted(k for k in fd.data["chan1"] if "didv" in k),
        "series": len(fd.get_didv_dataframe("chan1")["series_name"]),
        "builder": fb.didv.has("chan1", "didv_results_2poles_fit_default"),
        "leaked": sorted(m for m in sys.modules
                         if m.split(".")[0] in {"jax", "h5py", "pandas",
                                                "yaml", "triton", "scipy"}
                         and sys.modules[m] is not None),
    }))
""")


def test_fits_run_without_jax_h5py_pandas_yaml(tmp_path):
    """The sweep (ivsweep_entry and run_ivsweep at a cut size), the dIdV
    branch of filter generation and FilterBuilder, with the four modules
    blocked; neither they nor scipy are imported."""
    for sub in ("sweep", "didv"):
        (tmp_path / sub).mkdir()
    proc = _run(PRELUDE + f"SWEEP_DIR = {str(tmp_path / 'sweep')!r}\n"
                + f"DIDV_DIR = {str(tmp_path / 'didv')!r}\n" + RUN_FITS)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["exports"] == ["DIDVAnalysis", "FilterBuilder",
                              "IVSweepAnalysis", "IVSweepProcessing",
                              "NoiseModel"]
    assert res["states"] == ["normal"] * 3 + ["transition"] * 2 + ["sc"] * 3
    assert res["files"] == 16 and res["sigma"] == 2 and res["tload"]
    assert res["didv"] == ["didv_processing_default",
                           "didv_results_2poles_biasparams_default",
                           "didv_results_2poles_fit_default",
                           "didv_results_2poles_smallsignalparams_default"]
    assert res["series"] == 2 and res["builder"]
    assert res["leaked"] == []


@pytest.mark.parametrize("which", ["DIDVAnalysis", "IVSweepProcessing",
                                   "FilterBuilder", "ivsweep_entry",
                                   "didv_filtergen_entry"])
def test_fits_trace_work_needs_the_gpu(tmp_path, which):
    """With no device given, the classes and entries of the dIdV and
    sweep path refuse to run without a GPU, before they write anything;
    the fits themselves run on the CPU by design."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from detprocess_tpu_torch import entry
    from detprocess_tpu_torch.pipelines.didv import DIDVAnalysis
    from detprocess_tpu_torch.pipelines.ivsweep import IVSweepProcessing
    from detprocess_tpu_torch.pipelines.template import FilterBuilder

    make = {"DIDVAnalysis": DIDVAnalysis,
            "IVSweepProcessing": IVSweepProcessing,
            "FilterBuilder": FilterBuilder,
            "ivsweep_entry": lambda: entry.ivsweep_entry(
                directory=str(tmp_path / "out")),
            "didv_filtergen_entry": lambda: entry.didv_filtergen_entry(
                directory=str(tmp_path / "out"))}[which]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert not os.path.exists(tmp_path / "out")


def test_chip_smoke_fails_without_a_gpu():
    # runs the script as the GPU machine would, with the same imports
    # blocked; this CPU build of torch has no CUDA device, so the device
    # phase must end the run before any result line
    code = PRELUDE + textwrap.dedent("""
        import runpy
        runpy.run_path("chip_smoke.py", run_name="__main__")
    """)
    proc = _run(code)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


@pytest.mark.parametrize("which", ["FilterDataProcessing", "Noise",
                                   "Randoms", "filter_generation_entry"])
def test_filter_generation_needs_the_gpu(tmp_path, which):
    """With no device given, each refuses to run without a GPU rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from detprocess_tpu_torch import entry
    from detprocess_tpu_torch.io.rawdata import write_flat_dump
    from detprocess_tpu_torch.pipelines.filtergen import FilterDataProcessing
    from detprocess_tpu_torch.pipelines.noise import Noise
    from detprocess_tpu_torch.pipelines.randoms import Randoms

    path = str(tmp_path / f"flat_{entry.FG_SERIES}_F0001.bin")
    write_flat_dump(path, np.zeros((1, 4, 8192), np.int16))
    index = entry.filtergen_index([path], 8192)
    make = {"FilterDataProcessing": lambda: FilterDataProcessing(
                noise_files=index, config=entry.filtergen_config(1024, 512)),
            "Noise": lambda: Noise(index),
            "Randoms": lambda: Randoms(index),
            "filter_generation_entry": lambda: entry.filter_generation_entry(
                directory=str(tmp_path / "fg"))}[which]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert not os.path.exists(tmp_path / "fg")


def test_salting_chain_needs_the_gpu(tmp_path):
    """With no device given, salting_chain_entry refuses to run without a
    GPU, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from detprocess_tpu_torch import entry

    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.salting_chain_entry(directory=str(tmp_path / "salt"))
    assert not os.path.exists(tmp_path / "salt")


RUN_CLI = textwrap.dedent("""
    import json, os, subprocess, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from detprocess_tpu_torch import cli, entry as E
    chain = E.cli_chain_entry(
        "cpu", CLI_DIR, nevents=2, length=400000, nrandoms=32, nsalt=2,
        points=E.ivsweep_points(normal=(400e-6, 350e-6, 300e-6),
                                transition_r0=(0.15, 0.08),
                                sc=(4e-6, 2e-6, 1e-6)),
        ntraces=8, n=2048, ndidv=4, nper=2)
    rcs = [cli.main(chain.a)]
    ff = chain.filter_file()
    rcs.append(cli.main(chain.b(ff)))
    rcs.append(cli.main(chain.c))
    env = dict(os.environ)
    sub = subprocess.run(
        [sys.executable, "-c", PRELUDE_TEXT + "import runpy; "
         "runpy.run_module('detprocess_tpu_torch.cli', run_name='__main__')",
         *chain.b(ff, os.path.join(CLI_DIR, "out2"))],
        capture_output=True, text=True, env=env)
    written = {d: sorted(os.listdir(os.path.join(chain.out, d)))
               for d in sorted(os.listdir(chain.out))}
    print(json.dumps({
        "rcs": rcs, "sub": [sub.returncode, sub.stderr[-2000:]],
        "written": written,
        "out2": sorted(os.listdir(os.path.join(CLI_DIR, "out2"))),
        "filter": os.path.basename(ff),
        "modules": sorted(m for m in sys.modules
                          if m.startswith("detprocess_tpu_torch")),
        "leaked": sorted(m for m in sys.modules
                         if m.split(".")[0] in {"jax", "h5py", "pandas",
                                                "yaml", "matplotlib",
                                                "triton"}
                         and sys.modules[m] is not None),
    }))
""")


def test_command_line_runs_without_jax_h5py_pandas_yaml_matplotlib(tmp_path):
    """The three command lines of ``cli_chain_entry`` (and call B through
    ``python -m detprocess_tpu_torch.cli``) on flat groups with JSON
    setups, npz out, with jax, h5py, pandas, yaml and matplotlib blocked;
    none of them imported."""
    prelude = PRELUDE + "sys.modules['matplotlib'] = None\n"
    import detprocess_tpu_torch.cli  # noqa: F401  (imports here too)
    code = (prelude + f"PRELUDE_TEXT = {prelude!r}\n"
            + f"CLI_DIR = {str(tmp_path / 'cli')!r}\n"
            + "import detprocess_tpu_torch.launch, "
            "detprocess_tpu_torch.pipelines.merge, "
            "detprocess_tpu_torch.utils.plotting\n" + RUN_CLI)
    proc = _run(code, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rcs"] == [0, 0, 0]
    assert res["sub"][0] == 0, res["sub"][1]
    series = "I1_D20260103_T120000"
    assert res["written"] == {
        "feature": [f"feature_features_{series}_F0001.npz",
                    f"feature_features_{series}_summary.json"],
        "filterdata": [res["filter"]],
        "ivsweep": [f"ivsweep_{series}.npz"],
        "randoms": [f"rand_randoms_{series}_F0001.npz",
                    f"rand_randoms_{series}_summary.json"],
        "salting": [f"salting_salting_{series}_F0001.npz"],
        "trigger": [f"threshtrig_trigger_{series}_F0001.npz",
                    f"threshtrig_trigger_{series}_summary.json"]}
    assert res["filter"].startswith("filter_I1_D")
    assert res["filter"].endswith(".npz")
    assert res["out2"] == ["feature", "salting", "trigger"]
    for name in ("cli", "launch", "pipelines.merge", "utils.plotting",
                 "parallel.multihost"):
        assert f"detprocess_tpu_torch.{name}" in res["modules"], name
    assert res["leaked"] == []


def test_command_line_needs_the_gpu(tmp_path):
    """Without ``--device cpu`` the command line takes the GPU and, with
    none, raises before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from detprocess_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--raw_path", str(tmp_path / "raw"), "--enable-trig",
                  "--output_group_path", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")
    argv = ["cli", "--raw_path", str(tmp_path / "raw"),
            "--output_group_path", str(tmp_path / "o2")]
    proc = _run(f"import runpy, sys; sys.argv = {argv!r}; "
                "runpy.run_module('detprocess_tpu_torch.cli', "
                "run_name='__main__')")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "o2")
