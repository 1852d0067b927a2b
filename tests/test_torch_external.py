"""External feature extractors in the port's FeatureProcessing against
the JAX shell's.

The same raw HDF5, filter file and config (tests/torch_feature_cases.py)
go through the JAX ``FeatureProcessing`` with
``examples/processing/custom_extractor.py`` (jnp) and the port's on the
CPU in float64 with ``examples/processing/custom_extractor_torch.py``:
the tables agree at 1e-9, as ``tests/test_rftau_external.py`` holds the
JAX shell. Also: ``external_file=`` overriding the config's, the
registry's rules (duplicates of built-ins refused, the fallback to public
callables), an unknown name refused with the externals listed, a result
of the wrong shape refused, the extractor's layer under ``run_layer``,
and the extractor on two CPU shards of a mesh.
"""

import os

import jax  # noqa: F401  (conftest sets the platform and x64)
import numpy as np
import pytest
import torch
import yaml

from detprocess_tpu.pipelines.features import FeatureProcessing as JaxFP
from detprocess_tpu_torch.parallel import mesh as pmesh
from detprocess_tpu_torch.pipelines import feature_plan
from detprocess_tpu_torch.pipelines.features import FeatureProcessing

import torch_feature_cases as cases

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "processing")
JAX_EXT = os.path.abspath(os.path.join(EXAMPLES, "custom_extractor.py"))
TORCH_EXT = os.path.abspath(os.path.join(EXAMPLES,
                                         "custom_extractor_torch.py"))

CONFIG = {"feature": {
    "trace_length_samples": cases.N,
    "pretrigger_length_samples": cases.PRETRIG,
    "chan1": {
        "of1x1_nodelay": {"run": True},
        "pulse_shape": {"run": True, "tail_fraction_start_usec": 300.0},
        # the short trace group: the extractor gets its pretrigger
        "shape_short": {"run": True, "base_algorithm": "pulse_shape",
                        "trace_length_samples": cases.N_CUT,
                        "pretrigger_length_samples": cases.PRE_CUT},
    },
    "chan2": {"pulse_shape": {"run": True}, "baseline": {"run": True}},
    "chan1+chan2": {"feature_channel": "sum12",
                    "pulse_shape": {"run": True}},
}}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("external"))
    raw, fpath, _ = cases.write_inputs(root)
    cfg = {"feature": {**CONFIG["feature"], "external_file": JAX_EXT}}
    cpath = _yaml(root, "jax.yaml", cfg)
    jdf = JaxFP(raw, cpath, filter_data=fpath, verbose=False).process(
        batch_size=8, dtype=np.float64)
    return dict(root=root, raw=raw, fpath=fpath, jdf=jdf)


def _yaml(root, name, cfg):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _shell(inputs, cfg, **kw):
    return FeatureProcessing(inputs["raw"], cfg, inputs["fpath"],
                             verbose=False, device="cpu", **kw)


def _module(root, name, text):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def test_table_matches_jax(inputs):
    cfg = {"feature": {**CONFIG["feature"], "external_file": TORCH_EXT}}
    got = _shell(inputs, cfg).process(batch_size=8, dtype=np.float64)
    assert "peak_over_area_sum12" in got and "tail_fraction_chan2" in got
    cases.assert_tables_equal(got, inputs["jdf"], "external")


def test_external_file_argument_overrides_the_config(inputs):
    cfg = {"feature": {**CONFIG["feature"],
                       "external_file": "/nonexistent/extractors.py"}}
    got = _shell(inputs, cfg, external_file=TORCH_EXT).process(
        batch_size=8, dtype=np.float64)
    cases.assert_tables_equal(got, inputs["jdf"], "override")
    jdf = JaxFP(inputs["raw"], _yaml(inputs["root"], "bad.yaml", cfg),
                filter_data=inputs["fpath"], external_file=JAX_EXT,
                verbose=False).process(batch_size=8, dtype=np.float64)
    cases.assert_tables_equal(got, jdf, "override, JAX")


def test_duplicate_of_a_builtin_is_refused(inputs):
    path = _module(inputs["root"], "dupe.py",
                   "def baseline(traces, **kw):\n"
                   "    return {}\n"
                   "EXTRACTORS = {'baseline': baseline}\n")
    with pytest.raises(ValueError,
                       match="duplicate built-in algorithms: {'baseline'}"):
        feature_plan.load_external_extractors(path)
    cfg = {"feature": {**CONFIG["feature"], "external_file": path}}
    with pytest.raises(ValueError, match="duplicate built-in"):
        _shell(inputs, cfg)
    with pytest.raises(ValueError, match="duplicate built-in"):
        JaxFP(inputs["raw"], _yaml(inputs["root"], "dupe.yaml", cfg),
              filter_data=inputs["fpath"], verbose=False)


def test_public_callables_without_a_registry(inputs):
    """A module without EXTRACTORS registers its public callables, as
    JAX does; the table agrees with JAX's on the jnp twin."""
    tpath = _module(inputs["root"], "rms_torch.py",
                    "import torch\n"
                    "def rms(traces, fs=None, nb_pretrigger_samples=None,"
                    " **kw):\n"
                    "    return {'rms': traces.pow(2).mean(dim=-1).sqrt()}\n"
                    "def _helper():\n"
                    "    pass\n")
    jpath = _module(inputs["root"], "rms_jax.py",
                    "import jax.numpy as jnp\n"
                    "def rms(traces, fs=None, nb_pretrigger_samples=None,"
                    " **kw):\n"
                    "    return {'rms': jnp.sqrt(jnp.mean(traces**2, "
                    "axis=-1))}\n"
                    "def _helper():\n"
                    "    pass\n")
    assert set(feature_plan.load_external_extractors(tpath)) == {"rms"}
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       "chan1": {"rms": {"run": True}},
                       "chan2": {"rms": {"run": True}}}}
    got = _shell(inputs, cfg, external_file=tpath).process(
        batch_size=8, dtype=np.float64)
    jdf = JaxFP(inputs["raw"], _yaml(inputs["root"], "rms.yaml", cfg),
                filter_data=inputs["fpath"], external_file=jpath,
                verbose=False).process(batch_size=8, dtype=np.float64)
    cases.assert_tables_equal(got, jdf, "rms")


def test_unknown_name_is_refused_with_the_externals(inputs):
    cfg = {"feature": {**CONFIG["feature"], "external_file": TORCH_EXT,
                       "chan2": {"no_such_feature": {"run": True}}}}
    with pytest.raises(ValueError) as port_err:
        _shell(inputs, cfg)
    assert "external: ['pulse_shape']" in str(port_err.value)
    jcfg = {"feature": {**cfg["feature"], "external_file": JAX_EXT}}
    with pytest.raises(ValueError) as jax_err:
        JaxFP(inputs["raw"], _yaml(inputs["root"], "unknown.yaml", jcfg),
              filter_data=inputs["fpath"], verbose=False)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("body", [
    "{'x': traces.mean(dim=-1, keepdim=True)}",      # [B, 1]
    "{'x': traces.mean(dim=-1).numpy()}",            # not a tensor
    "{'x': traces.mean()}",                          # a scalar
])
def test_result_of_the_wrong_shape_is_refused(inputs, body):
    path = _module(inputs["root"], "bad_shape.py",
                   f"def bad(traces, **kw):\n    return {body}\n"
                   "EXTRACTORS = {'bad': bad}\n")
    cfg = {"feature": {"trace_length_samples": cases.N,
                       "pretrigger_length_samples": cases.PRETRIG,
                       "chan1": {"bad": {"run": True}}}}
    shell = _shell(inputs, cfg, external_file=path)
    with pytest.raises(ValueError, match="'bad' on chan1: 'x' is .*the "
                       r"contract is a tensor \[8\]"):
        shell.process(batch_size=8, dtype=np.float64)


def test_extractor_runs_as_a_layer(inputs):
    """The extractor is one layer of ``GroupStep.forward``'s
    ``run_layer`` hook, so that a caller can time it."""
    shell = _shell(inputs, CONFIG, external_file=TORCH_EXT)
    step = shell.group_steps(torch.float64)[-1]
    names = []

    def run(name, fn, *args):
        names.append(name)
        return fn(*args)

    raw = torch.zeros((3, 2, cases.N), dtype=torch.float64)
    raw[:, :, cases.PRETRIG:] = 1.0
    out = step(raw, run_layer=run)
    assert "pulse_shape:chan1" in names and "pulse_shape:chan1+chan2" in names
    assert out["peak_over_area_chan1"].shape == (3,)


def test_extractor_under_a_mesh(inputs):
    cfg = {"feature": {**CONFIG["feature"], "external_file": TORCH_EXT}}
    got = _shell(inputs, cfg).process(
        batch_size=8, dtype=np.float64,
        mesh=pmesh.make_mesh(2, device="cpu"))
    cases.assert_tables_equal(got, inputs["jdf"], "mesh")
