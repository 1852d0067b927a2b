"""Every public name of the JAX package has a counterpart in the port.

Each module of ``detprocess_tpu/`` is parsed with ``ast`` (nothing of it
is imported, so no JAX) and every public top-level function or class,
and every public method of such a class, must exist under the same name
in the port's module of the same path (``detprocess_tpu_torch/...``,
imported). A name is exempt only through :data:`NOT_PORTED`, with its
reason; where a name was ported under another name or module,
:data:`COUNTERPARTS` names it and the test checks that it exists.

The keywords of every ``__init__`` and ``process`` of the JAX classes
must be keywords of the port's, so that a new JAX argument cannot be
missed silently; the port's deliberate renames are
:data:`KEYWORD_RENAMES` (the new name must exist), and keywords of TPU
workarounds are in :data:`NOT_PORTED_KEYWORDS`.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "detprocess_tpu"

_LAYOUTS = ("TPU workaround (ROADMAP §2c): the permuted and packed "
            "layouts of the four-step matmul FFT; the port runs on the "
            "natural half spectrum")
_MARSHAL = ("TPU workaround (ROADMAP §2c): split re/im and device-bank "
            "marshalling; the port keeps complex tensors on the device")
_FOUR_STEP = ("TPU workaround (ROADMAP §2c): the four-step matmul FFT and "
              "its precision contexts; the port uses torch.fft and the "
              "hand-written rFFT kernel")
_JAXCACHE = ("TPU workaround (ROADMAP §2c): JAX's persistent compilation "
             "cache; the port's kernels are built by nvcc (ops/_kernels)")

# "module path::name" → why the port has no counterpart under that name
NOT_PORTED = {
    **{f"ops/fft.py::{n}": _FOUR_STEP for n in (
        "const_complex", "fft", "ifft", "current_matmul_precision",
        "einsum", "matmul_precision")},
    **{f"ops/fft.py::{n}": _LAYOUTS for n in (
        "perm_split", "perm_indices", "half_perm_indices", "unperm_indices",
        "half_unperm_indices", "site_perm_indices", "site_half_perm_indices",
        "site_unperm_indices", "site_packed", "fft_perm", "ifft_fromperm",
        "packed_spectrum", "rfft_perm", "untangle_coeffs",
        "packed_multiply_coeffs", "untangle_pair", "irfft_fromperm")},
    **{f"ops/filterbank.py::{n}": _MARSHAL for n in (
        "split_complex", "join_complex", "OF1x1Bank.nslots",
        "OF1x1Bank.as_dtype", "OF1x1Bank.to_device", "OFNxMBank.to_device",
        "OFNxMBank.as_dtype", "DeviceBank1x1", "device_bank_1x1",
        "DeviceBank1x1Half", "device_bank_1x1_half", "DeviceBankNxM",
        "device_bank_nxm")},
    **{f"ops/filterbank.py::{n}": _LAYOUTS for n in (
        "permute_half_bank", "packed_half_coeffs", "packed_low_table",
        "packed_nxm_coeffs", "permute_nxm_bank")},
    **{f"ops/of1x1.py::{n}": _LAYOUTS for n in (
        "signal_fft_perm", "signal_rfft_perm", "of1x1_withdelay_half_perm",
        "DevicePacked1x1", "device_packed_1x1", "chi2_base_packed",
        "of1x1_nodelay_packed", "of1x1_withdelay_packed")},
    **{f"ops/ofnxm.py::{n}": _LAYOUTS for n in (
        "DevicePackedNxM", "device_packed_nxm", "chi2_base_nxm_packed",
        "ofnxm_nodelay_packed", "ofnxm_withdelay_packed")},
    **{f"ops/spectral.py::{n}": _LAYOUTS for n in (
        "periodogram_perm", "welch_psd_packed", "welch_csd_packed")},
    "pipelines/features.py::FeatureProcessing.device_banks": _MARSHAL,
    "utils/jaxcache.py::enable": _JAXCACHE,
    "utils/jaxcache.py::fingerprint": _JAXCACHE,
    "ops/pallas_fft.py::fft_pallas": (
        "a Pallas kernel: written by hand for Hopper as csrc/rfft.cu"),
    "ops/pallas_of.py::FusedNodelayOF": (
        "a Pallas kernel: written by hand for Hopper as "
        "csrc/fused_nodelay_of.cu"),
    "ops/trigger.py::residual_subtract": (
        "a route with the same results: the port subtracts by "
        "convolution"),
    "ops/trigger.py::find_triggers_sharded_tiled": (
        "a route with the same results: the port's sharded merge takes "
        "every pileup window"),
}

# "module path::name" of NOT_PORTED → the port's counterpart
COUNTERPARTS = {
    "ops/pallas_fft.py::fft_pallas": "ops/cuda_fft.py::rfft_kernel",
    "ops/pallas_of.py::FusedNodelayOF": "ops/cuda_of.py::FusedNodelayOF",
    "ops/trigger.py::residual_subtract":
        "ops/trigger.py::residual_subtract_conv",
    "ops/trigger.py::find_triggers_sharded_tiled":
        "ops/trigger.py::find_triggers_sharded",
}

# JAX keyword → (the port's keyword, why)
KEYWORD_RENAMES = {
    "raw_files": ("raw", "the port takes a RawIndex as well as raw paths"),
    "trigger_dataframe": ("trigger_table", "the port's tables are dicts of "
                          "numpy columns, not DataFrames"),
    "salt_df": ("salt_table", "the port's tables are dicts of numpy "
                "columns, not DataFrames"),
    "files": ("index", "RawReader takes a RawIndex as well as raw paths"),
}

NOT_PORTED_KEYWORDS = {
    "auto_prewarm": ("TPU workaround (ROADMAP §2c): the background compile "
                     "of XLA executables"),
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_ROOT))
                  for p in JAX_ROOT.rglob("*.py"))


def _port_module(rel: str):
    name = "detprocess_tpu_torch." + rel[:-3].replace("/", ".")
    name = name[:-len(".__init__")] if name.endswith(".__init__") else name
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None


def _public_names(tree: ast.Module):
    """Public top-level functions and classes, and the public methods
    and properties of each such class ("Class.method")."""
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and not node.name.startswith("_")):
            yield node.name, node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if (isinstance(m, ast.FunctionDef)
                            and not m.name.startswith("_")):
                        yield f"{node.name}.{m.name}", m


def _resolve(module, dotted: str):
    obj = module
    for part in dotted.split("."):
        if obj is None or not hasattr(obj, part):
            return None
        obj = getattr(obj, part)
    return obj


def _tree(rel: str) -> ast.Module:
    return ast.parse((JAX_ROOT / rel).read_text())


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    port = _port_module(rel)
    missing = []
    for name, _ in _public_names(_tree(rel)):
        key = f"{rel}::{name}"
        if key in NOT_PORTED:
            continue
        if port is None or _resolve(port, name) is None:
            missing.append(name)
    assert not missing, (
        f"detprocess_tpu/{rel}: no counterpart in detprocess_tpu_torch/{rel} "
        f"for {missing}; port them, or list each in NOT_PORTED with its "
        "reason")


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_keyword_is_taken(rel):
    port = _port_module(rel)
    missing = []
    for name, node in _public_names(_tree(rel)):
        if not isinstance(node, ast.ClassDef):
            continue
        for m in node.body:
            if not (isinstance(m, ast.FunctionDef)
                    and m.name in ("__init__", "process")):
                continue
            if f"{rel}::{name}" in NOT_PORTED:
                continue
            fn = _resolve(port, f"{name}.{m.name}")
            assert fn is not None, f"{rel}: {name}.{m.name} not ported"
            taken = set(inspect.signature(fn).parameters)
            args = m.args.posonlyargs + m.args.args + m.args.kwonlyargs
            for arg in args[1:]:
                kw = arg.arg
                if kw in NOT_PORTED_KEYWORDS:
                    continue
                if kw in taken:
                    continue
                if KEYWORD_RENAMES.get(kw, (kw, None))[0] not in taken:
                    missing.append(f"{name}.{m.name}({kw})")
    assert not missing, (
        f"detprocess_tpu/{rel}: the port does not take {missing}; add the "
        "keyword, or list it in KEYWORD_RENAMES or NOT_PORTED_KEYWORDS with "
        "its reason")


def test_every_exemption_is_current():
    """No entry of NOT_PORTED names a JAX name that no longer exists, or
    one that the port has after all; every counterpart exists."""
    names = {f"{rel}::{n}" for rel in _jax_modules()
             for n, _ in _public_names(_tree(rel))}
    assert set(NOT_PORTED) <= names, sorted(set(NOT_PORTED) - names)
    for key, reason in NOT_PORTED.items():
        assert reason.strip(), key
        rel, name = key.split("::")
        port = _port_module(rel)
        assert port is None or _resolve(port, name) is None, (
            f"{key} is ported: take it out of NOT_PORTED")
    for key, target in COUNTERPARTS.items():
        assert key in NOT_PORTED, key
        rel, name = target.split("::")
        assert _resolve(_port_module(rel), name) is not None, target


def test_renamed_keywords_are_taken():
    """Where the port does not take a JAX keyword of KEYWORD_RENAMES, it
    takes the new name; every rename is used somewhere."""
    seen = set()
    for rel in _jax_modules():
        port = _port_module(rel)
        for name, node in _public_names(_tree(rel)):
            if (not isinstance(node, ast.ClassDef)
                    or f"{rel}::{name}" in NOT_PORTED):
                continue
            for m in node.body:
                if not (isinstance(m, ast.FunctionDef)
                        and m.name in ("__init__", "process")):
                    continue
                fn = _resolve(port, f"{name}.{m.name}")
                taken = set(inspect.signature(fn).parameters)
                for arg in m.args.args:
                    if arg.arg in KEYWORD_RENAMES and arg.arg not in taken:
                        new = KEYWORD_RENAMES[arg.arg][0]
                        assert new in taken, (rel, name, arg.arg)
                        seen.add(arg.arg)
    assert seen == set(KEYWORD_RENAMES), set(KEYWORD_RENAMES) - seen


def test_top_level_exports():
    """The JAX package's lazy top-level names (its ``__getattr__``'s
    table and ``cli``) resolve in the port."""
    import detprocess_tpu_torch

    tree = _tree("__init__.py")
    exports = {k.value for node in ast.walk(tree)
               if isinstance(node, ast.Dict) for k in node.keys
               if isinstance(k, ast.Constant)}
    assert {"FeatureProcessing", "YamlConfig"} <= exports
    for name in sorted(exports) + ["cli"]:
        assert getattr(detprocess_tpu_torch, name) is not None, name
