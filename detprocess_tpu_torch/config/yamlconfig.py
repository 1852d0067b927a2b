"""Processing-config normalization.

Copy of the body of ``detprocess_tpu/config/yamlconfig.py::YamlConfig``
after its ``yaml.load`` (the reference's detprocess/process/config.py),
as functions of the loaded dict, so that the feature shell takes a config
without yaml:

- :func:`normalize_config` splits the dict into global / salting / feature
  / didv / noise / template / trigger sections (bare top-level channels
  belong to ``feature``), migrates obsolete keys, merges ``include``
  files, expands ``,`` and ``all`` channel keys, drops disabled channels
  and algorithms, inherits trace lengths global → channel → algorithm
  (msec → samples with the sample rate) and adds the feature section's
  ``traces_config`` and ``weights``;
- :func:`load_yaml` reads a setup file with duplicate keys refused: a
  ``.json`` file with ``json`` (JSON is a subset of YAML, so the JAX
  package reads the same file through PyYAML), any other through PyYAML,
  imported inside the function: the core never needs it;
- :func:`write_json_setup` writes a setup dict as JSON that PyYAML reads
  back as the same dict (a float keeps a decimal point, which YAML 1.1
  needs to read ``1e-05`` as a number).
"""

from __future__ import annotations

import copy
import json
from typing import Optional, Sequence

from detprocess_tpu_torch.utils import channels as chutils
from detprocess_tpu_torch.utils.misc import unique_list

CONFIGURATION_FIELDS = ["salting", "feature", "didv", "noise", "template",
                        "trigger"]

OVERALL_PARAMETERS = {
    "global": ["filter_file", "didv_file"],
    "trigger": ["coincident_window_msec", "coincident_window_samples"],
    "salting": ["dm_pdf_file", "pdf_file", "pdf_xrange_kev",
                "coincident_salts", "coincident", "energies", "nsalt",
                "do_salt_deadtime", "energy_norm_ev_per_amp",
                "channel_fractions", "template_tag",
                "min_separation_msec", "edge_exclusion_msec"],
    "feature": ["trace_length_samples", "pretrigger_length_samples",
                "trace_length_msec", "pretrigger_length_msec"],
}

OBSOLETE_KEYS = {
    "trigger_name": "trigger_channel",
    "nb_samples": "trace_length_samples",
    "nb_pretrigger_samples": "pretrigger_length_samples",
    "template_time_tags": "template_group_ids",
    "psd_tag": "csd_tag",
    "noise_tag": "csd_tag",
    "deadtime_salt": "do_salt_deadtime",
}


def convert_length_msec_to_samples(length_msec: float, fs: float) -> int:
    """msec → samples (rounded to the nearest)."""
    return int(round(length_msec * 1e-3 * fs))


def _duplicate_key(key) -> ValueError:
    return ValueError(f'Duplicate key "{key}" found in the yaml file for '
                      f"the same channel and algorithm — not allowed")


def _unique_pairs(pairs) -> dict:
    """A JSON object's pairs as a dict, a repeated key refused."""
    mapping = {}
    for key, value in pairs:
        if key in mapping:
            raise _duplicate_key(key)
        mapping[key] = value
    return mapping


def load_yaml(path: str) -> dict:
    """The setup file at ``path`` as a dict: ``.json`` through ``json``,
    anything else through PyYAML; a key repeated within one mapping is
    refused."""
    if path.lower().endswith(".json"):
        with open(path) as f:
            return json.load(f, object_pairs_hook=_unique_pairs)

    import yaml
    from yaml.loader import SafeLoader

    class UniqueKeyLoader(SafeLoader):
        def construct_mapping(self, node, deep=False):
            if not isinstance(node, yaml.MappingNode):
                raise yaml.constructor.ConstructorError(
                    None, None,
                    f"expected a mapping node, but found {node.id}",
                    node.start_mark)
            mapping = {}
            for key_node, value_node in node.value:
                key = self.construct_object(key_node, deep=deep)
                if key in mapping:
                    raise _duplicate_key(key)
                mapping[key] = self.construct_object(value_node, deep=deep)
            return mapping

    with open(path) as f:
        return yaml.load(f, Loader=UniqueKeyLoader)


def _json_text(value) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_json_text(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_json_text(v) for v in value) + "]"
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        value = value.item()          # numpy scalars
    if isinstance(value, float) and not isinstance(value, bool):
        if value != value or value in (float("inf"), float("-inf")):
            raise ValueError(f"a setup holds no {value}: JSON has no such "
                             "number")
        text = repr(value)
        mant, _, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        return mant + ("e" + (exp if exp[0] in "+-" else "+" + exp)
                       if exp else "")
    return json.dumps(value)


def write_json_setup(config: dict, path: str) -> str:
    """Write ``config`` as a JSON setup file that ``load_yaml`` and
    PyYAML read back as ``config``; returns ``path``."""
    with open(path, "w") as f:
        f.write(_json_text(config) + "\n")
    return path


def _rename_key_recursively(d, old_key, new_key):
    if not isinstance(d, dict):
        return d
    for key in list(d.keys()):
        if isinstance(d[key], dict):
            _rename_key_recursively(d[key], old_key, new_key)
        if key == old_key:
            d[new_key] = d.pop(old_key)
    return d


def normalize_config(yaml_dict: dict,
                     available_channels: Sequence[str] | str,
                     sample_rate: Optional[float] = None) -> dict:
    """The normalized config ``{"global": …, "salting": …, "feature": …,
    …}`` of a loaded processing-config dict (the dict is not changed)."""
    if not yaml_dict:
        raise ValueError("No configuration loaded — empty yaml file?")
    if isinstance(available_channels, str):
        available_channels = [available_channels]
    available_channels = list(available_channels)
    yaml_dict = copy.deepcopy(yaml_dict)

    if "include" in yaml_dict:
        include_files = yaml_dict.pop("include")
        if isinstance(include_files, str):
            include_files = [include_files]
        for afile in include_files:
            yaml_dict.update(load_yaml(afile))

    for old_key, new_key in OBSOLETE_KEYS.items():
        yaml_dict = _rename_key_recursively(yaml_dict, old_key, new_key)

    configs = {"global": {}}
    for field in CONFIGURATION_FIELDS:
        configs[field] = {"overall": {}, "channels": {}}

    for param in OVERALL_PARAMETERS["global"]:
        configs["global"][param] = yaml_dict.pop(param, None)

    for field in CONFIGURATION_FIELDS:
        if field not in yaml_dict:
            continue
        field_map = {"overall": {}, "channels": {}}
        overall_params = OVERALL_PARAMETERS.get(field, [])
        config_dict = yaml_dict.pop(field)
        for key, items in config_dict.items():
            if key in overall_params or not isinstance(items, dict):
                # channel configs are mappings; scalars at section level
                # are overall parameters even when not declared
                field_map["overall"][key] = items
            elif field == "feature" and key == "global":
                field_map["overall"].update(items)
            else:
                field_map["channels"][key] = items
        configs[field] = field_map

    # remaining top-level keys are feature config (short-hand form)
    for param, val in yaml_dict.items():
        if param == "global":
            # merged, so that lengths parsed from the feature section stay
            configs["feature"]["overall"].update(copy.deepcopy(val))
        else:
            configs["feature"]["channels"][param] = copy.deepcopy(val)

    # expand ','-separated and 'all' channel keys
    for field in CONFIGURATION_FIELDS:
        new_channels = {}
        for chan, chan_dict in configs[field]["channels"].items():
            if isinstance(chan_dict, dict) and (
                    chan_dict.get("disable", False)
                    or chan_dict.get("run") is False):
                continue
            if chan == "all":
                for single in available_channels:
                    new_channels[single] = copy.deepcopy(chan_dict)
            else:
                split, _ = chutils.split_channel_name(
                    chan, available_channels, separator=",")
                for sub in split:
                    new_channels[sub] = copy.deepcopy(chan_dict)
        configs[field]["channels"] = new_channels

    configs["feature"] = _configure_features(
        configs["feature"], configs["global"], available_channels,
        sample_rate)
    configs["trigger"] = _configure_triggers(
        configs["trigger"], configs["global"], available_channels)
    configs["salting"] = _configure_salting(
        configs["salting"], configs["global"], available_channels)
    return configs


def _resolve_lengths(cfg, nb_samples, nb_pretrigger, sample_rate):
    def msec_to_samples(msec):
        if sample_rate is None:
            raise ValueError(
                "sample rate is required when trace length is in msec")
        return convert_length_msec_to_samples(msec, sample_rate)

    if "trace_length_samples" in cfg:
        nb_samples = cfg["trace_length_samples"]
    elif "trace_length_msec" in cfg:
        nb_samples = msec_to_samples(cfg["trace_length_msec"])
    if "pretrigger_length_samples" in cfg:
        nb_pretrigger = cfg["pretrigger_length_samples"]
    elif "pretrigger_length_msec" in cfg:
        nb_pretrigger = msec_to_samples(cfg["pretrigger_length_msec"])
    return nb_samples, nb_pretrigger


def _configure_features(feature_config, global_config, available_channels,
                        sample_rate):
    feature_dict = copy.deepcopy(feature_config)
    for key, val in (global_config or {}).items():
        feature_dict["overall"].setdefault(key, val)

    split_channel_list = []
    for chan in list(feature_dict["channels"].keys()):
        chan_config = feature_dict["channels"][chan]
        if not isinstance(chan_config, dict):
            raise ValueError(
                f"Channel {chan} has no configuration — remove it from "
                f"the yaml file or disable it")
        split_chans, _ = chutils.split_channel_name(chan, available_channels)
        split_channel_list.extend(split_chans)

        nb_samples, nb_pretrigger = _resolve_lengths(
            feature_dict["overall"], None, None, sample_rate)
        nb_samples, nb_pretrigger = _resolve_lengths(
            chan_config, nb_samples, nb_pretrigger, sample_rate)
        if nb_samples is not None and nb_pretrigger is None:
            raise ValueError(
                f'Missing "pretrigger_length_samples" for channel {chan}')
        if nb_samples is None and nb_pretrigger is not None:
            raise ValueError(
                f'Missing "trace_length_samples" for channel {chan}')

        algorithm_list = []
        for algo in list(chan_config.keys()):
            algo_config = chan_config[algo]
            if not isinstance(algo_config, dict):
                continue
            if "run" not in algo_config:
                raise ValueError(
                    f'Missing "run" parameter for channel {chan}, '
                    f"algorithm {algo}")
            if not algo_config["run"]:
                chan_config.pop(algo)
                continue
            algorithm_list.append(algo)
            nb_s, nb_p = _resolve_lengths(algo_config, nb_samples,
                                          nb_pretrigger, sample_rate)
            if nb_s is not None and nb_p is None:
                raise ValueError(
                    f'Missing "pretrigger_length_samples" for channel '
                    f"{chan}, algorithm {algo}")
            if nb_s is None and nb_p is not None:
                raise ValueError(
                    f'Missing "trace_length_samples" for channel '
                    f"{chan}, algorithm {algo}")
            algo_config["nb_samples"] = nb_s
            algo_config["nb_pretrigger_samples"] = nb_p

        if not algorithm_list:
            feature_dict["channels"].pop(chan)
        else:
            chan_config.pop("trace_length_samples", None)
            chan_config.pop("pretrigger_length_samples", None)

    feature_dict["channel_list"] = unique_list(split_channel_list)

    # trace groups and weights
    traces_config = {}
    weights = {}
    for chan, chan_config in feature_dict["channels"].items():
        chan_list, _ = chutils.split_channel_name(
            chan, feature_dict["channel_list"])
        for sub in chan_list:
            param = f"weight_{sub}"
            if param in chan_config:
                weights.setdefault(chan, {})[param] = chan_config[param]
        for algo, algo_config in chan_config.items():
            if not isinstance(algo_config, dict) or not algo_config.get(
                    "run"):
                continue
            key = (algo_config["nb_samples"],
                   algo_config["nb_pretrigger_samples"])
            traces_config.setdefault(key, []).extend(chan_list)
    for key in traces_config:
        traces_config[key] = unique_list(traces_config[key])
    feature_dict["traces_config"] = traces_config or None
    feature_dict["weights"] = weights
    return feature_dict


def _configure_triggers(trigger_config, global_config, available_channels):
    trigger_dict = copy.deepcopy(trigger_config)
    for key, val in (global_config or {}).items():
        trigger_dict["overall"].setdefault(key, val)

    split_channel_list = []
    trigger_channel_dict = {}
    for chan, chan_config in trigger_dict["channels"].items():
        if not isinstance(chan_config, dict):
            raise ValueError(
                f"Channel {chan} has no configuration — remove it from "
                f"the yaml file or disable it")
        split_chans, _ = chutils.split_channel_name(chan, available_channels)
        split_channel_list.extend(split_chans)

        chan_config = copy.deepcopy(chan_config)
        trigger_channel = chan_config.pop("trigger_channel", chan)
        if "run" in chan_config:
            if not chan_config["run"]:
                continue
            chan_config["channel_name"] = chan
            trigger_channel_dict[trigger_channel] = chan_config
        else:
            for algo, algo_dict in chan_config.items():
                if not isinstance(algo_dict, dict) or "run" not in algo_dict:
                    raise ValueError(
                        f'Missing "run" parameter for trigger channel '
                        f"{chan}")
                if not algo_dict["run"]:
                    continue
                algo_dict["channel_name"] = chan
                trigger_channel_dict[f"{algo}_{trigger_channel}"] = algo_dict

    trigger_dict["channels"] = trigger_channel_dict
    trigger_dict["channel_list"] = unique_list(split_channel_list)
    return trigger_dict


def _configure_salting(salting_config, global_config, available_channels):
    salting_dict = copy.deepcopy(salting_config)
    for key, val in (global_config or {}).items():
        salting_dict["overall"].setdefault(key, val)
    split_channel_list = []
    for chan, chan_config in salting_dict["channels"].items():
        if not isinstance(chan_config, dict):
            raise ValueError(
                f"Channel {chan} has no configuration — remove it from "
                f"the yaml file or disable it")
        split_chans, _ = chutils.split_channel_name(chan, available_channels)
        split_channel_list.extend(split_chans)
    salting_dict["channel_list"] = unique_list(split_channel_list)
    return salting_dict
