"""The system under test, driven through its public API: the raw index of
the cell's dumps, the filter data the harness hands it, and one of the
two shells, called once a pass over the whole data set."""

from __future__ import annotations

import numpy as np

from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.io.rawdata import RawIndex
from detprocess_tpu_torch.pipelines.features import FeatureProcessing
from detprocess_tpu_torch.pipelines.triggers import TriggerProcessing

from reference import filters


def raw_index(config: dict, paths: list) -> RawIndex:
    chans = config["channels"]
    kw = dict(dtype=np.dtype(config["stored_dtype"]),
              adc_conversion_factor=config["adc_volts_per_bit"],
              detector_config={c: {"close_loop_norm": v} for c, v in
                               zip(chans, config["close_loop_norm"])})
    if config["data_type"] == "continuous":
        kw["data_type"] = "continuous"
    else:
        kw["nb_pretrigger_samples"] = config["nb_pretrigger_samples"]
    return RawIndex.from_flat(paths, chans, config["nb_samples"],
                              config["sample_rate_hz"], config["series"],
                              **kw)


def filter_data(config: dict, traffic: dict) -> FilterData:
    """Each channel's template (tag ``default``) and PSD, at the trigger
    length for continuous data; those of the traffic's compound channels;
    the traffic's named ``filters`` and the CSDs of its
    ``csd_channels``."""
    fs = config["sample_rate_hz"]
    if config["data_type"] == "continuous":
        geo = config["trigger_template"]
        n, pre = geo["nb_samples"], geo["nb_pretrigger_samples"]
    else:
        n, pre = config["nb_samples"], config["nb_pretrigger_samples"]
    tmpl = filters.channel_templates(config, n, pre)
    psd = filters.channel_psds(config, n)
    fd = FilterData(verbose=False)
    named = list(zip(config["channels"], tmpl, psd))
    for comp in traffic.get("compound_filters", []):
        rows = [config["channels"].index(c) for c in comp.split("+")]
        named.append((comp, *filters.compound(tmpl[rows], psd[rows])))
    for chan, t, p in named:
        fd.set_template(chan, t, fs, pretrigger_length_samples=pre)
        fd.set_psd(chan, p, fs)
    for entry in traffic.get("filters", []):
        fd.set_template(entry["channel"], filters.filter_template(
            config, traffic, entry["templates"], n, pre), fs,
            tag=entry["tag"], pretrigger_length_samples=pre)
    for chan in traffic.get("csd_channels", []):
        fd.set_csd(chan, filters.channel_csd(config, traffic, chan, n), fs)
    return fd


class Program:
    """One shell over the cell's dumps. :meth:`run_pass` processes every
    event once and returns (table, units done: rows for features,
    continuous samples of all channels for triggers)."""

    def __init__(self, config: dict, traffic: dict, paths: list, device):
        self.config, self.traffic = config, traffic
        index = raw_index(config, paths)
        fd = filter_data(config, traffic)
        self.kind = traffic["shell"]
        if self.kind == "features":
            self.shell = FeatureProcessing(index, traffic["processing"], fd,
                                           verbose=False, device=device)
            self.kwargs = dict(batch_size=traffic["batch"],
                               nreaders=traffic["readers"])
        elif self.kind == "triggers":
            self.shell = TriggerProcessing(index, config["processing"], fd,
                                           verbose=False, device=device)
            self.kwargs = dict(event_batch=traffic["event_batch"],
                               capacity=traffic["capacity"],
                               nreaders=traffic["readers"])
        else:
            raise ValueError(f"unknown shell {self.kind!r}")
        self.batches = 0

    def run_pass(self, timer=None):
        table = self.shell.process(timer=timer, **self.kwargs)
        self.batches += int(self.shell.stats["batches"])
        if self.kind == "features":
            return table, len(table["event_number"])
        events = int(self.shell.stats["events"])
        return table, events * len(self.config["channels"]) \
            * self.config["nb_samples"]
