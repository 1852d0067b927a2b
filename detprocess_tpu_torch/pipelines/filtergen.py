"""Filter-file generation: noise PSDs and CSDs from randoms, templates from
the config, and dIdV fits, into one filter store.

Port of ``detprocess_tpu/pipelines/filtergen.py::FilterDataProcessing``
(:27; the reference's detprocess/process/filterprocess.py): the
beginning-of-run workload that feeds triggering and feature extraction.

- The noise files come from ``raw_path`` (a raw group: continuous, else
  randoms, else noise series; ``io/rawdata.RawData``), or from
  ``noise_files``: raw paths (pytesdaq HDF5, or flat dumps beside their
  manifest) or a :class:`RawIndex` (flat dumps need no h5py, so the GPU
  machine uses those).
- ``process()`` runs the noise branch (randoms, each channel's PSD, the
  CSD of the channels when there are several, by-series PSDs tagged by
  series name with ``lgc_by_series``) and the template branch (per tag:
  analytic n-pole, sum of two-poles when the amplitude and time
  parameters are lists, average pulses from raw events; or the legacy
  single-template block), and with ``lgc_save`` writes the store as
  ``filter_{series}.hdf5`` (h5py) or, with ``output_format="npz"``,
  ``.npz``.
- ``check_config`` validates the ``noise``, ``template`` and ``didv``
  sections up front.
- The dIdV branch (``proces_didv``, ``_process_didv``) runs when there
  are dIdV files and ``didv`` channels: each dIdV series through
  ``pipelines/didv.DIDVAnalysis`` (cuts and lock-in on the device, the
  fits on the CPU in float64) into the channel's ``didv_processing``
  table, and the fit of all series together into the store as
  ``didv_results_*``. ``didv_files`` are pytesdaq paths, an
  ``io/rawdata.RawIndex`` (one series), or ``{series: paths or
  RawIndex}``.

``jaxcache`` is a TPU matter and is not ported. ``device=None`` means the
GPU (``device.require_cuda``).
"""

from __future__ import annotations

import os
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.config.yamlconfig import load_yaml, normalize_config
from detprocess_tpu_torch.io.filterdata import FilterData, records_table
from detprocess_tpu_torch.io.rawdata import RawData, RawIndex, RawReader
from detprocess_tpu_torch.models import didv as didv_models
from detprocess_tpu_torch.pipelines.didv import DIDVAnalysis, raw_index
from detprocess_tpu_torch.pipelines.noise import Noise
from detprocess_tpu_torch.pipelines.template import Template
from detprocess_tpu_torch.utils.misc import create_series_name


class FilterDataProcessing:
    """Generate filter data from raw data and the ``noise``/``template``
    (and ``didv``) sections of a processing config (a dict or a YAML
    path)."""

    def __init__(self, raw_path: Optional[str] = None, noise_files=None,
                 didv_files: Optional[Sequence[str]] = None, config=None,
                 series: Optional[Sequence[str]] = None, facility: int = 1,
                 verbose: bool = True, device=None):
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._verbose = verbose
        self._facility = facility

        if raw_path is not None:
            maps = {kind: RawData(raw_path, data_type=kind,
                                  series=series).get_data_files()
                    for kind in ("continuous", "rand", "didv", "noise")}
            series_map = (maps["continuous"] or maps["rand"]
                          or maps["noise"])
            self._is_continuous = bool(maps["continuous"])
            noise_files = noise_files or self._flatten(series_map)
            didv_files = didv_files or self._flatten(maps["didv"])
            self._noise_series_map = dict(series_map)
            self._didv_series_map = dict(maps["didv"])
        else:
            self._noise_series_map = (
                {"series": noise_files} if noise_files else {})
            if isinstance(didv_files, dict):
                self._didv_series_map = dict(didv_files)
                didv_files = self._combined(didv_files)
            else:
                self._didv_series_map = (
                    {"series": didv_files
                     if isinstance(didv_files, RawIndex)
                     else list(didv_files)} if didv_files else {})
            self._is_continuous = True
        if isinstance(noise_files, RawIndex):
            self._noise = noise_files
        else:
            self._noise = (RawIndex.from_files(list(noise_files))
                           if noise_files else None)
        self._didv_files = (didv_files if isinstance(didv_files, RawIndex)
                            else list(didv_files or []))

        if self._noise is not None:
            probe = self._noise
        elif self._didv_files:
            probe = raw_index(self._didv_files)
        else:
            raise ValueError("no raw files found for filter generation")
        self._available_channels = probe.channels
        self._fs = probe.sample_rate

        if isinstance(config, str):
            config = load_yaml(config)
        self._config = (None if config is None else normalize_config(
            config, self._available_channels, self._fs))
        self._filter_data = FilterData(verbose=verbose)
        self.stats: dict = {}

    @staticmethod
    def _flatten(series_map: Dict[str, List[str]]) -> List[str]:
        return sorted(f for files in series_map.values() for f in files)

    @staticmethod
    def _combined(series_map: dict):
        """All dIdV series of ``{series: paths or RawIndex}``: the sorted
        paths, or one index over every series in series order."""
        if all(not isinstance(v, RawIndex) for v in series_map.values()):
            return FilterDataProcessing._flatten(series_map)
        return RawIndex.concat([raw_index(series_map[k])
                                for k in sorted(series_map)])

    @property
    def filter_data(self) -> FilterData:
        return self._filter_data

    def _section(self, name: str) -> dict:
        if self._config is None:
            return {"overall": {}, "channels": {}}
        return self._config[name]

    # ------------------------------------------------------------------
    def check_config(self, processing_type: str) -> None:
        """Raise a ValueError naming the missing data or config key when
        the ``didv``, ``noise`` or ``template`` branch cannot run."""
        if self._config is None:
            raise ValueError(
                "ERROR: processing config not found — pass config= "
                "(a config dict or a yaml path) to FilterDataProcessing")
        if processing_type == "didv":
            self._check_didv()
        elif processing_type == "noise":
            if self._noise is None:
                raise ValueError(
                    "ERROR: unable to process noise — no randoms or "
                    "continuous raw data found")
            noise_cfg = self._section("noise")
            overall = noise_cfg.get("overall", {}) or {}
            lengths = ("trace_length_samples", "trace_length_msec")
            if self._is_continuous and self._verbose:
                for chan, ccfg in (noise_cfg.get("channels") or {}).items():
                    if isinstance(ccfg, dict) and not any(
                            k in overall or k in ccfg for k in lengths):
                        print(f"INFO: no trace length configured for "
                              f"noise channel {chan} — full-trace "
                              "randoms geometry will be used")
        elif processing_type == "template":
            self._check_template()
        else:
            raise ValueError(
                f"unknown processing_type {processing_type!r} — expected "
                "'didv', 'noise', or 'template'")

    def _check_didv(self):
        if not self._didv_files:
            raise ValueError(
                "ERROR: unable to process dIdV — no dIdV raw data found "
                "(files with a 'didv_' prefix)")
        didv_cfg = self._section("didv")
        channels = didv_cfg.get("channels") or {}
        if not channels:
            raise ValueError(
                "ERROR: input yaml file does not contain didv processing "
                "configurations (a 'didv:' section with channel blocks)")
        overall = didv_cfg.get("overall", {}) or {}
        for chan, ccfg in channels.items():
            if not isinstance(ccfg, dict):
                continue
            for key in ("sgfreq", "sgamp"):
                if ccfg.get(key, overall.get(key)) is None:
                    raise ValueError(
                        f'ERROR: "{key}" is required to process dIdV for '
                        f"channel {chan} (set it in the channel block or "
                        "in the didv section)")
            if not any(k in ccfg for k in ("ivsweep_file", "ivsweep_results",
                                           "ivsweep_data")):
                raise ValueError(
                    f"ERROR: I0/R0 bias information required for channel "
                    f'{chan}: provide "ivsweep_file" (path) or '
                    f'"ivsweep_results" (dict with i0/r0/rp/rshunt) in its '
                    "didv config")

    def _check_template(self):
        channels = self._section("template").get("channels") or {}
        if not channels:
            raise ValueError(
                "ERROR: input yaml file does not contain template "
                "generation configurations (a 'template:' section with "
                "channel blocks)")
        for chan, ccfg in channels.items():
            if not isinstance(ccfg, dict):
                continue
            tags = ccfg.get("template_tag_list")
            if tags is None:
                if (not ccfg.get("from_average_pulses")
                        and ccfg.get("tau_r") is None
                        and ccfg.get("rise_time") is None):
                    raise ValueError(
                        f"ERROR: no template parameters for channel {chan}: "
                        'provide "tau_r"/"tau_f1" (or "rise_time"/'
                        '"fall_time_1"), a "template_tag_list", or '
                        '"from_average_pulses: true"')
                continue
            for tag in tags:
                if tag not in ccfg:
                    raise ValueError(
                        f"ERROR: no configuration found for tag {tag}, "
                        f'channel {chan} (every entry of "template_tag_list"'
                        " needs a matching block)")
                tcfg = ccfg[tag]
                if tcfg.get("from_average_pulses"):
                    continue
                if "template_poles" not in tcfg:
                    raise ValueError(
                        f'ERROR: no "template_poles" parameter for tag '
                        f"{tag}, channel {chan}")
                missing = [k for k, alt in (("amplitude_A", "A"),
                                            ("rise_time", "tau_r"),
                                            ("fall_time_1", "tau_f1"))
                           if k not in tcfg and alt not in tcfg]
                if missing:
                    raise ValueError(
                        f"ERROR: missing template parameters {missing} for "
                        f"tag {tag}, channel {chan}")

    # ------------------------------------------------------------------
    def proces_didv(self, channels=None, **kwargs):
        """dIdV-only processing (the reference's spelling)."""
        return self.process(channels=channels, enable_noise=False,
                            enable_template=False, enable_didv=True,
                            **kwargs)

    def proces_noise(self, channels=None, **kwargs):
        """Noise-only processing (the reference's spelling)."""
        return self.process(channels=channels, enable_noise=True,
                            enable_template=False, enable_didv=False,
                            **kwargs)

    def process(self, channels: Optional[Sequence[str]] = None,
                enable_noise: bool = True, enable_template: bool = True,
                enable_didv: bool = True, nrandoms: Optional[int] = None,
                random_rate: Optional[float] = None,
                lgc_by_series: bool = False, lgc_save: bool = False,
                output_path: Optional[str] = None,
                file_name: Optional[str] = None,
                seed: Optional[int] = None, output_format: str = "hdf5",
                timer=None) -> FilterData:
        """Run the enabled branches; returns the filter store. ``timer``:
        a ``utils.logging.StageTimer`` for the host seconds of the
        randoms table, the reads, the upload, the cuts, the offsets, the
        spectra and the templates, and of the dIdV branch's reads
        ("read") and device work ("device")."""
        channels = list(channels or self._available_channels)
        noise_cfg = self._section("noise")
        tmpl_cfg = self._section("template")
        didv_cfg = self._section("didv")

        if enable_noise and self._noise is not None:
            overall = noise_cfg.get("overall", {}) or {}
            n = overall.get("trace_length_samples")
            p = overall.get("pretrigger_length_samples")
            draw = dict(random_rate=random_rate or overall.get("random_rate"),
                        nrandoms=nrandoms or overall.get("nrandoms", 500),
                        seed=seed)
            chan_sel = [c for c in channels
                        if not noise_cfg.get("channels")
                        or c in noise_cfg["channels"]]
            noise = self._noise_store(self._noise)
            noise.generate_randoms(timer=timer, **draw)
            noise.calc_psd(chan_sel, trace_length_samples=n,
                           pretrigger_length_samples=p, timer=timer)
            if len(chan_sel) > 1:
                noise.calc_csd(chan_sel, trace_length_samples=n,
                               pretrigger_length_samples=p, timer=timer)
            self.stats = dict(noise.stats)
            self.stats["offsets"] = {c: noise.get_offset(c)
                                     for c in chan_sel}
            del noise                   # its windows and spectra
            if lgc_by_series and len(self._noise_series_map) > 1:
                for sname, sfiles in self._noise_series_map.items():
                    ns = self._noise_store(RawIndex.from_files(
                        sorted(sfiles)), verbose=False)
                    ns.generate_randoms(**draw)
                    ns.calc_psd(chan_sel, trace_length_samples=n,
                                pretrigger_length_samples=p, tag=sname)

        if enable_template and tmpl_cfg.get("channels"):
            if self._config is not None:
                self.check_config("template")
            template = Template(verbose=self._verbose)
            template._filter_data = self._filter_data.data
            with (timer.stage("templates") if timer is not None
                  else nullcontext()):
                for chan, ccfg in tmpl_cfg["channels"].items():
                    if isinstance(ccfg, dict):
                        self._process_template(template, chan, ccfg)

        if enable_didv and self._didv_files and didv_cfg.get("channels"):
            if self._config is not None:
                self.check_config("didv")
            self._process_didv(didv_cfg, timer)

        if lgc_save:
            output_path = output_path or "."
            os.makedirs(output_path, exist_ok=True)
            ext = "npz" if output_format == "npz" else "hdf5"
            name = file_name or (
                f"filter_{create_series_name(self._facility)}.{ext}")
            self._filter_data.save(os.path.join(output_path, name))
        return self._filter_data

    def _noise_store(self, index: RawIndex, verbose=None) -> Noise:
        """A :class:`Noise` over ``index`` that writes into this store."""
        noise = Noise(index, verbose=self._verbose if verbose is None
                      else verbose, device=self._device)
        noise._filter_data = self._filter_data.data
        return noise

    # ------------------------------------------------------------------
    def _process_template(self, template: Template, chan: str,
                          ccfg: dict) -> None:
        """The configured templates of one channel."""
        tags = ccfg.get("template_tag_list")
        if tags is None:
            # the legacy single-template block: keys on the channel
            if ccfg.get("from_average_pulses"):
                self._template_from_average(template, chan, ccfg,
                                            ccfg.get("tag", "default"))
                return
            template.create_template(
                chan, self._fs,
                trace_length_samples=ccfg.get("trace_length_samples"),
                trace_length_msec=ccfg.get("trace_length_msec"),
                pretrigger_length_samples=ccfg.get(
                    "pretrigger_length_samples"),
                pretrigger_length_msec=ccfg.get("pretrigger_length_msec"),
                A=ccfg.get("A", ccfg.get("amplitude_A", 1.0)),
                B=ccfg.get("B", ccfg.get("amplitude_B")),
                C=ccfg.get("C", ccfg.get("amplitude_C")),
                tau_r=ccfg.get("tau_r", ccfg.get("rise_time")),
                tau_f1=ccfg.get("tau_f1", ccfg.get("fall_time_1")),
                tau_f2=ccfg.get("tau_f2", ccfg.get("fall_time_2")),
                tau_f3=ccfg.get("tau_f3", ccfg.get("fall_time_3")),
                tag=ccfg.get("tag", "default"))
            return

        def aslist(v):
            return v if isinstance(v, list) else [v]

        for tag in tags:
            tcfg = ccfg[tag]
            if tcfg.get("from_average_pulses"):
                self._template_from_average(template, chan, tcfg, tag)
                continue
            poles = int(tcfg["template_poles"])
            n = tcfg.get("trace_length_samples")
            if n is None and tcfg.get("trace_length_msec") is not None:
                n = int(round(tcfg["trace_length_msec"] * 1e-3 * self._fs))
            pre = tcfg.get("pretrigger_length_samples")
            if pre is None and tcfg.get("pretrigger_length_msec") is not None:
                pre = int(round(
                    tcfg["pretrigger_length_msec"] * 1e-3 * self._fs))
            lengths = dict(trace_length_samples=n,
                           pretrigger_length_samples=pre)
            a = aslist(tcfg.get("amplitude_A", tcfg.get("A", 1.0)))
            rise = aslist(tcfg.get("rise_time", tcfg.get("tau_r")))
            fall1 = aslist(tcfg.get("fall_time_1", tcfg.get("tau_f1")))
            if poles == 2 and len(a) > 1:
                template.create_template_sum_twopoles(
                    chan, a, rise, fall1, self._fs, tag=tag, **lengths)
            else:
                b = tcfg.get("amplitude_B", tcfg.get("B"))
                c = tcfg.get("amplitude_C", tcfg.get("C"))
                template.create_template(
                    chan, self._fs, A=a[0],
                    B=aslist(b)[0] if b is not None else None,
                    C=aslist(c)[0] if c is not None else None,
                    tau_r=rise[0], tau_f1=fall1[0],
                    tau_f2=tcfg.get("fall_time_2", tcfg.get("tau_f2")),
                    tau_f3=tcfg.get("fall_time_3", tcfg.get("tau_f3")),
                    tag=tag, **lengths)

    def _template_from_average(self, template: Template, chan: str,
                               tcfg: dict, tag: str) -> None:
        """Average-pulse template from raw events (``raw_files``, else the
        noise data)."""
        files = tcfg.get("raw_files") or self._noise
        if files is None:
            raise ValueError(
                f"ERROR: from_average_pulses for channel {chan} needs "
                'raw data — no noise/continuous files found and no '
                '"raw_files" given')
        reader = RawReader(files)
        try:
            ci = reader.channels.index(chan)
            traces, _ = reader.read_many_events(tcfg.get("nevents"))
        finally:
            reader.close()
        tr = traces[:, ci, :]
        n = tcfg.get("trace_length_samples") or tr.shape[-1]
        pre = tcfg.get("pretrigger_length_samples") or n // 2
        template.calc_average_pulses(chan, tr[:, :n], self._fs,
                                     pretrigger_length_samples=pre, tag=tag)

    # ------------------------------------------------------------------
    def _process_didv(self, didv_cfg: dict, timer=None) -> None:
        """Each channel's dIdV fits (the reference's
        filterprocess.py:797-1047 ``_process_didv``): every dIdV series is
        processed and fitted apart, one row a series (offsets, bias
        parameters, the 2/3-pole small-signal parameters with errors, χ²,
        falltimes, the infinite-loop-gain bias point) into the channel's
        ``didv_processing`` table (``set_didv_dataframe``); the fit of all
        series together goes into the store as ``didv_results_*``, the
        filter file's dIdV results."""
        overall = didv_cfg.get("overall", {}) or {}
        for chan, ccfg in didv_cfg["channels"].items():
            if not isinstance(ccfg, dict):
                continue
            sgfreq = ccfg.get("sgfreq", overall.get("sgfreq"))
            sgamp = ccfg.get("sgamp", overall.get("sgamp"))
            rsh = ccfg.get("rshunt", overall.get("rshunt", 5e-3))
            poles_req = ccfg.get("poles", [2, 3])
            iv_results = ccfg.get("ivsweep_results",
                                  ccfg.get("ivsweep_data"))
            iv_file = ccfg.get("ivsweep_file")
            iv_type = ccfg.get("ivsweep_result_type", "noise")

            def attach(didv):
                if iv_file:
                    didv.set_ivsweep_results_from_file(chan, iv_file,
                                                       iv_type=iv_type)
                elif iv_results:
                    didv.set_ivsweep_results(chan, iv_results,
                                             iv_type=iv_type)

            rows = []
            for sname, sfiles in sorted(self._didv_series_map.items()):
                didv_s = DIDVAnalysis(verbose=False, device=self._device)
                try:
                    didv_s.process_raw_data(
                        chan, sfiles if isinstance(sfiles, RawIndex)
                        else sorted(sfiles), sgfreq, sgamp, rsh,
                        timer=timer)
                except (ValueError, KeyError) as err:
                    if self._verbose:
                        print(f"INFO: skipping dIdV series {sname} for "
                              f"{chan}: {err}")
                    continue
                didv_s.dofit(chan, poles=poles_req)
                attach(didv_s)
                didv_s.calc_smallsignal_params(chan, poles=poles_req)
                rows.append(self._didv_series_row(didv_s, chan, sname,
                                                  poles_req))
            if rows:
                self._filter_data.set_didv_dataframe(
                    chan, records_table(rows),
                    metadata={"sgfreq": sgfreq, "sgamp": sgamp,
                              "rshunt": rsh})
                if self._verbose:
                    print(f"INFO: {chan}: {len(rows)} dIdV series fitted "
                          "→ didv_processing dataframe")

            # the fit of all series together (the filter file's results)
            didv = DIDVAnalysis(verbose=self._verbose, device=self._device)
            didv._filter_data = self._filter_data.data
            didv.process_raw_data(chan, self._didv_files, sgfreq, sgamp,
                                  rsh, timer=timer)
            didv.dofit(chan, poles=poles_req)
            attach(didv)
            if iv_file or iv_results:
                didv.calc_smallsignal_params(chan, poles=poles_req)
                didv.calc_bias_params_infinite_loop_gain(chan)

    @staticmethod
    def _didv_series_row(didv: DIDVAnalysis, chan: str, sname: str,
                         poles_req) -> dict:
        """One series' row of the ``didv_processing`` table (the
        reference's filterprocess.py:860-1047 output, flattened)."""
        data = didv.get_didv_data(chan)
        row = {
            "series_name": sname,
            "offset_didv": data.offset,
            "offset_err_didv": data.offset_err,
            "fs": data.fs,
            "sgfreq": data.sgfreq,
            "sgamp": data.sgamp,
        }
        bias = didv._bias_params.get(chan, {})
        for key in ("rp", "rn", "rshunt", "i0", "i0_err", "r0", "r0_err",
                    "p0", "p0_err", "ibias"):
            row[key] = bias.get(key, np.nan)
        poles_list = ([poles_req] if isinstance(poles_req, int)
                      else list(poles_req))
        for p in poles_list:
            try:
                fit = didv.get_fit(chan, p)
            except KeyError:
                continue
            row[f"chi2_{p}poles_fit"] = fit.cost
            taus = didv_models.didv_falltimes(fit)
            row[f"tau+_{p}poles_fit"] = taus[0]
            row[f"tau-_{p}poles_fit"] = taus[1]
            row[f"tau3_{p}poles_fit"] = taus[2]
            ssp = didv._ssp.get(chan, {}).get(p)
            if ssp:
                for par in ("l", "L", "tau0", "beta", "gratio"):
                    if par in ssp:
                        row[f"{par}_{p}poles_fit"] = ssp[par]
                        row[f"{par}_err_{p}poles_fit"] = ssp.get(
                            f"{par}_err", np.nan)
            if bias.get("ibias") is not None and "rshunt" in bias:
                ilg = didv_models.biasparams_ilg(
                    fit.params, bias.get("rshunt", 0.0)
                    + bias.get("rp", 0.0), bias.get("rshunt", 0.0),
                    bias.get("ibias", 0.0), poles=p)
                for par in ("i0", "r0", "p0"):
                    row[f"{par}_{p}poles_infinite_lgain"] = ilg[par]
        return row
