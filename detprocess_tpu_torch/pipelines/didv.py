"""dIdV analysis: raw square-wave data → fits → TES parameters.

Port of ``detprocess_tpu/pipelines/didv.py::DIDVAnalysis`` (:24-496; the
reference's detprocess/core/didv.py): read raw dIdV traces, cut and
lock-in average them, fit 1/2/3-pole models, derive the small-signal
parameters with their errors, the infinite-loop-gain bias point, dPdI
and the energy resolution, and keep everything in the filter store under
the reference's keys (``didv_results_{poles}poles_{tag}``).

- The trace work runs on ``device`` (``device=None`` means the GPU,
  ``device.require_cuda``): one channel's stored values go up once
  (``io/upload.upload_channel``) and ``ops/lockin.process_didv_traces``
  cuts, folds and transforms them there in float64.
- The fits and everything derived from them run on the CPU in float64
  (``models/didv``), as the JAX package pins them there: they are small
  problems that want float64, not the GPU.

``raw_files`` are raw paths (pytesdaq HDF5, or flat dumps beside their
manifest) or an ``io/rawdata.RawIndex``. ``compare_with_ivsweep``
returns a ``Table`` with the JAX DataFrame's columns and its row labels
in ``.index``. ``plot_fit_result`` imports matplotlib when it is called;
``jaxcache`` is a TPU matter and is not ported.
"""

from __future__ import annotations

import glob
import os
from contextlib import nullcontext
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.io.filterdata import (FilterData, Table,
                                                 records_table)
from detprocess_tpu_torch.io.rawdata import RawIndex, RawReader
from detprocess_tpu_torch.io.upload import channel_to_device, read_channel
from detprocess_tpu_torch.models import didv as didv_models
from detprocess_tpu_torch.models import ivbias
from detprocess_tpu_torch.ops import lockin


def stage(timer, name: str):
    """``timer.stage(name)``, or nothing without a timer."""
    return nullcontext() if timer is None else timer.stage(name)


def raw_index(raw) -> RawIndex:
    """A :class:`RawIndex` of pytesdaq paths (or the index itself)."""
    return raw if isinstance(raw, RawIndex) else RawIndex.from_files(raw)


class DIDVAnalysis(FilterData):
    """Per-channel dIdV analysis."""

    def __init__(self, verbose: bool = True, device=None):
        super().__init__(verbose=verbose)
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._didv_data: Dict[str, lockin.DIDVData] = {}
        self._fits: Dict[str, Dict[int, didv_models.DIDVFit]] = {}
        self._bias_params: Dict[str, dict] = {}
        self._ssp: Dict[str, Dict[int, dict]] = {}
        self._ilg: Dict[str, Dict[int, dict]] = {}
        self._ivbor: Dict[str, dict] = {}
        self._auto_save_path: Optional[str] = None

    # ------------------------------------------------------------------
    def process_raw_data(self, channels: Sequence[str] | str,
                         raw_files, sgfreq: float, sgamp: float,
                         rsh: float, nsigma_cut: float = 2.5,
                         nevents: Optional[int] = None, timer=None):
        """Read the first ``nevents`` raw dIdV events, cut them and
        lock-in average them on the device. ``timer``: a
        ``utils.logging.StageTimer`` for the host seconds of the reads
        ("read") and of the device work up to its results on the host
        ("device")."""
        if isinstance(channels, str):
            channels = [channels]
        index = raw_index(raw_files)
        fs = index.sample_rate
        for chan in channels:
            with stage(timer, "read"):
                host, conv = read_channel(index, chan, nevents,
                                          pin=self._device.type == "cuda")
            with stage(timer, "device"):
                self.set_processed_data(chan, lockin.process_didv_traces(
                    channel_to_device(host, conv, self._device), fs,
                    sgfreq, sgamp, rsh, nsigma_cut=nsigma_cut))
        return self

    def set_processed_data(self, channel: str, data: lockin.DIDVData):
        """Use already processed dIdV data (qetpy.didvinitfromdata)."""
        self._didv_data[channel] = data

    def get_didv_data(self, channel: str) -> lockin.DIDVData:
        return self._didv_data[channel]

    # ------------------------------------------------------------------
    def set_ivsweep_results(self, channel: str, results: dict,
                            iv_type: str = "noise", tag: str = "default"):
        """Attach IV-sweep results (i0/r0/p0/rp/rshunt) for the
        small-signal conversion; they are also stored as
        ``ivsweep_results_{iv_type}_{tag}``, so that 'noise' and 'didv'
        results stay apart in the file."""
        self._bias_params[channel] = dict(results)
        FilterData.set_ivsweep_results(self, channel, dict(results),
                                       measurement=iv_type, tag=tag)
        return self

    def set_ivsweep_results_from_data(self, channel: str, results: dict,
                                      iv_type: str = "noise"):
        """The reference's name of :meth:`set_ivsweep_results`."""
        return self.set_ivsweep_results(channel, results, iv_type)

    def set_ivsweep_results_from_file(self, channel: str, file_name: str,
                                      iv_type: str = "noise",
                                      tag: str = "default"):
        """IV-sweep results of ``channel`` from a filter or IV-sweep file
        (.npz, or HDF5 through h5py)."""
        fd = FilterData(verbose=False).load(file_name)
        results = fd._get(channel, f"ivsweep_results_{iv_type}_{tag}")[0]
        if not isinstance(results, dict):
            raise ValueError(
                f"ivsweep_results_{iv_type}_{tag} for {channel} in "
                f"{file_name} is not a result dict")
        self._bias_params[channel] = dict(results)
        return self

    def dofit(self, channels: Sequence[str] | str, poles=(2, 3),
              nharmonics: Optional[int] = 200):
        """Fit the measured dIdV(f) on its first ``nharmonics`` odd
        harmonics with each pole model."""
        if isinstance(channels, str):
            channels = [channels]
        if isinstance(poles, int):
            poles = [poles]
        for chan in channels:
            data = self._didv_data[chan]
            nh = (len(data.freqs) if nharmonics is None
                  else min(nharmonics, len(data.freqs)))
            fits = self._fits.setdefault(chan, {})
            for p in poles:
                fits[p] = didv_models.fit_didv(
                    data.freqs[:nh], data.didv[:nh], poles=p,
                    weights=data.weights[:nh])
                self._set(chan, f"didv_results_{p}poles_fit_default", {
                    "params": fits[p].params,
                    "cov": fits[p].cov,
                    "cost": fits[p].cost,
                    "poles": p,
                }, {"sgfreq": data.sgfreq, "sgamp": data.sgamp,
                    "rsh": data.rsh})
        self._maybe_auto_save()
        return self

    def get_fit(self, channel: str, poles: int) -> didv_models.DIDVFit:
        return self._fits[channel][poles]

    def dofit_prior(self, channels: Sequence[str] | str,
                    prior_mean, prior_cov, poles: int = 2,
                    nharmonics: Optional[int] = 200):
        """Prior-constrained fit (qetpy.DIDVPriors)."""
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            data = self._didv_data[chan]
            nh = (len(data.freqs) if nharmonics is None
                  else min(nharmonics, len(data.freqs)))
            fit = didv_models.fit_didv_prior(
                data.freqs[:nh], data.didv[:nh], prior_mean, prior_cov,
                poles=poles, weights=data.weights[:nh])
            self._fits.setdefault(chan, {})[poles] = fit
            self._set(chan, f"didv_results_{poles}poles_priorfit_default",
                      {"params": fit.params, "cov": fit.cov,
                       "cost": fit.cost, "poles": poles}, None)
        return self

    def enable_auto_save(self, path: str):
        """Save the filter store to ``path`` after each analysis step."""
        self._auto_save_path = path

    def _maybe_auto_save(self):
        if self._auto_save_path:
            self.save_hdf5(self._auto_save_path)

    # ------------------------------------------------------------------
    def _rl(self, bias: dict) -> float:
        return (bias.get("rshunt", bias.get("rsh", 0.0))
                + bias.get("rp", 0.0))

    def calc_smallsignal_params(self, channels: Sequence[str] | str,
                                poles=(2, 3), tag: str = "default"):
        """Small-signal parameters and errors of each fitted pole count;
        needs the IV-sweep bias results (r0, rp, rshunt)."""
        if isinstance(channels, str):
            channels = [channels]
        if isinstance(poles, int):
            poles = [poles]
        for chan in channels:
            bias = self._bias_params.get(chan)
            if bias is None:
                raise ValueError(
                    f"IV sweep results required for channel {chan} — call "
                    "set_ivsweep_results first")
            r0 = bias["r0"]
            rl = self._rl(bias)
            for p in poles:
                if p not in self._fits.get(chan, {}):
                    continue
                ssp = didv_models.smallsignal_with_errors(
                    self._fits[chan][p], r0, rl)
                self._ssp.setdefault(chan, {})[p] = ssp
                light = {k: v for k, v in ssp.items() if k != "cov"}
                self._set(chan,
                          f"didv_results_{p}poles_smallsignalparams_{tag}",
                          light, {"r0": r0, "rl": rl})
        self._maybe_auto_save()
        return self

    def get_smallsignal_params(self, channel: str, poles: int) -> dict:
        return self._ssp[channel][poles]

    def calc_bias_params_infinite_loop_gain(self, channels, poles: int = 2,
                                            tag: str = "default"):
        """The infinite-loop-gain bias point of the dIdV fit."""
        if isinstance(channels, str):
            channels = [channels]
        out = {}
        for chan in channels:
            bias = self._bias_params.get(chan, {})
            rsh = bias.get("rshunt", bias.get("rsh", 5e-3))
            rp = bias.get("rp", 0.0)
            ibias = bias.get("ibias", bias.get("tes_bias", 0.0))
            ilg = didv_models.biasparams_ilg(self._fits[chan][poles].params,
                                            rsh + rp, rsh, ibias, poles)
            self._set(chan, f"didv_results_{poles}poles_biasparams_{tag}",
                      ilg, {"method": "infinite_loop_gain"})
            self._ilg.setdefault(chan, {})[poles] = ilg
            out[chan] = ilg
        return out

    # ------------------------------------------------------------------
    def calc_dpdi(self, channels, freqs: np.ndarray, poles: int = 2,
                  tag: str = "default"):
        """dPdI(f) with uncertainties, stored as ``dpdi_{poles}poles_{tag}``;
        returns {channel: (dPdI, σ|dPdI|)}."""
        if isinstance(channels, str):
            channels = [channels]
        out = {}
        for chan in channels:
            bias = self._bias_params[chan]
            dpdi, dpdi_err = didv_models.dpdi_with_uncertainties(
                self._fits[chan][poles], freqs, bias["i0"], bias["r0"],
                self._rl(bias))
            self.set_dpdi(chan, dpdi, np.asarray(freqs), poles, tag=tag)
            out[chan] = (dpdi, dpdi_err)
        return out

    def calc_energy_resolution(self, channel: str, template: np.ndarray,
                               psd: np.ndarray, fs: float,
                               poles: int = 2) -> float:
        """Baseline energy resolution with the stored dPdI."""
        dpdi, _ = self.get_dpdi(channel, poles)
        if len(dpdi) != len(template):
            raise ValueError(
                f"dPdI length {len(dpdi)} != template length "
                f"{len(template)} — recompute dPdI on the template's "
                "frequency axis")
        return didv_models.energy_resolution(template, psd, dpdi, fs)

    # ------------------------------------------------------------------
    def clear(self, channels=None):
        """Drop the analysis state of some or all channels."""
        stores = (self._didv_data, self._fits, self._bias_params,
                  self._ssp, self._ilg, self._ivbor)
        if channels is None:
            for store in stores:
                store.clear()
            return
        if isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            for store in stores:
                store.pop(chan, None)

    def get_qetpy_object(self, channel: str):
        """The channel's dIdV data (the :class:`lockin.DIDVData` that
        stands for qetpy's DIDV object)."""
        if channel not in self._didv_data:
            raise ValueError(f'ERROR: No dIdV data available for '
                             f'channel "{channel}"!')
        return self._didv_data[channel]

    def get_fit_results(self, channel: str, poles: int,
                        verbose: bool = True) -> dict:
        """params/cov/cost/poles with smallsignalparams, biasparams and
        biasparams_infinite_lgain where computed; {} without a fit."""
        fit = self._fits.get(channel, {}).get(poles)
        if fit is None:
            if self._verbose and verbose:
                print(f"WARNING: {channel}: No fit result found for "
                      f"poles {poles}! Returning empty dictionary.")
            return {}
        result = {"params": np.asarray(fit.params),
                  "cov": np.asarray(fit.cov),
                  "cost": float(fit.cost), "poles": int(poles)}
        ssp = self._ssp.get(channel, {}).get(poles)
        if ssp is not None:
            result["smallsignalparams"] = {k: v for k, v in ssp.items()
                                           if k != "cov"}
        bias = self._bias_params.get(channel)
        if bias is not None:
            result["biasparams"] = dict(bias)
        ilg = self._ilg.get(channel, {}).get(poles)
        if ilg is not None:
            result["biasparams_infinite_lgain"] = dict(ilg)
        return result

    def get_bias_params(self, channel: str, poles: int = 3) -> dict:
        """The I0/R0/P0 bias parameters in use."""
        result = self.get_fit_results(channel, poles, verbose=False)
        if "biasparams" not in result:
            raise ValueError(f'ERROR: No bias parameters available for '
                             f'channel "{channel}"!')
        return result["biasparams"]

    def get_bias_params_infinite_loop_gain(self, channel: str,
                                           poles: int = 3) -> dict:
        ilg = self._ilg.get(channel, {}).get(poles)
        if ilg is None:
            raise ValueError(
                f"ERROR: No bias parameters with infinite loop gain "
                f'available for channel "{channel}"!')
        return ilg

    def set_iv_bor_data(self, base_path: str, bor_series_number: int,
                        channel: str, files_per_set: int = 4):
        """Bias parameters from a beginning-of-run IV taken with continuous
        data: groups of ``files_per_set`` 'iv_bor' dumps (normal points
        first, the transition point last) give each point's mean current
        and TES bias; a normal-branch line fit and the transition point
        give i0/r0/p0 (``models/ivbias.biasparams_from_normal_iv``).
        Needs rp and rshunt (``set_ivsweep_results`` first)."""
        bias = self._bias_params.get(channel)
        if not bias or "rp" not in bias:
            raise ValueError('ERROR: Unable to find rp! Use '
                             '"set_ivsweep_results()" first')
        rsh = bias.get("rshunt", bias.get("rsh"))
        rl = rsh + bias["rp"]

        files = sorted(glob.glob(os.path.join(base_path, "**", "*.hdf5"),
                                 recursive=True))
        bor = [f for f in files if "iv_bor" in os.path.basename(f)]
        if not bor:
            raise ValueError(f"no iv_bor files under {base_path}")
        groups = [bor[i:i + files_per_set]
                  for i in range(0, len(bor), files_per_set)]
        *normal_files, trans_file = groups[bor_series_number]

        def _point(fname):
            reader = RawReader(fname)
            try:
                traces, _ = reader.read_many_events(channels=[channel])
                det = reader.get_detector_config().get(channel, {})
            finally:
                reader.close()
            means = traces[:, 0, :].mean(axis=-1)
            return (float(means.mean()),
                    float(means.std() / np.sqrt(len(means))),
                    float(det.get("tes_bias", np.nan)))

        norm_avs, norm_errs, ibias_norms = zip(
            *[_point(f) for f in normal_files])
        trans_av, trans_err, ibias_trans = _point(trans_file)
        params = ivbias.biasparams_from_normal_iv(
            list(norm_avs), list(norm_errs), trans_av, trans_err,
            list(ibias_norms), ibias_trans, rl=rl, rsh=rsh)
        self._ivbor[channel] = params
        self._bias_params[channel].update(
            {k: params[k] for k in ("i0", "r0", "p0", "i0_err", "r0_err",
                                    "p0_err", "ioffset", "rn", "ibias")})
        if self._verbose:
            print(f"INFO: {channel} bor-IV bias point: "
                  f"r0 = {params['r0']*1e3:.2f} mOhms, "
                  f"i0 = {params['i0']*1e6:.3f} muA, "
                  f"p0 = {params['p0']*1e15:.3f} fW")
        return params

    def compare_with_ivsweep(self, channel: str, poles: int = 3) -> Table:
        """R0/I0/P0 of the IV sweep beside the infinite-loop-gain ones of
        the dIdV fit: a Table with the JAX DataFrame's columns ("IV
        sweep", "dIdV infinite loop gain"; a missing cell is NaN) and its
        row labels in ``.index``."""
        result = self.get_fit_results(channel, poles, verbose=False)
        bias = result.get("biasparams")
        if bias is None:
            raise ValueError(f"no bias parameters for channel {channel}")
        ilg = result.get("biasparams_infinite_lgain", {})
        rows, labels = [], []
        for param, norm, label in (("r0", 1e3, "R0 [mOhms]"),
                                   ("i0", 1e6, "I0 [muAmps]"),
                                   ("p0", 1e15, "P0 [fWatts]")):
            row = {}
            if param in bias:
                row["IV sweep"] = "{:.3g} +/- {:.4g}".format(
                    bias[param] * norm,
                    bias.get(f"{param}_err", np.nan) * norm)
            if param in ilg:
                row["dIdV infinite loop gain"] = "{:.3g} +/- {:.4g}".format(
                    ilg[param] * norm, ilg.get(f"{param}_err", 0.0) * norm)
            rows.append(row)
            labels.append(label)
        table = records_table(rows)
        table.index = labels
        return table

    def print_fit_result(self, channels=None, poles: int = 3):
        """A readable summary of each channel's fit."""
        if channels is None:
            channels = list(self._fits.keys())
        elif isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            result = self.get_fit_results(chan, poles, verbose=False)
            if not result:
                print(f"{chan}: no {poles}-poles fit")
                continue
            print(f"{chan} {poles}-poles fit: cost = "
                  f"{result['cost']:.4g}")
            print(f"  params = "
                  f"{np.array2string(result['params'], precision=4)}")
            ssp = result.get("smallsignalparams")
            if ssp:
                for key in ("l", "beta", "tau0", "L"):
                    if key in ssp:
                        err = ssp.get(f"{key}_err", np.nan)
                        print(f"  {key} = {ssp[key]:.4g} +/- {err:.4g}")

    def plot_fit_result(self, channels=None, poles: int = 2,
                        save_path: Optional[str] = None):
        """Measured dIdV(f) against the fitted model, real and imaginary
        parts, one figure a channel (saved as
        ``didv_fit_{channel}_{poles}poles.png`` in ``save_path``)."""
        import matplotlib.pyplot as plt

        if channels is None:
            channels = list(self._fits.keys())
        elif isinstance(channels, str):
            channels = [channels]
        figs = []
        for chan in channels:
            data = self._didv_data[chan]
            fit = self._fits[chan][poles]
            model = didv_models.didv_model(fit.params, data.freqs,
                                           poles).numpy()
            fig, axes = plt.subplots(2, 1, sharex=True, figsize=(6, 5))
            for ax, part, name in ((axes[0], np.real, "Re"),
                                   (axes[1], np.imag, "Im")):
                ax.semilogx(data.freqs, part(data.didv), ".", ms=3,
                            label="measured")
                ax.semilogx(data.freqs, part(model), "-", label="fit")
                ax.set_ylabel(f"{name} dIdV [1/Ohms]")
                ax.grid(alpha=0.3)
            axes[0].legend()
            axes[0].set_title(f"{chan} {poles}-poles dIdV fit")
            axes[1].set_xlabel("frequency [Hz]")
            fig.tight_layout()
            if save_path:
                fig.savefig(os.path.join(
                    save_path, f"didv_fit_{chan}_{poles}poles.png"),
                    dpi=120)
            figs.append(fig)
        return figs

    def save_didv_data(self, channels=None,
                       file_path_name: Optional[str] = None,
                       save_hdf5: bool = False):
        """Store the fit results of each fitted pole count as
        ``didv_results_{p}poles_default`` (and write the HDF5 file with
        ``save_hdf5``)."""
        if channels is None:
            channels = list(self._didv_data.keys())
        elif isinstance(channels, str):
            channels = [channels]
        for chan in channels:
            if chan not in self._didv_data:
                raise ValueError(f"ERROR: No data found for channel "
                                 f"{chan}!")
            data = self._didv_data[chan]
            metadata = {"channel": chan, "sgfreq": data.sgfreq,
                        "sgamp": data.sgamp, "rsh": data.rsh}
            for p in sorted(self._fits.get(chan, {})):
                results = self.get_fit_results(chan, p, verbose=False)
                if results:
                    self.set_didv_results(chan, results, p,
                                          metadata=metadata)
        if save_hdf5:
            if file_path_name is None:
                raise ValueError("file_path_name required with save_hdf5")
            self.save_hdf5(file_path_name, overwrite=True)
        return self

