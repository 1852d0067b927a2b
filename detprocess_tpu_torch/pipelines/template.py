"""Templates: analytic, sum-of-two-pole, average-pulse and power-domain.

Port of ``detprocess_tpu/pipelines/template.py::Template`` (:20; the
reference's detprocess/core/template.py): ``create_template`` :23 (2, 3
or 4 poles from which of A/B/C are given; C without B is refused),
``create_template_sum_twopoles`` :67, ``calc_average_pulses`` :84,
``calc_power_template`` :111 and ``get_template_in_power`` :229 (dPdI
given or stored), ``fit_templates`` :129, ``get_template_in_current``
:186, ``clear`` :164 and ``qp_template``. Templates are host numpy in
float64, as in the JAX package; ``fit_templates`` runs the port's
Levenberg–Marquardt (``ops/lm``) in float64 on the host CPU, a fit of
three parameters.

``FilterBuilder`` (:270-308) puts ``Noise``, ``Template`` and the dIdV
analysis (``pipelines/didv.DIDVAnalysis``) over one filter store.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from detprocess_tpu_torch.io.filterdata import FilterData
from detprocess_tpu_torch.models import didv as didv_models
from detprocess_tpu_torch.models import pulse
from detprocess_tpu_torch.ops import lm


class Template(FilterData):
    """Template creation and storage."""

    def create_template(self, channels, sample_rate: float,
                        trace_length_samples: Optional[int] = None,
                        trace_length_msec: Optional[float] = None,
                        pretrigger_length_samples: Optional[int] = None,
                        pretrigger_length_msec: Optional[float] = None,
                        A: float = 1.0, B: Optional[float] = None,
                        C: Optional[float] = None,
                        tau_r: Optional[float] = None,
                        tau_f1: Optional[float] = None,
                        tau_f2: Optional[float] = None,
                        tau_f3: Optional[float] = None,
                        tag: str = "default"):
        """Analytic 2/3/4-pole template; the pole count follows from
        which of A/B/C are given."""
        if trace_length_samples is None:
            if trace_length_msec is None:
                raise ValueError("trace length required")
            trace_length_samples = int(round(
                trace_length_msec * 1e-3 * sample_rate))
        if pretrigger_length_samples is None:
            if pretrigger_length_msec is None:
                raise ValueError("pretrigger length required")
            pretrigger_length_samples = int(round(
                pretrigger_length_msec * 1e-3 * sample_rate))
        if C is not None and B is None:
            raise ValueError(
                "C (4th-pole amplitude) requires B: pulse.make_template "
                "dispatches on B and would silently build a two-pole "
                "template while the metadata claimed more poles")
        template = pulse.make_template(
            sample_rate, trace_length_samples, pretrigger_length_samples,
            A=A, B=B, C=C, tau_r=tau_r, tau_f1=tau_f1, tau_f2=tau_f2,
            tau_f3=tau_f3)
        poles = 2 + (B is not None) + (C is not None)
        md = {"nb_poles": poles, "A": A, "tau_r": tau_r, "tau_f1": tau_f1}
        if B is not None:
            md.update({"B": B, "tau_f2": tau_f2})
        if C is not None:
            md.update({"C": C, "tau_f3": tau_f3})
        self.set_template(channels, template, sample_rate,
                          pretrigger_length_samples=pretrigger_length_samples,
                          tag=tag, metadata=md)
        return template

    def create_template_sum_twopoles(self, channels, amplitudes, rise_times,
                                     fall_times, sample_rate: float,
                                     trace_length_samples: int,
                                     pretrigger_length_samples: int,
                                     tag: str = "default"):
        """Sum-of-two-poles template, unit peak."""
        t = np.arange(trace_length_samples) / sample_rate
        t0 = pretrigger_length_samples / sample_rate
        template = pulse.make_template_sum_twopoles(
            t, amplitudes, rise_times, fall_times, t0=t0)
        self.set_template(channels, template, sample_rate,
                          pretrigger_length_samples=pretrigger_length_samples,
                          tag=tag,
                          metadata={"nb_sum_twopoles": len(amplitudes)})
        return template

    def calc_average_pulses(self, channels, traces: np.ndarray,
                            sample_rate: float,
                            pretrigger_length_samples: int,
                            normalize: bool = True, tag: str = "default"):
        """Average-pulse template of events [B, N] (or [B, C, N]): the
        mean of the traces less their first half-pretrigger's mean, at
        unit peak."""
        traces = np.asarray(traces, dtype=np.float64)
        base = traces[..., : pretrigger_length_samples // 2].mean(
            axis=-1, keepdims=True)
        avg = (traces - base).mean(axis=0)
        if normalize:
            peak = np.max(np.abs(avg), axis=-1, keepdims=True)
            peak[peak == 0] = 1.0
            avg = avg / peak
        if avg.ndim == 1:
            self.set_template(channels, avg, sample_rate,
                              pretrigger_length_samples=(
                                  pretrigger_length_samples), tag=tag)
        else:
            chans = [channels] if isinstance(channels, str) else channels
            for i, chan in enumerate(chans):
                self.set_template(chan, avg[i], sample_rate,
                                  pretrigger_length_samples=(
                                      pretrigger_length_samples), tag=tag)
        return avg

    def calc_power_template(self, channel: str, dpdi: np.ndarray,
                            sample_rate: float, tag: str = "default",
                            power_tag: str = "power"):
        """The stored current template in power via dPdI, at unit peak,
        stored under ``power_tag``."""
        tmpl, _, md = self.get_template(channel, tag=tag,
                                        return_metadata=True)
        power = didv_models.convert_template_to_power(tmpl, dpdi,
                                                      sample_rate)
        peak = np.max(np.abs(power))
        if peak > 0:
            power = power / peak
        self.set_template(channel, power, sample_rate,
                          pretrigger_length_samples=md[
                              "nb_pretrigger_samples"],
                          tag=power_tag, metadata={"domain": "power"})
        return power

    def fit_templates(self, channel: str, tag: str = "default",
                      fs: Optional[float] = None) -> dict:
        """Fit the stored template with a two-pole pulse from
        (τ_r, τ_f, A) = (20 µs, 200 µs, 1), 100 LM steps; the result
        (also stored as ``template_fit_{tag}``)."""
        tmpl, _, md = self.get_template(channel, tag=tag,
                                        return_metadata=True)
        fs = fs or md.get("sample_rate")
        p = md.get("nb_pretrigger_samples", len(tmpl) // 2)
        t = np.arange(len(tmpl)) / fs
        t0 = p / fs

        def residual(params, t, y):
            tau_r, tau_f, amp = params
            tp = t - t0
            model = torch.where(
                tp >= 0,
                amp * (torch.exp(-tp / torch.abs(tau_f))
                       - torch.exp(-tp / torch.abs(tau_r))),
                torch.zeros_like(tp))
            return model - y

        f64 = dict(dtype=torch.float64, device="cpu")
        res = lm.levenberg_marquardt(
            residual, torch.tensor([20e-6, 200e-6, 1.0], **f64),
            args=(torch.as_tensor(t, **f64),
                  torch.as_tensor(np.asarray(tmpl), **f64)),
            max_iter=100)
        tau_r, tau_f, amp = np.abs(res.params.numpy())
        fit = {"tau_r": float(tau_r), "tau_f": float(tau_f),
               "amplitude": float(amp), "cost": float(res.cost)}
        self._set(channel, f"template_fit_{tag}", dict(fit), None)
        return fit

    def clear(self, channels=None, clear_filter_data: bool = False,
              tag: Optional[str] = None):
        """Drop the stored templates (every ``template*`` parameter whose
        name holds ``tag``); ``clear_filter_data`` drops every parameter
        (``clear_data``)."""
        if clear_filter_data:
            self.clear_data(channels=channels, tag=tag)
            return
        chans = (list(self._filter_data) if channels is None
                 else [channels] if isinstance(channels, str)
                 else list(channels))
        for chan in chans:
            d = self._filter_data.get(chan)
            if not d:
                continue
            for key in [k for k in d if k.startswith("template")
                        and (tag is None or tag in k)]:
                d.pop(key)

    def get_template_in_current(self, channels, use_fit: bool = True,
                                domain: str = "time",
                                return_metadata: bool = False,
                                tag: str = "default"):
        """Template(s) in TES-current units: the smooth two-pole of a
        stored ``fit_templates`` result with ``use_fit``; ``domain="freq"``
        gives the two-sided FFT."""
        chans = [channels] if isinstance(channels, str) else list(channels)
        out, mds = [], []
        for chan in chans:
            tmpl, _, md = self.get_template(chan, tag=tag,
                                            return_metadata=True)
            tmpl = np.asarray(tmpl)
            md = dict(md or {})
            fit = (self._get(chan, f"template_fit_{tag}")[0]
                   if use_fit and self.has(chan, f"template_fit_{tag}")
                   else None)
            if fit:
                fs = float(md.get("sample_rate"))
                p = int(md.get("nb_pretrigger_samples", len(tmpl) // 2))
                t = np.arange(len(tmpl)) / fs - p / fs
                tmpl = np.where(
                    t >= 0,
                    fit["amplitude"] * (np.exp(-t / fit["tau_f"])
                                        - np.exp(-t / fit["tau_r"])),
                    0.0)
                md["from_fit"] = True
            if domain in ("freq", "fourier"):
                tmpl = np.fft.fft(tmpl)
            elif domain != "time":
                raise ValueError('domain should be "time" or "freq"')
            out.append(tmpl)
            mds.append(md)
        if isinstance(channels, str):
            out, mds = out[0], mds[0]
        return (out, mds) if return_metadata else out

    def get_template_in_power(self, channels, dpdi=None, dpdi_freqs=None,
                              use_fit: bool = True, domain: str = "time",
                              return_metadata: bool = False,
                              tag: str = "default", dpdi_poles: int = 2,
                              dpdi_tag: str = "default"):
        """Template(s) in power via dPdI: ``dpdi`` given, else the one
        stored for ``dpdi_poles``/``dpdi_tag``."""
        chans = [channels] if isinstance(channels, str) else list(channels)
        out, mds = [], []
        for chan in chans:
            cur, md = self.get_template_in_current(
                chan, use_fit=use_fit, domain="time", return_metadata=True,
                tag=tag)
            fs = float(md.get("sample_rate"))
            chan_dpdi = dpdi
            if chan_dpdi is None:
                chan_dpdi, _ = self.get_dpdi(chan, dpdi_poles, tag=dpdi_tag)
            power = didv_models.convert_template_to_power(
                cur, np.asarray(chan_dpdi), fs)
            if domain in ("freq", "fourier"):
                power = np.fft.fft(power)
            elif domain != "time":
                raise ValueError('domain should be "time" or "freq"')
            out.append(power)
            mds.append(md)
        if isinstance(channels, str):
            out, mds = out[0], mds[0]
        return (out, mds) if return_metadata else out

    @property
    def qp_template(self):
        """The template manager: this object (there is no separate qetpy
        one)."""
        return self


class FilterBuilder:
    """``Noise`` + ``Template`` + ``DIDVAnalysis`` sharing one filter
    store (the reference's core/filterbuilder.py:7-82). ``device=None``
    means the GPU for the noise and dIdV trace work."""

    def __init__(self, raw_files=None, verbose: bool = True, device=None):
        from detprocess_tpu_torch.pipelines.didv import DIDVAnalysis
        from detprocess_tpu_torch.pipelines.noise import Noise

        self.noise = Noise(raw_files, verbose=verbose, device=device)
        self.template = Template(verbose=verbose)
        self.didv = DIDVAnalysis(verbose=verbose, device=device)
        shared = self.noise._filter_data
        self.template._filter_data = shared
        self.didv._filter_data = shared
        self._filter_data = shared

    def clear(self, channels=None, tag=None, clear_noise_state: bool = True,
              clear_template_state: bool = False,
              clear_didv_state: bool = True):
        """Clear the shared store, and the processors' state as asked."""
        self.noise.clear_data(channels=channels, tag=tag)
        if clear_noise_state:
            self.noise.clear_randoms()
        if clear_template_state:
            self.template.clear(channels=channels, tag=tag)
        if clear_didv_state:
            self.didv.clear(channels=channels)

    def save_hdf5(self, path: str, overwrite: bool = True):
        self.noise.save_hdf5(path, overwrite=overwrite)

    def load_hdf5(self, path: str, overwrite: bool = False):
        self.noise.load_hdf5(path, overwrite=overwrite)
        return self

    def describe(self):
        self.noise.describe()
