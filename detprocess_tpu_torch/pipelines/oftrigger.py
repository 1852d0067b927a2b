"""The optimal-filter trigger on one continuous trace, as an object: the
notebook-facing counterpart of :class:`~detprocess_tpu_torch.pipelines.
triggers.TriggerProcessing`.

Port of ``detprocess_tpu/pipelines/oftrigger.py::OptimumFilterTrigger``
(:53) and ``combine_trigger_data`` (:439): ``update_trace`` →
``find_triggers`` → ``get_trigger_data`` / ``get_trigger_data_df``, the
protocol that ``EventBuilder.acquire_triggers`` drives. The filtering runs
on the object's device in its dtype (``ops/trigger.of_fir`` and
``delta_chi2``, whose segment rFFTs are the hand-written kernel on the
card, and ``ops/spectral.lowpass_filter``); the merge, the saturation
veto, the residual subtraction and the edge exclusion stay host numpy, as
in the JAX object. A trigger index needs no pretrigger shift: the FIR
kernel puts the filter's peak on the trigger point.

``get_trigger_data_df`` returns a table (a dict of numpy columns;
``io.tables.to_dataframe`` makes a DataFrame of it). The dynamic-window
mode (``dynamic=True``) groups with the host loop
``ops/trigger.find_triggers_dynamic``, which takes any Python callable.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import filterbank, spectral
from detprocess_tpu_torch.ops import trigger as trig_ops

SATURATION_LPF_HZ = 50e3


def _group_ranges_static(idx: np.ndarray, window: int):
    """Start/end positions (into ``idx``) of runs whose successive gaps
    are at most ``window``."""
    if len(idx) == 0:
        return np.zeros((0, 2), dtype=int)
    breaks = np.where(np.diff(idx) > window)[0] + 1
    starts = np.concatenate([[0], breaks])
    ends = np.concatenate([breaks, [len(idx)]])
    return np.stack([starts, ends], axis=1)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class OptimumFilterTrigger:
    """Time-domain optimal-filter trigger on one continuous trace.

    Parameters
    ----------
    trigger_channel : str or list of str (a list, or 'a|b', makes an NxM
        trigger).
    fs : sample rate (Hz).
    template : [C, M, S] templates, or [S], [1, S], [S, 1] for one.
    noisecsd : two-sided noise CSD [C, C, S] (or [S] like ``template``),
        A²/Hz.
    pretrigger_samples : the templates' trigger point.
    ignored_frequency_peaks, ignore_harmonics : frequencies (and their
        harmonics) notched out of the filter.
    trigger_name : the table's channel label (default: the channel name).
    device, dtype : where and in what precision the filtering runs
        (``device=None``: the GPU).
    """

    def __init__(self, trigger_channel, fs, template, noisecsd,
                 pretrigger_samples, ignored_frequency_peaks=None,
                 ignore_harmonics: bool = False,
                 trigger_name: Optional[str] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        self._device = (dev.require_cuda() if device is None
                        else torch.device(device))
        self._dtype = dtype
        self._fs = float(fs)
        self._pretrigger_samples = int(pretrigger_samples)
        if isinstance(trigger_channel, (list, tuple)):
            self._trigger_channel = "|".join(trigger_channel)
        else:
            self._trigger_channel = str(trigger_channel)
        name = (str(trigger_name) if trigger_name is not None
                else self._trigger_channel)
        self._trigger_name = name.replace("\0", "")

        self._bank = filterbank.make_ofnxm_bank(
            template, noisecsd, self._fs, self._pretrigger_samples,
            ignored_frequency_peaks=ignored_frequency_peaks,
            ignore_harmonics=ignore_harmonics)
        self._kernel = trig_ops.make_trigger_kernel(
            self._bank, real_dtype=(np.float64 if dtype == torch.float64
                                    else np.float32))
        self._g_fft = torch.as_tensor(self._kernel.g_fft,
                                      device=self._device)
        self._iw = torch.as_tensor(self._kernel.iw_matrix,
                                   device=self._device)

        self._n_channels = self._bank.nchans
        self._m_amplitudes = self._bank.ntmps
        self._nb_samples = self._bank.nbins
        self._posttrigger_samples = (self._nb_samples
                                     - self._pretrigger_samples)
        # the time-domain filter of get_phi, DC removed
        phi_fd = np.array(self._bank.phi)
        phi_fd[:, :, 0] = 0.0
        self._phi_td = np.fft.ifft(phi_fd, axis=2).real
        self._norm = float(np.dot(self._phi_td[0, 0],
                                  np.asarray(self._bank.templates)[0, 0]))
        self._resolution = np.asarray(self._bank.resolution)

        self.chi2_threshold: Optional[float] = None
        self._trigger_data: Optional[dict] = None
        self._raw_trace: Optional[np.ndarray] = None
        self._raw_trace_lpf_50khz: Optional[np.ndarray] = None
        self._filtered_trace: Optional[np.ndarray] = None
        self._delta_chi2_trace: Optional[np.ndarray] = None
        self._residual_delta_chi2_trace: Optional[np.ndarray] = None

    # -- accessors ---------------------------------------------------------
    def get_filtered_trace(self):
        """Amplitude series a(t) [M, L] of the last update_trace."""
        return self._filtered_trace

    def get_filtered_delta_chi2(self):
        """Δχ²(t) [L] of the last update_trace."""
        return self._delta_chi2_trace

    def get_chi2_threshold(self):
        return self.chi2_threshold

    def get_trigger_data(self):
        """The trigger dict, keyed by trigger name."""
        return self._trigger_data

    def get_trigger_data_df(self) -> Optional[dict]:
        """The triggers as a table (dict of numpy columns)."""
        if self._trigger_data is None:
            return None
        data = self._trigger_data[self._trigger_name]
        return {k: np.asarray(v, dtype=object)
                if v and isinstance(v[0], str) else np.asarray(v)
                for k, v in data.items()}

    def get_phi(self):
        """Time-domain optimal filter [C, M, S], DC removed."""
        return self._phi_td

    def get_norm(self):
        """φ·s of the first channel and template."""
        return self._norm

    def get_resolution(self):
        """Amplitude resolution per template, √diag(W⁻¹)."""
        return self._resolution

    # -- the trace ---------------------------------------------------------
    def _lowpass(self, x: torch.Tensor) -> np.ndarray:
        return _host(spectral.lowpass_filter(x, SATURATION_LPF_HZ,
                                             self._fs)).astype(np.float64)

    def update_trace(self, trace=None, filtered_trace=None,
                     padding: bool = True):
        """Filter ``trace`` [C, L] (or [L]) on the device, or adopt an
        already filtered ``filtered_trace`` [M, L]; ``padding`` zeroes
        Δχ² within a template length of each edge."""
        if trace is None and filtered_trace is None:
            raise ValueError('ERROR: "trace" or "filtered_trace" '
                             "required!")
        if trace is not None:
            trace = np.atleast_2d(_host(trace))
            if trace.shape[0] != self._n_channels:
                raise ValueError(
                    f'ERROR: "trace" has shape {trace.shape}, but this '
                    f"trigger has {self._n_channels} channel(s)")
            self._raw_trace = trace
            x = torch.as_tensor(trace, dtype=self._dtype,
                                device=self._device)

        if filtered_trace is not None:
            filtered_trace = np.atleast_2d(_host(filtered_trace))
            if filtered_trace.shape[0] != self._m_amplitudes:
                raise ValueError(
                    f'ERROR: "filtered_trace" has shape '
                    f"{filtered_trace.shape}, but this trigger has "
                    f"{self._m_amplitudes} amplitude(s)")
            self._filtered_trace = filtered_trace.astype(np.float64)
            w = np.asarray(self._bank.w_matrix)
            self._delta_chi2_trace = np.einsum(
                "iz,ij,jz->z", self._filtered_trace, w,
                self._filtered_trace).real
            if trace is not None:
                self._raw_trace_lpf_50khz = self._lowpass(x)
            else:
                # a previous trace's low-pass must not drive the veto
                self._raw_trace = None
                self._raw_trace_lpf_50khz = None
        else:
            length = trace.shape[-1]
            kernel = self._kernel._replace(g_fft=self._g_fft)
            q = trig_ops.of_fir(x, kernel, valid_range=(0, length))
            dchi2, amps = trig_ops.delta_chi2(q, self._iw)
            self._filtered_trace = _host(amps).astype(np.float64)
            self._delta_chi2_trace = _host(dchi2).astype(np.float64)
            self._raw_trace_lpf_50khz = self._lowpass(x)

        if padding:
            cut = self._nb_samples
            self._delta_chi2_trace[:cut] = 0.0
            self._delta_chi2_trace[len(self._delta_chi2_trace)
                                   - cut + (cut + 1) % 2:] = 0.0

    # -- triggering --------------------------------------------------------
    def find_triggers_once(self, thresh, pileup_window_msec=None,
                           pileup_window_samples=None,
                           dynamic: bool = False,
                           dynamic_threshold_function=None):
        """One threshold + pileup merge pass over the stored Δχ²: one
        trigger a merged group, at its largest Δχ². With ``dynamic``, the
        merge window is ``dynamic_threshold_function`` of the group's
        running maximum Δχ² (any Python callable)."""
        if self._delta_chi2_trace is None:
            raise ValueError('ERROR: Filtered trace not available. '
                             'Use "update_trace" first!')
        if dynamic and dynamic_threshold_function is None:
            raise ValueError("dynamic=True requires "
                             "dynamic_threshold_function")
        pileup_window = 0
        if pileup_window_msec is not None:
            pileup_window = int(pileup_window_msec * self._fs / 1000)
        elif pileup_window_samples is not None:
            pileup_window = int(pileup_window_samples)
        self.chi2_threshold = trig_ops.chi2_threshold(float(thresh),
                                                      self._m_amplitudes)

        dchi2 = self._delta_chi2_trace
        if dynamic:
            winners, _, _ = trig_ops.find_triggers_dynamic(
                dchi2, self._filtered_trace, self.chi2_threshold,
                dynamic_threshold_function)
            winners = [int(w) for w in winners]
        else:
            above = np.where(dchi2 > self.chi2_threshold)[0]
            winners = [int(above[st:en][np.argmax(dchi2[above[st:en]])])
                       for st, en in _group_ranges_static(above,
                                                          pileup_window)]

        data: dict = {
            "trigger_delta_chi2": [], "trigger_time": [],
            "trigger_index": [], "trigger_pileup_window": [],
            "trigger_threshold_sigma": [], "trigger_type": []}
        for iamp in range(self._m_amplitudes):
            data[f"trigger_amplitude_{iamp}"] = []
        if self._m_amplitudes == 1:
            data["trigger_amplitude"] = []
        for win in winners:
            data["trigger_index"].append(int(win))
            data["trigger_time"].append(win / self._fs)
            data["trigger_delta_chi2"].append(float(dchi2[win]))
            data["trigger_type"].append(4)
            for iamp in range(self._m_amplitudes):
                data[f"trigger_amplitude_{iamp}"].append(
                    float(self._filtered_trace[iamp][win]))
            if self._m_amplitudes == 1:
                data["trigger_amplitude"].append(
                    float(self._filtered_trace[0][win]))
            data["trigger_threshold_sigma"].append(float(thresh))
            data["trigger_pileup_window"].append(pileup_window)
        # present even without triggers, so that empty tables concatenate
        data["trigger_channel"] = [self._trigger_name] * len(winners)
        out = dict(data)
        for key, val in data.items():
            out[f"{key}_{self._trigger_name}"] = val
        self._trigger_data = {self._trigger_name: out}

    def _is_saturated(self, trigger_index: int, sat_amps,
                      positive_pulses: bool) -> bool:
        half = self._nb_samples // 4
        lpf = self._raw_trace_lpf_50khz
        if lpf is None:
            return False
        lo = max(trigger_index - half, 0)
        hi = trigger_index + half
        for c in range(self._n_channels):
            seg = lpf[c, lo:hi]
            if positive_pulses:
                if np.any(seg > sat_amps[c]):
                    return True
            elif np.any(seg < -sat_amps[c]):
                return True
        return False

    def _subtract_trigger(self, trigger_index: int):
        """Subtract one trigger's best-fit Δχ² shape from the stored Δχ²,
        its peak on the trigger."""
        amps = self._filtered_trace[:, trigger_index]
        resp = np.asarray(self._kernel.response, dtype=np.float64)
        v = np.einsum("ijd,j->id", resp, amps)
        iw = np.asarray(self._kernel.iw_matrix, dtype=np.float64)
        w = np.asarray(self._bank.w_matrix, dtype=np.float64)
        fit = iw @ v
        shape = np.einsum("id,ij,jd->d", fit, w, fit).real
        j = int(np.argmax(shape))
        lo = trigger_index - j
        hi = lo + shape.shape[0]
        clo, chi = max(lo, 0), min(hi, len(self._delta_chi2_trace))
        self._delta_chi2_trace[clo:chi] -= shape[clo - lo:chi - lo]

    def find_triggers(self, thresh, pileup_window_msec=None,
                      pileup_window_samples=None,
                      positive_pulses: bool = True, dynamic: bool = False,
                      dynamic_threshold_function=None,
                      residual: bool = False,
                      saturation_amplitudes_LPF_50kHz=None,
                      edge_exclusion_msec=None, livetime=None,
                      return_trigger_data: bool = False):
        """Threshold trigger with the optional residual re-trigger (every
        unsaturated first-pass trigger's Δχ² shape subtracted, the
        residual triggered again, new indices merged in), saturation veto
        and edge exclusion. ``return_trigger_data=True`` returns (first
        data, first Δχ², second data, second Δχ²) of a residual run."""
        ret = None
        if residual:
            if saturation_amplitudes_LPF_50kHz is None:
                saturation_amplitudes_LPF_50kHz = [np.inf] * self._n_channels
            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)
            first = copy.deepcopy(self._trigger_data)
            first_idx = list(
                self._trigger_data[self._trigger_name]["trigger_index"])
            first_dchi2 = np.copy(self._delta_chi2_trace)
            for ti in first_idx:
                if not self._is_saturated(ti, saturation_amplitudes_LPF_50kHz,
                                          positive_pulses):
                    self._subtract_trigger(ti)
            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)
            second = copy.deepcopy(self._trigger_data)
            second_idx = list(
                self._trigger_data[self._trigger_name]["trigger_index"])
            self._residual_delta_chi2_trace = np.copy(self._delta_chi2_trace)
            second_dchi2 = np.copy(self._delta_chi2_trace)
            self._delta_chi2_trace = first_dchi2
            self._trigger_data = combine_trigger_data(first, second,
                                                      first_idx, second_idx)
            if return_trigger_data:
                ret = (first, first_dchi2, second, second_dchi2)
        else:
            self.find_triggers_once(thresh, pileup_window_msec,
                                    pileup_window_samples, dynamic,
                                    dynamic_threshold_function)

        if edge_exclusion_msec is not None:
            tmin = edge_exclusion_msec * 1e-3
            tmax = (self._filtered_trace.shape[-1] / self._fs) - tmin
            for chan, data in list(self._trigger_data.items()):
                times = data["trigger_time"]
                if len(times) == 0:
                    continue
                keep = [i for i, t in enumerate(times) if tmin < t < tmax]
                out = {k: [v[i] for i in keep] for k, v in data.items()}
                out[f"trigger_edge_exclusion_time_{chan}"] = [tmin] * len(
                    keep)
                if livetime is not None:
                    out[f"trigger_livetime_{chan}"] = [livetime] * len(keep)
                self._trigger_data[chan] = out
        return ret


def combine_trigger_data(original_trigger_data, new_trigger_data,
                         original_triggers, new_triggers):
    """Two trigger dicts merged: the entries of ``new_triggers`` whose
    index is not among ``original_triggers`` appended, columns of one pass
    only padded with None so that every column stays row-aligned."""
    unique = set(new_triggers) - set(original_triggers)
    name = next(iter(original_trigger_data))
    merged = copy.deepcopy(original_trigger_data[name])
    new_inner = new_trigger_data[name]
    take = [i for i, t in enumerate(new_triggers) if t in unique]
    n_orig = len(merged.get("trigger_index", ()))
    for key, vals in new_inner.items():
        if key not in merged:
            merged[key] = [None] * n_orig + [vals[i] for i in take]
            continue
        merged[key] = list(merged[key]) + [vals[i] for i in take]
    for key in merged:
        if key not in new_inner and len(merged[key]) == n_orig:
            merged[key] = list(merged[key]) + [None] * len(take)
    # suffixed duplicates stay equal to their base columns
    for key in list(merged):
        base = key.removesuffix(f"_{name}")
        if base != key and base in merged:
            merged[key] = list(merged[base])
    return {name: merged}
