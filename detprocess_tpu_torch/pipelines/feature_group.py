"""One trace group of the feature plan as a module: a batch of raw
traces in, the group's feature columns out.

Counterpart of the function that
``detprocess_tpu/pipelines/features.py::_make_group_fn`` (:627-1107)
builds, on the natural half spectrum only (the TPU package's packed and
permuted layouts are not ported). Per batch:

1. the compound-channel mix ``[C_c, C_r] × [B, C_r, N]`` (TF32 off) of
   the group's window cut of the raw traces;
2. one ``ops/fft.rfft`` per spectral compound channel, shared by every
   spec that reads it (an of1x1 or ``of1x2x2`` fit, a PSD feature, an NxM
   sub-channel, ``rftau``'s low-pass): the rFFT kernel, or cuFFT for a
   length outside its domain;
3. the specs in plan order:

   - ``of1x1_nodelay``: where the fused kernel takes N, its amp and χ²
     (``ops/cuda_of.FusedNodelayOF``, one launch per spec, slot-sliced)
     and lowchi2 on the step-2 spectrum; elsewhere
     ``of1x1_nodelay_half``;
   - ``of1x1_unconstrained`` and ``of1x1_constrained``: the delay scan
     ``of1x1_withdelay_half`` with the spec's ``lowchi2_fcutoff`` and
     ``interpolate``, aligned on the templates' own pretrigger; the
     constrained fit within its window mask, with its ``chi2nopulse``,
     ``ampres`` and ``timeres`` columns;
   - ``of1x2x2``: the joint two-template scan ``of1x1.of1x2_half`` over
     the spec's Δ window (``delta_window_*_usec``), its template overlap
     computed once here;
   - ``ofnxm``: the no-delay and delay-scan NxM fits on the stacked
     spectra of its sub-channels (``interpolate_t0``, window mask);
   - ``ofnxmx2``: the pair scan ``ops/ofnxm.ofnxmx2_half``, each weight
     matrix of its fit windows inverted once here;
   - ``psd_amp``, ``psd_peaks`` and ``phase`` (``ops/psdfeatures``) per
     frequency range of ``f_lims``;
   - ``rftau``: the two-pole LM fit of ``ops/pulsefit`` on the low-pass of
     the step-2 spectrum;
   - ``baseline``, ``integral``, ``maximum``, ``minimum`` and
     ``energyabsorbed`` over their windows.

Columns carry the JAX names. On CUDA tensors step 2 and the fused fit
launch the hand-written kernels; on CPU tensors they run their plain
twins.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import cuda_fft, fft, filterbank, of1x1
from detprocess_tpu_torch.ops import ofnxm, psdfeatures, pulsefit
from detprocess_tpu_torch.ops import tracestats
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF
from detprocess_tpu_torch.pipelines import feature_plan as fplan
from detprocess_tpu_torch.utils import freq as frequtils

# specs whose compound channel is read through its half spectrum
SPECTRAL = fplan.OF_1X1_ALGORITHMS + ("of1x2x2", "rftau") \
    + fplan.PSD_ALGORITHMS


def layer_name(spec: fplan.AlgoSpec) -> str:
    """The name under which ``GroupStep.forward`` runs a spec's layer."""
    return f"{spec.algorithm}:{spec.channel}"


class GroupStep(nn.Module):
    """The feature step of one :class:`feature_plan.TraceGroup`.

    ``raw_geometry`` (nb_samples, pretrigger) of the raw traces the step
    is given; ``dtype`` float32 or float64.
    """

    def __init__(self, group: fplan.TraceGroup, fs: float,
                 raw_geometry: tuple, device, dtype=torch.float32):
        super().__init__()
        self.fs = float(fs)
        self.n = n = int(group.nb_samples)
        self.pretrigger = int(group.nb_pretrigger)
        # delay alignment on the templates' own pretrigger when stored
        self.of_pretrigger = (group.of_pretrigger
                              if group.of_pretrigger is not None
                              else self.pretrigger)
        self.cut = fplan.window_cut(group, *raw_geometry)
        self.specs = list(group.specs)
        if torch.device(device).type == "cuda":
            dev.set_full_f32()          # the mix runs in full float32
        self.register_buffer("mix", torch.as_tensor(
            np.asarray(group.mix_matrix), dtype=dtype, device=device))
        # one transform per compound channel that a spectral spec reads
        spectral = {s.chan_idx for s in self.specs if s.base in SPECTRAL}
        for s in self.specs:
            spectral.update(s.nxm_chan_idx)
        self.spectral = sorted(spectral)
        self.bank = None
        self.low = {}
        self.masks = {}
        self.nodelay = nn.ModuleDict()
        self.of1x2 = {}
        self.nxm = {}
        self.nxmx2 = {}
        self.psd = {}
        if group.bank_1x1 is not None:
            self.bank = bank = filterbank.bank_to_torch(group.bank_1x1,
                                                        device, dtype)
        for s in self.specs:
            key = (s.algorithm, s.channel)
            if s.base in fplan.OF_1X1_ALGORITHMS:
                fc = float(s.kwargs.get("lowchi2_fcutoff", 10000))
                if fc not in self.low:
                    self.low[fc] = torch.as_tensor(
                        of1x1.lowfreq_mask_half(n, self.fs, fc),
                        device=device)
                if s.base == "of1x1_constrained":
                    self.masks[key] = torch.as_tensor(
                        fplan.window_mask(s, n, self.pretrigger, self.fs),
                        device=device)
                if (s.base == "of1x1_nodelay" and n in cuda_fft.SUPPORTED_N
                        and str(s.slot) not in self.nodelay):
                    self.nodelay[str(s.slot)] = FusedNodelayOF.from_bank(
                        bank, slots=[s.slot])
            elif s.base == "of1x2x2":
                one, two = slice(s.slot, s.slot + 1), slice(s.slot2,
                                                            s.slot2 + 1)
                # the templates' overlap c(Δ) is a bank constant
                self.of1x2[key] = (of1x1.of1x2_overlap(
                    bank["phi_h"][one], bank["norm"][one],
                    bank["s_fft_h"][two], bank["norm"][two], n),
                    of1x1.delta_scan(fplan.delta_window(s, self.fs), n,
                                     device))
            elif s.base in fplan.OF_NXM_ALGORITHMS:
                if s.nxm_key not in self.nxm:
                    self.nxm[s.nxm_key] = filterbank.bank_nxm_to_torch(
                        group.nxm_banks[s.nxm_key], device, dtype)
                if s.base == "ofnxm":
                    mask = fplan.window_mask(s, n, self.pretrigger, self.fs)
                    self.masks[key] = (None if mask is None else
                                       torch.as_tensor(mask, device=device))
                else:
                    # each P(Δ)⁻¹ of the fit windows, inverted once
                    plan = ofnxm.nxmx2_plan(group.nxm_banks[s.nxm_key],
                                            *fplan.nxmx2_windows(s, n))
                    self.nxmx2[key] = ofnxm.nxmx2_tensors(plan, device,
                                                          dtype)
            elif s.base in fplan.PSD_ALGORITHMS:
                self.psd[key] = self._psd_setup(s, device)

    def _psd_setup(self, spec, device):
        """Index ranges (``psd_amp``) or bands (``psd_peaks``, ``phase``)
        of a PSD spec's ``f_lims``, with their column-name stubs."""
        kw = spec.kwargs
        ranges, names = frequtils.cleanup_freq_ranges(kw.get("f_lims", []))
        freqs = frequtils.folded_freqs(self.n, self.fs)
        if spec.base == "psd_amp":
            return frequtils.get_ind_freq_ranges(ranges, freqs), names
        min_sep = float(kw.get("min_separation_hz", 0.0))
        dist = int(np.ceil(min_sep / (self.fs / self.n))) if min_sep > 0 \
            else 0
        bands = [torch.as_tensor(psdfeatures.band_mask(freqs, fr),
                                 device=device) for fr in ranges]
        return bands, names, int(kw.get("npeaks", 1)), dist

    def forward(self, raw: torch.Tensor, run_layer=None) -> dict:
        """``raw`` [B, C_r, N_raw] → dict of [B] feature columns.

        ``run_layer(name, fn, *args)``, if given, runs each layer in place
        of ``fn(*args)`` and returns its result, so that a caller can time
        the layers of this very path: ``"mix"``, ``"rfft"``, then one per
        spec (:func:`layer_name`)."""
        run = run_layer or (lambda name, fn, *args: fn(*args))
        chan = run("mix", self._mix, raw)
        vh = run("rfft", self._spectra, chan)
        out = {}
        for spec in self.specs:
            out.update(run(layer_name(spec), self._spec, spec, chan, vh))
        return out

    def _mix(self, raw):
        if self.cut is not None:
            raw = raw[..., self.cut:self.cut + self.n]
        traces = torch.einsum("cr,brn->bcn", self.mix.to(raw.dtype), raw)
        chan = {ci: traces[:, ci, :] for ci in
                {s.chan_idx for s in self.specs if s.chan_idx >= 0}}
        chan.update({ci: traces[:, ci, :].contiguous()
                     for ci in self.spectral})
        return chan

    def _spectra(self, chan):
        return {ci: fft.rfft(chan[ci]) for ci in self.spectral}

    def _spec(self, spec, chan, vh) -> dict:
        name, fc, kw = spec.algorithm, spec.feature_channel, spec.kwargs
        base = spec.base
        key = (name, spec.channel)
        fs, n = self.fs, self.n
        out = {}
        if base in fplan.OF_1X1_ALGORITHMS:
            b = self.bank
            sl = slice(spec.slot, spec.slot + 1)
            phi, s_fft = b["phi_h"][sl], b["s_fft_h"][sl]
            dinv, norm = b["denom_inv_h"][sl], b["norm"][sl]
            lmask = self.low[float(kw.get("lowchi2_fcutoff", 10000))]
            vr = vh[spec.chan_idx][:, None, :]
            if base == "of1x1_nodelay":
                fused = self.nodelay[str(spec.slot)] \
                    if str(spec.slot) in self.nodelay else None
                if fused is None:
                    r = of1x1.of1x1_nodelay_half(
                        vr, phi, norm, dinv, s_fft, b["bin_w"], lmask, n)
                    amp, chi2, low = r.amp, r.chi2, r.lowchi2
                else:
                    amp, chi2 = fused(chan[spec.chan_idx])
                    low = of1x1._residual_chi2_half(
                        vr, amp, torch.zeros_like(amp), s_fft, dinv,
                        b["bin_w"], lmask, n)
                out[f"amp_{name}_{fc}"] = amp[:, 0]
                out[f"chi2_{name}_{fc}"] = chi2[:, 0]
                out[f"lowchi2_{name}_{fc}"] = low[:, 0]
                return out
            constrained = base == "of1x1_constrained"
            r = of1x1.of1x1_withdelay_half(
                vr, phi, norm, dinv, s_fft, b["bin_w"],
                self.of_pretrigger, fs,
                window_mask=self.masks[key] if constrained else None,
                low_mask_h=lmask,
                interpolate_t0=bool(kw.get("interpolate", False)), n=n)
            out[f"amp_{name}_{fc}"] = r.amp[:, 0]
            out[f"t0_{name}_{fc}"] = r.t0[:, 0]
            out[f"chi2_{name}_{fc}"] = r.chi2[:, 0]
            out[f"lowchi2_{name}_{fc}"] = r.lowchi2[:, 0]
            if constrained:
                out[f"chi2nopulse_{name}_{fc}"] = r.chi2_nopulse[:, 0]
                out[f"ampres_{name}_{fc}"] = of1x1.energy_resolution(
                    norm)[0].expand(r.amp.shape[0])
                out[f"timeres_{name}_{fc}"] = of1x1.time_resolution_half(
                    r.amp[:, 0], s_fft[0], dinv[0], b["bin_w"], n, fs)
        elif base == "of1x2x2":
            b = self.bank
            one = slice(spec.slot, spec.slot + 1)
            two = slice(spec.slot2, spec.slot2 + 1)
            c_all, scan = self.of1x2[key]
            r = of1x1.of1x2_half(
                vh[spec.chan_idx][:, None, :], b["phi_h"][one], b["norm"][one],
                b["phi_h"][two], b["norm"][two], b["s_fft_h"][two],
                b["denom_inv_h"][one], b["bin_w"], self.of_pretrigger, fs, n,
                c_all=c_all, scan=scan)
            out[f"scintillation_amp_{name}_{fc}"] = r.amp1[:, 0]
            out[f"evaporation_amp_{name}_{fc}"] = r.amp2[:, 0]
            out[f"time_diff_{name}_{fc}"] = r.time_diff[:, 0]
        elif base in fplan.OF_NXM_ALGORITHMS:
            nb = self.nxm[spec.nxm_key]
            vr = torch.stack([vh[c] for c in spec.nxm_chan_idx], dim=1)
            m = nb["iw_matrix"].shape[0]
            names = kw.get("amplitude_names") or [f"amp{i + 1}"
                                                  for i in range(m)]
            if base == "ofnxm":
                r_nd = ofnxm.ofnxm_nodelay_half(
                    vr, nb["phi_h"], nb["iw_matrix"], nb["icsd_h"],
                    nb["bin_w"], fs, n)
                r_wd = ofnxm.ofnxm_withdelay_half(
                    vr, nb["phi_h"], nb["iw_matrix"], nb["icsd_h"],
                    nb["bin_w"], self.of_pretrigger, fs, n,
                    window_mask=self.masks[key],
                    interpolate_t0=bool(kw.get("interpolate_t0", False)))
                for i, an in enumerate(names):
                    out[f"{an}_{name}_constrained_{fc}"] = r_wd.amps[:, i]
                    out[f"{an}_{name}_nodelay_{fc}"] = r_nd.amps[:, i]
                out[f"chi2_{name}_constrained_{fc}"] = r_wd.chi2
                out[f"t0_{name}_constrained_{fc}"] = r_wd.t0
                out[f"chi2_{name}_nodelay_{fc}"] = r_nd.chi2
            else:
                r = ofnxm.ofnxmx2_half(vr, nb["phi_h"], nb["icsd_h"],
                                       nb["bin_w"], self.nxmx2[key],
                                       self.of_pretrigger, fs, n)
                for i, an in enumerate(names):
                    out[f"{an}_{name}_{fc}"] = r.amps[:, i]
                out[f"chi2_{name}_{fc}"] = r.chi2
                out[f"delta_t_{name}_{fc}"] = r.deltat
        elif base == "psd_amp":
            ind, names = self.psd[key]
            vals = psdfeatures.psd_amp_half(vh[spec.chan_idx], fs, n, ind)
            for i, rn in enumerate(names):
                out[f"{name}_{rn}_{fc}"] = vals[:, i]
        elif base in ("psd_peaks", "phase"):
            bands, names, npeaks, dist = self.psd[key]
            for band, rn in zip(bands, names):
                if base == "psd_peaks":
                    fpk, apk, dc = psdfeatures.psd_peaks_half(
                        vh[spec.chan_idx], fs, n, band, npeaks, dist)
                    for i in range(npeaks):
                        out[f"{name}_{rn}_amp_{i + 1}_{fc}"] = apk[:, i]
                        out[f"{name}_{rn}_freq_{i + 1}_{fc}"] = fpk[:, i]
                    out[f"{name}_dc_amp_{fc}"] = dc
                else:
                    fpk, ppk = psdfeatures.phase_at_peaks_half(
                        vh[spec.chan_idx], fs, n, band, npeaks, dist,
                        pretrigger=self.pretrigger,
                        threshold_factor=float(kw.get("threshold_factor",
                                                      0.0)))
                    for i in range(npeaks):
                        out[f"{name}_{rn}_phase_{i + 1}_{fc}"] = ppk[:, i]
                        out[f"{name}_{rn}_freq_{i + 1}_{fc}"] = fpk[:, i]
        elif base == "rftau":
            r = pulsefit.rftau(chan[spec.chan_idx], fs,
                               rtau0=float(kw.get("rtau") or 30.0),
                               ftau0=float(kw.get("ftau") or 100.0),
                               t0_index=kw.get("t0"),
                               spectrum=vh[spec.chan_idx])
            out[f"risetime_{name}_{fc}"] = r.risetime
            out[f"falltime_{name}_{fc}"] = r.falltime
            out[f"amplitud_{name}_{fc}"] = r.amplitude
            out[f"chisq_{name}_{fc}"] = r.chisq
        else:
            tr = chan[spec.chan_idx]
            lo, hi = spec.window
            if base == "baseline":
                v = tracestats.baseline(tr, lo, hi)
            elif base == "integral":
                v = tracestats.integral(tr, fs, lo, hi)
            elif base == "maximum":
                v = tracestats.maximum(tr, lo, hi)
            elif base == "minimum":
                v = tracestats.minimum(tr, lo, hi)
            else:
                v = tracestats.energyabsorbed(tr, fs, kw["vb"], kw["i0"],
                                              kw["rl"], lo, hi)
            out[f"{name}_{fc}"] = v
        return out
