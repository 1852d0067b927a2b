"""One trace group of the feature plan as a module: a batch of raw
traces in, the group's feature columns out.

Counterpart of the function that
``detprocess_tpu/pipelines/features.py::_make_group_fn`` (:627-1107)
builds, on the natural half spectrum only (the TPU package's packed and
permuted layouts are not ported). Per batch:

1. the compound-channel mix ``[C_c, C_r] × [B, C_r, N]`` (TF32 off) of
   the group's window cut of the raw traces;
2. one ``ops/fft.rfft`` per spectral compound channel (a channel that an
   of1x1 fit reads): the rFFT kernel, or cuFFT for a length outside its
   domain;
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
   - ``baseline``, ``integral``, ``maximum``, ``minimum`` and
     ``energyabsorbed`` over their windows.

Columns carry the JAX names ``{feature}_{algorithm}_{feature_channel}``.
On CUDA tensors step 2 and the fused fit launch the hand-written kernels;
on CPU tensors they run their plain twins.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import cuda_fft, fft, filterbank, of1x1
from detprocess_tpu_torch.ops import tracestats
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF
from detprocess_tpu_torch.pipelines import feature_plan as fplan


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
        of_specs = [s for s in self.specs
                    if s.base in fplan.OF_1X1_ALGORITHMS]
        # one transform per compound channel that an of1x1 fit reads
        self.spectral = sorted({s.chan_idx for s in of_specs})
        self.bank = None
        self.low = {}
        self.masks = {}
        self.nodelay = nn.ModuleDict()
        if of_specs:
            bank = filterbank.bank_to_torch(group.bank_1x1, device, dtype)
            self.bank = bank
            for s in of_specs:
                fc = float(s.kwargs.get("lowchi2_fcutoff", 10000))
                if fc not in self.low:
                    self.low[fc] = torch.as_tensor(
                        of1x1.lowfreq_mask_half(n, self.fs, fc),
                        device=device)
                if s.base == "of1x1_constrained":
                    self.masks[s.algorithm, s.channel] = torch.as_tensor(
                        fplan.window_mask(s, n, self.pretrigger, self.fs),
                        device=device)
                if (s.base == "of1x1_nodelay" and n in cuda_fft.SUPPORTED_N
                        and str(s.slot) not in self.nodelay):
                    self.nodelay[str(s.slot)] = FusedNodelayOF.from_bank(
                        bank, slots=[s.slot])

    def forward(self, raw: torch.Tensor) -> dict:
        """``raw`` [B, C_r, N_raw] → dict of [B] feature columns."""
        if self.cut is not None:
            raw = raw[..., self.cut:self.cut + self.n]
        traces = torch.einsum("cr,brn->bcn", self.mix.to(raw.dtype), raw)
        chan = {ci: traces[:, ci, :] for ci in {s.chan_idx
                                                 for s in self.specs}}
        chan.update({ci: chan[ci].contiguous() for ci in self.spectral})
        vhalf = {ci: fft.rfft(chan[ci])[:, None, :] for ci in self.spectral}
        out = {}
        fs, n = self.fs, self.n
        for spec in self.specs:
            name, fc, kw = spec.algorithm, spec.feature_channel, spec.kwargs
            tr = chan[spec.chan_idx]
            if spec.base in fplan.OF_1X1_ALGORITHMS:
                b = self.bank
                sl = slice(spec.slot, spec.slot + 1)
                phi, s_fft = b["phi_h"][sl], b["s_fft_h"][sl]
                dinv, norm = b["denom_inv_h"][sl], b["norm"][sl]
                lmask = self.low[float(kw.get("lowchi2_fcutoff", 10000))]
                vr = vhalf[spec.chan_idx]
                if spec.base == "of1x1_nodelay":
                    fused = self.nodelay[str(spec.slot)] \
                        if str(spec.slot) in self.nodelay else None
                    if fused is None:
                        r = of1x1.of1x1_nodelay_half(
                            vr, phi, norm, dinv, s_fft, b["bin_w"], lmask, n)
                        amp, chi2, low = r.amp, r.chi2, r.lowchi2
                    else:
                        amp, chi2 = fused(tr)
                        low = of1x1._residual_chi2_half(
                            vr, amp, torch.zeros_like(amp), s_fft, dinv,
                            b["bin_w"], lmask, n)
                    out[f"amp_{name}_{fc}"] = amp[:, 0]
                    out[f"chi2_{name}_{fc}"] = chi2[:, 0]
                    out[f"lowchi2_{name}_{fc}"] = low[:, 0]
                    continue
                constrained = spec.base == "of1x1_constrained"
                r = of1x1.of1x1_withdelay_half(
                    vr, phi, norm, dinv, s_fft, b["bin_w"],
                    self.of_pretrigger, fs,
                    window_mask=(self.masks[name, spec.channel]
                                 if constrained else None),
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
            else:
                lo, hi = spec.window
                if spec.base == "baseline":
                    v = tracestats.baseline(tr, lo, hi)
                elif spec.base == "integral":
                    v = tracestats.integral(tr, fs, lo, hi)
                elif spec.base == "maximum":
                    v = tracestats.maximum(tr, lo, hi)
                elif spec.base == "minimum":
                    v = tracestats.minimum(tr, lo, hi)
                else:
                    v = tracestats.energyabsorbed(tr, fs, kw["vb"], kw["i0"],
                                                  kw["rl"], lo, hi)
                out[f"{name}_{fc}"] = v
        return out
