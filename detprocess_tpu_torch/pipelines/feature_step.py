"""The of1x1 feature step: one batch of traces in, one column per feature out.

Counterpart of the group function that
``detprocess_tpu/pipelines/features.py::FeatureProcessing._make_group_fn``
builds (its body ``fn``) for a processing config whose channels run
``of1x1_nodelay``, ``of1x1_unconstrained``, ``baseline`` and ``integral``.
Per batch and feature channel:

1. the compound-channel mix ``[C_c, C_r] × [B, C_r, N]`` (TF32 off);
2. the half spectrum by ``ops/fft.rfft`` (the rFFT kernel, or cuFFT for
   a length outside its domain);
3. ``of1x1_nodelay``: where the fused kernel takes the trace length
   (``cuda_fft.SUPPORTED_N``), amp and χ² from the fused rFFT + no-delay
   kernel (``ops/cuda_of.FusedNodelayOF``) and lowchi2 on the step-2
   spectrum; at any other length ``ops/of1x1.of1x1_nodelay_half`` on the
   step-2 spectrum, the JAX feature step's own route
   (pipelines/features.py:842). The route is chosen once, from ``n``;
4. ``of1x1_unconstrained``: the delay scan of ``ops/of1x1`` on the step-2
   spectrum;
5. ``baseline`` and ``integral``.

Columns carry the JAX pipeline's names: ``amp_of1x1_nodelay_<chan>``,
``chi2_…``, ``lowchi2_…``, ``t0_of1x1_unconstrained_<chan>``,
``baseline_<chan>``, ``integral_<chan>``. On CUDA tensors steps 2 and 3
launch the hand-written kernels where they take the length; on CPU
tensors they run their plain twins. Each trace is read once by each
kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from detprocess_tpu_torch import device as dev
from detprocess_tpu_torch.ops import cuda_fft, fft, of1x1, tracestats
from detprocess_tpu_torch.ops.cuda_of import FusedNodelayOF

NODELAY = "of1x1_nodelay"
UNCONSTRAINED = "of1x1_unconstrained"


class FeatureStep(nn.Module):
    """of1x1 nodelay + unconstrained delay scan + baseline + integral.

    Parameters
    ----------
    bank : dict of half-spectrum bank tensors
        (``ops/filterbank.bank_to_torch`` or ``bank_from_jax``), S slots.
    channels : feature-channel names, one per row of ``mix``.
    fs, pretrigger, n : sample rate, OF pretrigger (samples), trace length.
    mix : [C_c, C_r] compound-channel matrix (default: identity over the
        channels).
    slots : bank slot of each channel (default: channel i uses slot i).
    lowchi2_fcutoff : low-frequency χ² cutoff in Hz (the config default).
    """

    def __init__(self, bank: dict, channels: Sequence[str], fs: float,
                 pretrigger: int, n: int, mix=None,
                 slots: Sequence[int] | None = None,
                 lowchi2_fcutoff: float = 10000.0):
        super().__init__()
        self.channels = list(channels)
        self.fs = float(fs)
        self.pretrigger = int(pretrigger)
        self.n = int(n)
        self.slots = (list(range(len(self.channels))) if slots is None
                      else [int(s) for s in slots])
        if len(self.slots) != len(self.channels):
            raise ValueError("one bank slot per channel")
        nh = self.n // 2 + 1
        if bank["phi_h"].shape[-1] != nh:
            raise ValueError(f"bank has {bank['phi_h'].shape[-1]} bins, "
                             f"n={self.n} needs {nh}")
        dtype = bank["norm"].dtype
        device = bank["norm"].device
        if device.type == "cuda":
            dev.set_full_f32()          # the mix runs in full float32
        if mix is None:
            mix = np.eye(len(self.channels))
        mix = torch.as_tensor(np.asarray(mix), dtype=dtype, device=device)
        if mix.ndim != 2 or mix.shape[0] != len(self.channels):
            raise ValueError(f"mix must be [{len(self.channels)}, C_r], got "
                             f"{tuple(mix.shape)}")
        self.register_buffer("mix", mix)
        for key in ("phi_h", "s_fft_h", "denom_inv_h", "bin_w", "norm"):
            self.register_buffer(key, bank[key])
        lmask = of1x1.lowfreq_mask_half(self.n, self.fs, lowchi2_fcutoff)
        self.register_buffer("low_mask_h",
                             torch.as_tensor(lmask, device=device))
        # the no-delay route, from the length alone: the fused kernel
        # where it takes n, else the half-spectrum fit (nodelay is None)
        self.nodelay = (nn.ModuleList(
            FusedNodelayOF.from_bank(bank, slots=[s]) for s in self.slots)
            if self.n in cuda_fft.SUPPORTED_N else None)

    def forward(self, raw_traces: torch.Tensor) -> dict:
        """``raw_traces`` [B, C_r, N] → dict of [B] feature columns."""
        traces = torch.einsum("cr,brn->bcn",
                              self.mix.to(raw_traces.dtype), raw_traces)
        out = {}
        for ci, chan in enumerate(self.channels):
            s = self.slots[ci]
            sl = slice(s, s + 1)
            phi, s_fft = self.phi_h[sl], self.s_fft_h[sl]
            dinv, norm = self.denom_inv_h[sl], self.norm[sl]
            tr = traces[:, ci, :].contiguous()
            vr = fft.rfft(tr)[:, None, :]                      # [B, 1, nh]

            if self.nodelay is None:
                r = of1x1.of1x1_nodelay_half(vr, phi, norm, dinv, s_fft,
                                             self.bin_w, self.low_mask_h,
                                             self.n)
                amp, chi2, low = r.amp, r.chi2, r.lowchi2
            else:
                amp, chi2 = self.nodelay[ci](tr)               # [B, 1]
                low = of1x1._residual_chi2_half(
                    vr, amp, torch.zeros_like(amp), s_fft, dinv, self.bin_w,
                    self.low_mask_h, self.n)
            out[f"amp_{NODELAY}_{chan}"] = amp[:, 0]
            out[f"chi2_{NODELAY}_{chan}"] = chi2[:, 0]
            out[f"lowchi2_{NODELAY}_{chan}"] = low[:, 0]

            r = of1x1.of1x1_withdelay_half(
                vr, phi, norm, dinv, s_fft, self.bin_w, self.pretrigger,
                self.fs, low_mask_h=self.low_mask_h, n=self.n)
            out[f"amp_{UNCONSTRAINED}_{chan}"] = r.amp[:, 0]
            out[f"t0_{UNCONSTRAINED}_{chan}"] = r.t0[:, 0]
            out[f"chi2_{UNCONSTRAINED}_{chan}"] = r.chi2[:, 0]
            out[f"lowchi2_{UNCONSTRAINED}_{chan}"] = r.lowchi2[:, 0]

            out[f"baseline_{chan}"] = tracestats.baseline(tr)
            out[f"integral_{chan}"] = tracestats.integral(tr, self.fs)
        return out
