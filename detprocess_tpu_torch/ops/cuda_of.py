"""Fused rFFT + no-delay optimal-filter fit: the hand-written CUDA kernel
and its plain PyTorch twin.

Port of the TPU kernel ``detprocess_tpu/ops/pallas_of.py::FusedNodelayOF``.
Per trace and filter slot s it computes

    q_s    = Σ_k w_k · Re(φ_{s,k} X_k)
    χ²₀,s  = Σ_k w_k · d_{s,k} · |X_k|²
    amp_s  = q_s / norm_s,      χ²_s = χ²₀,s − q_s² / norm_s

over the natural half spectrum X = rfft(trace) with the half-spectrum bin
weights w = (1, 2, …, 2, 1). The kernel (``csrc/fused_nodelay_of.cu``)
reads each trace once, keeps its spectrum in shared memory and writes
only the ``[B, S]`` sums, in float64, for any number of slots S. It reads
the bank as two rows folded with the bin weights when the module is
built, the buffers ``phi_w`` = w·φ and ``dinv_w`` = w·d (exact: w is 1
or 2), which only the kernel uses. On a CPU tensor the module runs
:meth:`FusedNodelayOF.plain` (``torch.fft.rfft`` followed by the same
sums); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
from torch import nn

from detprocess_tpu_torch.ops import _kernels, cuda_fft
from detprocess_tpu_torch.utils.logging import trace_span


class FusedNodelayOF(nn.Module):
    """No-delay OF amplitude and χ² for S ≥ 1 bank slots.

    Buffers: ``phi_h`` [S, N/2+1] complex, ``denom_inv_h`` [S, N/2+1],
    ``bin_w`` [N/2+1], ``norm`` [S] — the half-spectrum bank of
    :func:`detprocess_tpu_torch.ops.filterbank.bank_to_torch` — and the
    kernel's folded rows ``phi_w`` = ``bin_w``·``phi_h``, ``dinv_w`` =
    ``bin_w``·``denom_inv_h``.

    >>> fused = FusedNodelayOF.from_bank(bank)
    >>> amp, chi2 = fused(traces)            # [B, N] -> [B, S] each
    """

    def __init__(self, phi_h: torch.Tensor, denom_inv_h: torch.Tensor,
                 bin_w: torch.Tensor, norm: torch.Tensor):
        super().__init__()
        if phi_h.ndim != 2 or denom_inv_h.shape != phi_h.shape:
            raise ValueError(f"phi_h {tuple(phi_h.shape)} and denom_inv_h "
                             f"{tuple(denom_inv_h.shape)} must both be "
                             "[S, N/2+1]")
        if bin_w.shape != phi_h.shape[-1:] or norm.shape != phi_h.shape[:1]:
            raise ValueError("bin_w must be [N/2+1] and norm [S]")
        self.register_buffer("phi_h", phi_h)
        self.register_buffer("denom_inv_h", denom_inv_h)
        self.register_buffer("bin_w", bin_w)
        self.register_buffer("norm", norm)
        # derived from the rows above, so kept out of the state dict
        self.register_buffer("phi_w", (phi_h * bin_w).contiguous(),
                             persistent=False)
        self.register_buffer("dinv_w", (denom_inv_h * bin_w).contiguous(),
                             persistent=False)

    @classmethod
    def from_bank(cls, bank: dict, slots=None) -> "FusedNodelayOF":
        """Build from a :func:`bank_to_torch` dict, optionally keeping only
        the bank slots listed in ``slots``."""
        sel = slice(None) if slots is None else list(slots)
        return cls(bank["phi_h"][sel], bank["denom_inv_h"][sel],
                   bank["bin_w"], bank["norm"][sel])

    @property
    def nslots(self) -> int:
        return self.phi_h.shape[0]

    def forward(self, traces: torch.Tensor):
        """``traces`` [B, N] → (amp, χ²), each [B, S]."""
        if traces.device.type == "cuda":
            return self.kernel(traces)
        if traces.device.type == "cpu":
            return self.plain(traces)
        raise ValueError(f"FusedNodelayOF: unsupported device "
                         f"{traces.device}")

    def plain(self, traces: torch.Tensor):
        """Plain twin: ``torch.fft.rfft`` then the weighted sums."""
        vr = torch.fft.rfft(traces, dim=-1)[..., None, :]      # [B, 1, nh]
        q = torch.sum((self.phi_h * vr).real * self.bin_w, dim=-1)
        p2 = vr.real ** 2 + vr.imag ** 2
        c0 = torch.sum(p2 * self.denom_inv_h * self.bin_w, dim=-1)
        return q / self.norm, c0 - q * q / self.norm

    def kernel(self, traces: torch.Tensor):
        """The hand-written CUDA kernel (float32 traces on the GPU), its
        launch a profiler span ``of.nodelay.fused``."""
        with trace_span("of.nodelay.fused"):
            q, c0 = self._launch(traces, "dp_fused_nodelay_of_f32")
        norm = self.norm.to(torch.float64)
        amp = q / norm
        chi2 = c0 - q * q / norm
        return amp.to(traces.dtype), chi2.to(traces.dtype)

    def phase_clocks(self, traces: torch.Tensor) -> torch.Tensor:
        """One launch of the kernel's stamped instance: per trace, the SM
        clocks of its four phases (load; FFT passes; untangle and sums;
        reduction), int64 [B, 4]. A measurement, not the main path: it is
        not counted as a launch."""
        stamps = torch.zeros(traces.shape[0], 4, dtype=torch.int64,
                             device=traces.device)
        self._launch(traces, "dp_fused_nodelay_of_stamped_f32", stamps)
        return stamps

    def _launch(self, traces, entry, stamps=None):
        """Validate, launch the C entry ``entry``; return (q, χ²₀) [B, S]
        float64. Counts the launch unless it is the stamped instance."""
        n = cuda_fft.check_kernel_input(traces, "fused_nodelay_of")
        if traces.ndim != 2:
            raise ValueError("fused_nodelay_of: traces must be [B, N]")
        nh = n // 2 + 1
        if self.phi_w.shape[-1] != nh:
            raise ValueError(f"fused_nodelay_of: bank has "
                             f"{self.phi_w.shape[-1]} bins, traces of "
                             f"length {n} need {nh}")
        if (self.phi_w.dtype != torch.complex64
                or self.dinv_w.dtype != torch.float32):
            raise TypeError("fused_nodelay_of: the kernel takes a complex64/"
                            "float32 bank")
        if self.phi_w.device != traces.device:
            raise ValueError(f"fused_nodelay_of: bank on {self.phi_w.device}"
                             f", traces on {traces.device}")
        batch = traces.shape[0]
        q = torch.empty(batch, self.nslots, dtype=torch.float64,
                        device=traces.device)
        c0 = torch.empty_like(q)
        if batch:
            lib = _kernels.lib()
            tw = cuda_fft.twiddles(n, traces.device)
            stream = torch.cuda.current_stream(traces.device).cuda_stream
            args = [traces.data_ptr(), tw.data_ptr(), self.phi_w.data_ptr(),
                    self.dinv_w.data_ptr(), self.nslots, batch, n,
                    q.data_ptr(), c0.data_ptr()]
            if stamps is not None:
                args.append(stamps.data_ptr())
            code = getattr(lib, entry)(*args, traces.device.index, stream)
            _kernels.check(code, "fused_nodelay_of")
            if stamps is None:
                _kernels.count_launch("fused_nodelay_of")
        return q, c0
