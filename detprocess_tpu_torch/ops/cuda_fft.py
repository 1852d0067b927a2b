"""Batched real FFT of long traces: the hand-written CUDA kernel and its
plain PyTorch twin.

Port of the TPU kernel ``detprocess_tpu/ops/pallas_fft.py::fft_pallas``
(a four-step DFT-by-matmul that emitted the full spectrum in
digit-reversed order). The kernel (``csrc/rfft.cu``) keeps one trace per
thread block in shared memory and writes the natural-order half spectrum
``[B, N/2 + 1]`` straight into a complex64 tensor.

:func:`rfft_kernel` takes CUDA tensors only and raises on anything the
kernel does not take; it never falls back to :func:`rfft_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from detprocess_tpu_torch.ops import _kernels

SUPPORTED_N = tuple(2 ** p for p in range(8, 16))   # 256 … 32768


def rfft_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: ``torch.fft.rfft`` over the last axis."""
    return torch.fft.rfft(x, dim=-1)


@functools.lru_cache(maxsize=32)
def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``W_N^k = exp(−2πik/N)`` for k < N/2, computed in float64 and cast
    to complex64, on ``device``."""
    k = np.arange(n // 2)
    tw = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def check_kernel_input(x: torch.Tensor, name: str) -> int:
    """Validate a trace batch for the shared-memory FFT kernels; return N."""
    n = x.shape[-1]
    if n not in SUPPORTED_N:
        raise ValueError(f"{name}: trace length {n} is not a power of two "
                         f"in [{SUPPORTED_N[0]}, {SUPPORTED_N[-1]}]")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 traces, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: traces must be contiguous (call "
                         ".contiguous() on views)")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: trace storage must be 16-byte aligned")
    return n


def rfft_kernel(x: torch.Tensor) -> torch.Tensor:
    """Half spectrum ``[..., N/2 + 1]`` complex64 of float32 traces
    ``[..., N]`` on the GPU, by the hand-written kernel."""
    n = check_kernel_input(x, "rfft")
    batch = x.numel() // n
    out = torch.empty(*x.shape[:-1], n // 2 + 1, dtype=torch.complex64,
                      device=x.device)
    if batch == 0:
        return out
    tw = twiddles(n, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _kernels.lib().dp_rfft_f32(x.data_ptr(), out.data_ptr(),
                                      tw.data_ptr(), batch, n,
                                      x.device.index, stream)
    _kernels.check(code, "rfft")
    _kernels.count_launch("rfft")
    return out
