"""Real FFTs on the natural half spectrum.

Counterpart of ``detprocess_tpu/ops/fft.py`` ``rfft``/``irfft``
(``[..., N] → [..., N/2 + 1]`` complex), which take any N. The TPU package
needed a four-step matmul FFT, Bluestein, permuted and packed layouts and
split re/im marshalling because of that backend's limits; none of that is
needed here.

- :func:`rfft` on a CPU tensor is ``torch.fft.rfft``. On a CUDA tensor it
  routes by the trace's dtype and length, before any launch: float32 at
  N in ``cuda_fft.SUPPORTED_N`` goes to the hand-written kernel
  (``ops/cuda_fft.py``, ``csrc/rfft.cu``); float32 at any other N goes to
  ``torch.fft.rfft`` (cuFFT), counted as the library route ``cufft_rfft``;
  float64 at any N goes to ``torch.fft.rfft``, counted as
  ``cufft_rfft_f64`` (``ops/_kernels.library_counts``); any other dtype
  is refused by name. The JAX function it ports is an XLA function, not a
  Pallas kernel, both for the lengths the kernel does not take and in
  JAX's float64 runs, so cuFFT is its port there; float32 never takes
  the float64 route, and nothing is converted.
- :func:`irfft` is ``torch.fft.irfft`` on both, as the JAX package left
  its inverse transform to XLA.
- ``fftfreq`` is ``utils/freq.fftfreq``, under its JAX path.
"""

from __future__ import annotations

import torch

from detprocess_tpu_torch.ops import _kernels, cuda_fft
from detprocess_tpu_torch.utils.freq import fftfreq  # noqa: F401
from detprocess_tpu_torch.utils.logging import trace_span


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Half spectrum of real traces over the last axis."""
    if x.device.type == "cuda":
        return rfft_cuda(x)
    if x.device.type == "cpu":
        return cuda_fft.rfft_plain(x)
    raise ValueError(f"rfft: unsupported device {x.device}")


def rfft_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA route of :func:`rfft`: float32 traces to the kernel for
    the lengths it takes, else to cuFFT; float64 traces to cuFFT; another
    dtype raises. A kernel that fails to build or launch raises. Each
    route is a profiler span (``fft.rfft.kernel``, ``fft.rfft.cufft``,
    ``fft.rfft.cufft_f64``) where the profiler records this thread, so
    that a trace carries the transform's work whatever implements it."""
    if x.dtype == torch.float64:
        _kernels.count_library_call("cufft_rfft_f64")
        with trace_span("fft.rfft.cufft_f64"):
            return torch.fft.rfft(x, dim=-1)
    if x.dtype != torch.float32:
        raise TypeError(f"rfft: float32 or float64 traces, got {x.dtype}")
    if x.shape[-1] in cuda_fft.SUPPORTED_N:
        with trace_span("fft.rfft.kernel"):
            return cuda_fft.rfft_kernel(x.contiguous())
    _kernels.count_library_call("cufft_rfft")
    with trace_span("fft.rfft.cufft"):
        return torch.fft.rfft(x, dim=-1)


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`rfft` with a length-``n`` real output."""
    return torch.fft.irfft(x, n=n, dim=-1)
