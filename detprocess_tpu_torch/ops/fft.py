"""Real FFTs on the natural half spectrum.

Counterpart of ``detprocess_tpu/ops/fft.py`` ``rfft``/``irfft``
(``[..., N] → [..., N/2 + 1]`` complex), which take any N. The TPU package
needed a four-step matmul FFT, Bluestein, permuted and packed layouts and
split re/im marshalling because of that backend's limits; none of that is
needed here.

- :func:`rfft` on a CPU tensor is ``torch.fft.rfft``. On a CUDA tensor it
  routes by the trace length alone, before any launch: N in
  ``cuda_fft.SUPPORTED_N`` goes to the hand-written kernel
  (``ops/cuda_fft.py``, ``csrc/rfft.cu``), which raises on a type it
  does not take; any other N goes to ``torch.fft.rfft`` (cuFFT), counted
  as the library route
  ``cufft_rfft`` (``ops/_kernels.library_counts``). The JAX function it
  ports is an XLA function, not a Pallas kernel, so cuFFT is its port for
  the lengths the kernel does not take.
- :func:`irfft` is ``torch.fft.irfft`` on both, as the JAX package left
  its inverse transform to XLA.
- ``fftfreq`` is ``utils/freq.fftfreq``, under its JAX path.
"""

from __future__ import annotations

import torch

from detprocess_tpu_torch.ops import _kernels, cuda_fft
from detprocess_tpu_torch.utils.freq import fftfreq  # noqa: F401


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Half spectrum of real traces over the last axis."""
    if x.device.type == "cuda":
        return rfft_cuda(x)
    if x.device.type == "cpu":
        return cuda_fft.rfft_plain(x)
    raise ValueError(f"rfft: unsupported device {x.device}")


def rfft_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA route of :func:`rfft`: the kernel for the lengths it takes,
    else cuFFT. A kernel that is given another type than float32, or
    fails to build or launch, raises."""
    if x.shape[-1] in cuda_fft.SUPPORTED_N:
        return cuda_fft.rfft_kernel(x.contiguous())
    _kernels.count_library_call("cufft_rfft")
    return torch.fft.rfft(x, dim=-1)


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`rfft` with a length-``n`` real output."""
    return torch.fft.irfft(x, n=n, dim=-1)
