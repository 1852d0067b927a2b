"""Real FFTs on the natural half spectrum.

Counterpart of ``detprocess_tpu/ops/fft.py`` ``rfft``/``irfft``
(``[..., N] → [..., N/2 + 1]`` complex). The TPU package needed a
four-step matmul FFT, Bluestein, permuted and packed layouts and split
re/im marshalling because of that backend's limits; none of that is
needed here.

- :func:`rfft` on a CUDA tensor launches the hand-written kernel
  (``ops/cuda_fft.py``, ``csrc/rfft.cu``), on a CPU tensor it is
  ``torch.fft.rfft``.
- :func:`irfft` is ``torch.fft.irfft`` on both, as the JAX package left
  its inverse transform to XLA.
"""

from __future__ import annotations

import torch

from detprocess_tpu_torch.ops import cuda_fft


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Half spectrum of real traces over the last axis."""
    if x.device.type == "cuda":
        return cuda_fft.rfft_kernel(x)
    if x.device.type == "cpu":
        return cuda_fft.rfft_plain(x)
    raise ValueError(f"rfft: unsupported device {x.device}")


def irfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`rfft` with a length-``n`` real output."""
    return torch.fft.irfft(x, n=n, dim=-1)
