"""Device choice, the float32 precision policy, and a CUDA-event timer.

The port runs its physics in full float32 on the GPU: TF32 rounds
matmul and convolution inputs to ~3 decimal digits, which the optimal
filter's amplitudes cannot afford (the JAX package's policy of full f32
precision on physics paths, docs/DESIGN.md §8). :func:`require_cuda`
and :func:`set_full_f32` turn TF32 off for both matmuls and cuDNN.

Nothing here falls back to the CPU: a measurement or run that needs the
GPU calls :func:`require_cuda`, which raises when there is none.
"""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_cuda(index: int = 0) -> torch.device:
    """Return ``cuda:<index>`` with the float32 policy set; raise when
    PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False (this path runs only on the GPU)")
    set_full_f32()
    return torch.device("cuda", index)


class CudaTimer:
    """Device time of the enclosed work, from CUDA events on the current
    stream.

    >>> with CudaTimer() as t:
    ...     step()
    >>> t.ms                      # synchronises on the end event
    """

    def __init__(self, device=None):
        self.device = device
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self) -> "CudaTimer":
        self._start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> None:
        self._end.record(torch.cuda.current_stream(self.device))

    @property
    def ms(self) -> float:
        self._end.synchronize()
        return self._start.elapsed_time(self._end)
