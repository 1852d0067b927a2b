"""ADC codes to amps on the device.

Counterpart of ``detprocess_tpu/ops/saltinject.py::adc_convert``: raw
traces [B, C, N] in their stored dtype (int16 codes for pytesdaq data)
times the per-event, per-channel factors ``conv`` [B, C]
(cal / close_loop_norm), in float32 unless asked otherwise. Uploading the
codes as stored and converting here halves the host-to-device bytes of
float32.
"""

from __future__ import annotations

import torch


def adc_convert(raw: torch.Tensor, conv: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``raw.to(dtype) * conv[:, :, None]``."""
    return raw.to(dtype) * conv.to(dtype)[:, :, None]
